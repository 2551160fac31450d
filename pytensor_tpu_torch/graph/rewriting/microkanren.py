"""Minimal miniKanren core for relational graph rewriting.

Counterpart of ``pytensor_tpu/graph/rewriting/microkanren.py``, whole.
PyTensor's kanren bridge (graph/rewriting/kanren.py:243) depends on the
external ``miniKanren`` package, which neither machine ships, so the
port, as the JAX package, vendors the ~100-line microKanren core — logic
variables, unification over nested tuples (graph terms), goal
combinators, and ``run``.  Only what KanrenRelationSub needs.

Terms: nested tuples of (Op, *arg_terms), graph Variables/Constants as
ground atoms, and LVar logic variables.  Ops unify via their __props__
equality; Constants via dtype + value equality.
"""

from __future__ import annotations

import itertools

import numpy as np


class LVar:
    """A logic variable (fresh, identity-based)."""

    __slots__ = ("name",)
    _counter = itertools.count()

    def __init__(self, name=None):
        self.name = name or f"_{next(LVar._counter)}"

    def __repr__(self):
        return f"~{self.name}"


def var(name=None):
    return LVar(name)


def walk(t, s):
    while isinstance(t, LVar):
        nxt = s.get(t, t)
        if nxt is t:
            break
        t = nxt
    return t


def _atoms_equal(u, v):
    from pytensor_tpu_torch.graph.basic import Constant

    if u is v:
        return True
    if isinstance(u, Constant) and isinstance(v, Constant):
        if u.type != v.type:
            return False
        try:
            return bool(np.array_equal(np.asarray(u.data),
                                       np.asarray(v.data)))
        except Exception:
            return False
    try:
        return bool(u == v)
    except Exception:
        return False


def unify(u, v, s):
    """Extend substitution s so u == v, or None."""
    u = walk(u, s)
    v = walk(v, s)
    if isinstance(u, LVar) and isinstance(v, LVar) and u is v:
        return s
    if isinstance(u, LVar):
        return {**s, u: v}
    if isinstance(v, LVar):
        return {**s, v: u}
    if isinstance(u, tuple) and isinstance(v, tuple):
        if len(u) != len(v):
            return None
        for a, b in zip(u, v):
            s = unify(a, b, s)
            if s is None:
                return None
        return s
    if isinstance(u, tuple) or isinstance(v, tuple):
        return None
    return s if _atoms_equal(u, v) else None


# --- goals: substitution -> iterator of substitutions ---

def eq(u, v):
    def goal(s):
        r = unify(u, v, s)
        if r is not None:
            yield r

    return goal


def succeed(s):
    yield s


def fail(s):
    return iter(())


def lall(*goals):
    """Conjunction."""

    def goal(s):
        streams = [iter((s,))]
        for g in goals:
            streams = [g(sub) for st in streams for sub in st]
            # materialize breadth-wise to keep laziness simple
            streams = [iter(list(st)) for st in streams]
        for st in streams:
            yield from st

    return goal


def conde(*clauses):
    """Disjunction of conjunctions: conde([g1, g2], [g3], ...)."""

    def goal(s):
        for clause in clauses:
            yield from lall(*clause)(s)

    return goal


def reify(t, s):
    t = walk(t, s)
    if isinstance(t, tuple):
        return tuple(reify(x, s) for x in t)
    return t


def run(n, q, goal):
    """First n reified values of q satisfying goal (n=0: all)."""
    out = []
    for s in goal({}):
        out.append(reify(q, s))
        if n and len(out) >= n:
            break
    return out

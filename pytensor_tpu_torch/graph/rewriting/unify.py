"""Structural pattern matching for rewrites.

Counterpart of ``pytensor_tpu/graph/rewriting/unify.py`` (PyTensor's
graph/rewriting/unify.py OpPattern:70, match_pattern:345, commutative
backtracking :418), whole: declarative patterns
over (op, args) trees with variable binding, constraints, varargs and
commutative-op backtracking, through ``match_pattern``.
"""

from __future__ import annotations

from typing import Any, Callable

import numpy as np

from pytensor_tpu_torch.graph.basic import Constant, Variable


class PatternVar:
    """Named binding slot in a pattern."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"?{self.name}"


class ConstrainedVar(PatternVar):
    """Binding slot with a predicate on the matched variable."""

    def __init__(self, name: str, constraint: Callable[[Variable], bool]):
        super().__init__(name)
        self.constraint = constraint


class Asterisk:
    """Varargs slot: matches the remaining inputs as a list."""

    def __init__(self, name: str):
        self.name = name

    def __repr__(self):
        return f"*{self.name}"


class OpPattern:
    """Match an op by type and (optionally) parameter values."""

    def __init__(self, op_type, **param_constraints):
        self.op_type = op_type
        self.param_constraints = param_constraints

    def matches(self, op) -> bool:
        if isinstance(self.op_type, type):
            if not isinstance(op, self.op_type):
                return False
        elif op != self.op_type:
            return False
        for k, v in self.param_constraints.items():
            actual = getattr(op, k, None)
            if callable(v) and not isinstance(v, type):
                if not v(actual):
                    return False
            elif actual != v:
                return False
        return True


def _op_matches(node_op, pat_op) -> bool:
    if isinstance(pat_op, OpPattern):
        return pat_op.matches(node_op)
    if isinstance(pat_op, type):
        return isinstance(node_op, pat_op)
    return node_op == pat_op


def match_pattern(var: Variable, pattern, bindings: dict | None = None):
    """Match ``pattern`` against the graph rooted at ``var``.

    Returns the bindings dict on success, None on failure.  Patterns:
    tuple ``(op, arg_patterns...)``, str / PatternVar (bind), Asterisk
    (varargs tail), Constant values, raw numbers.  Commutative ops
    (scalar_op.commutative) match args under permutation with
    backtracking.
    """
    if bindings is None:
        bindings = {}
    res = _match(var, pattern, bindings)
    return bindings if res else None


def _match(var, pattern, bindings) -> bool:
    if isinstance(pattern, str):
        pattern = PatternVar(pattern)
    if isinstance(pattern, ConstrainedVar):
        if not pattern.constraint(var):
            return False
        return _bind(pattern.name, var, bindings)
    if isinstance(pattern, PatternVar):
        return _bind(pattern.name, var, bindings)
    if isinstance(pattern, (list, tuple)):
        op_pat, *arg_pats = pattern
        if var.owner is None:
            return False
        if not _op_matches(var.owner.op, op_pat):
            return False
        args = var.owner.inputs
        commutative = getattr(getattr(var.owner.op, "scalar_op", None),
                              "commutative", False)
        return _match_args(args, arg_pats, bindings, commutative)
    if isinstance(pattern, Variable):
        return isinstance(var, Constant) and isinstance(pattern, Constant) \
            and pattern.equals(var)
    # raw value: match a constant elementwise
    if isinstance(var, Constant):
        try:
            return bool(np.all(np.asarray(var.data) == pattern))
        except Exception:
            return False
    return False


def _match_args(args, arg_pats, bindings, commutative) -> bool:
    has_star = arg_pats and isinstance(arg_pats[-1], Asterisk)
    fixed = arg_pats[:-1] if has_star else arg_pats
    if has_star:
        if len(args) < len(fixed):
            return False
    elif len(args) != len(fixed):
        return False
    if not commutative or len(fixed) <= 1:
        for a, p in zip(args, fixed):
            if not _match(a, p, bindings):
                return False
        if has_star:
            return _bind(arg_pats[-1].name, list(args[len(fixed):]), bindings)
        return True
    # commutative backtracking over permutations of the fixed args
    from itertools import permutations

    base = dict(bindings)
    n = len(fixed)
    for perm in permutations(range(len(args)), n):
        if has_star is False and len(args) != n:
            return False
        trial = dict(base)
        ok = True
        for idx, p in zip(perm, fixed):
            if not _match(args[idx], p, trial):
                ok = False
                break
        if ok:
            rest = [a for k, a in enumerate(args) if k not in perm]
            if has_star and not _bind(arg_pats[-1].name, rest, trial):
                continue
            if not has_star and rest:
                continue
            bindings.clear()
            bindings.update(trial)
            return True
    return False


def _bind(name, value, bindings) -> bool:
    if name in bindings:
        prev = bindings[name]
        if isinstance(prev, list) or isinstance(value, list):
            return prev == value
        return prev is value
    bindings[name] = value
    return True

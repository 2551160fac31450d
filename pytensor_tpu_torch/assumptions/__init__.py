"""Assumptions engine: a static-analysis fact lattice over graphs.

Counterpart of ``pytensor_tpu/assumptions/__init__.py`` (PyTensor's
assumptions/: FactState core.py:13, AssumptionFeature:178,
register_assumption:127, and the per-op rule modules): facts like
symmetric / positive-definite / triangular propagate through op-specific
inference rules and feed rewrites (generic solve -> triangular/cholesky
solve, an assert whose condition is proven dropped).  One of the JAX
package's rewrites here waits for its op: ``local_eig_to_eigh`` for
``Eig`` (ROADMAP.md Queue 1 item 17).

Layout: this module owns the fact vocabulary, the rule registry, the
recursive ``holds`` query and constant evaluation; the per-op rules
live in ``assumptions/rules/{elemwise,dot,dimshuffle,structural,linalg,
blockwise}.py`` (mirroring the reference's module-per-op layout); the
caching graph feature is ``assumptions/feature.py``.

Rule protocol: ``fn(node, fact, holds_fn) -> FactState`` for the
node's first output; rules for multi-output ops accept an extra
``out_index`` keyword and are called with the queried output's index.
"""

from __future__ import annotations

import enum
from typing import Callable

from pytensor_tpu_torch.graph.basic import Constant, Variable


class FactState(enum.IntFlag):
    UNKNOWN = 0
    TRUE = 1
    FALSE = 2


# the fact vocabulary (reference per-op rule modules cover the same set)
FACTS = (
    "symmetric",
    "positive_definite",
    "lower_triangular",
    "upper_triangular",
    "diagonal",
    "unit_diagonal",
    "positive",
    "non_negative",
    "orthogonal",
    "permutation",
    "zero",
    # index vocabulary: the entries name distinct positions (reference
    # unique_indices assumption; gates inc<->set scatter rewrites)
    "unique_indices",
)

# fact -> facts that imply it (a DAG; checked when direct inference is
# UNKNOWN).  Reference per-op modules encode these transitively inside
# each rule; a single implication table keeps ours in one place.
_IMPLIED_BY = {
    "orthogonal": ("permutation",),
    "symmetric": ("diagonal",),
    "lower_triangular": ("diagonal",),
    "upper_triangular": ("diagonal",),
    "non_negative": ("positive", "permutation"),
}

_rules: dict = {}


def register_assumption(op_type, fn: Callable):
    """fn(node, fact, holds) -> FactState for node.outputs[0] (rules
    taking ``out_index=`` serve multi-output ops)."""
    _rules.setdefault(op_type, []).append(fn)
    return fn


def assume(var: Variable, *facts: str) -> Variable:
    """Assert facts about a variable (user-provided knowledge)."""
    tagged = getattr(var.tag, "assumptions", None)
    if tagged is None:
        var.tag.assumptions = set()
    for f in facts:
        if f not in FACTS:
            raise ValueError(f"unknown fact {f!r}; choices: {FACTS}")
        var.tag.assumptions.add(f)
    return var


def holds(var: Variable, fact: str, depth: int = 16) -> FactState:
    """Infer whether ``fact`` holds for ``var`` (TRUE / FALSE / UNKNOWN)."""
    res = _holds_direct(var, fact, depth)
    if res != FactState.UNKNOWN:
        return res
    for implicant in _IMPLIED_BY.get(fact, ()):
        if _holds_direct(var, implicant, depth) == FactState.TRUE:
            return FactState.TRUE
    return FactState.UNKNOWN


def _holds_direct(var: Variable, fact: str, depth: int = 16) -> FactState:
    if fact in getattr(var.tag, "assumptions", ()):
        return FactState.TRUE
    if depth <= 0 or var.owner is None:
        if isinstance(var, Constant):
            return _constant_fact(var, fact)
        return FactState.UNKNOWN
    node = var.owner
    out_index = 0
    if len(node.outputs) > 1:
        try:
            out_index = node.outputs.index(var)
        except ValueError:
            out_index = 0
    sub = lambda v, f: holds(v, f, depth - 1)  # noqa: E731
    for op_type, fns in _rules.items():
        if isinstance(node.op, op_type):
            for fn in fns:
                try:
                    res = fn(node, fact, sub, out_index=out_index)
                except TypeError:
                    if out_index != 0:
                        continue  # single-output rule, other output asked
                    res = fn(node, fact, sub)
                if res != FactState.UNKNOWN:
                    return res
    return FactState.UNKNOWN


def holds_in(fgraph, var: Variable, fact: str) -> FactState:
    """``holds`` through the fgraph's AssumptionFeature cache when one
    is attached (rewrites should prefer this entry point)."""
    feat = getattr(fgraph, "assumption_feature", None) if fgraph is not None \
        else None
    if feat is not None:
        return feat.holds(var, fact)
    return holds(var, fact)


def _constant_fact(var, fact):
    import numpy as np

    try:
        data = np.asarray(var.data)
    except Exception:
        return FactState.UNKNOWN
    if data.ndim == 2 and data.shape[0] == data.shape[1]:
        if fact == "symmetric":
            return FactState.TRUE if np.allclose(data, data.T) else FactState.FALSE
        if fact == "lower_triangular":
            return FactState.TRUE if np.allclose(data, np.tril(data)) else FactState.FALSE
        if fact == "upper_triangular":
            return FactState.TRUE if np.allclose(data, np.triu(data)) else FactState.FALSE
        if fact == "diagonal":
            return FactState.TRUE if np.allclose(data, np.diag(np.diag(data))) \
                else FactState.FALSE
        if fact == "permutation":
            ok = (np.isin(data, (0, 1)).all()
                  and (data.sum(axis=0) == 1).all()
                  and (data.sum(axis=1) == 1).all())
            return FactState.TRUE if ok else FactState.FALSE
    if fact == "positive":
        if data.size and (data > 0).all():
            return FactState.TRUE
        return FactState.FALSE if data.size else FactState.UNKNOWN
    if fact == "non_negative":
        if data.size and (data >= 0).all():
            return FactState.TRUE
        return FactState.FALSE if data.size else FactState.UNKNOWN
    if fact == "zero":
        return FactState.TRUE if not data.any() else FactState.FALSE
    return FactState.UNKNOWN


def gram_factor(node):
    """If node computes A @ A^T, return A; else None."""
    from pytensor_tpu_torch.tensor.elemwise import DimShuffle

    x, y = node.inputs[:2]

    def base_of_transpose(v):
        if v.owner is not None and isinstance(v.owner.op, DimShuffle):
            op = v.owner.op
            if op.is_transpose and op.shuffle == tuple(
                    reversed(range(len(op.shuffle)))):
                return v.owner.inputs[0]
        return None

    if base_of_transpose(y) is x:
        return x
    if base_of_transpose(x) is y:
        return y
    return None


# wire the per-op rule modules + the graph feature + rewrites
import pytensor_tpu_torch.assumptions.rules  # noqa: E402,F401
from pytensor_tpu_torch.assumptions.feature import AssumptionFeature  # noqa: E402,F401


def _register_rewrites():
    """Assumption-driven specializations (reference
    tensor/rewriting/assumptions.py:64 + linalg/solvers.py:703)."""
    from pytensor_tpu_torch.compile.mode import register_specialize
    from pytensor_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
    from pytensor_tpu_torch.raise_op import CheckAndRaise
    from pytensor_tpu_torch.tensor.linalg import Solve, SolveTriangular

    @node_rewriter([Solve])
    def local_solve_to_triangular(fgraph, node):
        """solve(L, b) with L known triangular -> solve_triangular."""
        A, b = node.inputs
        if node.op.assume_a != "gen":
            return False
        if holds_in(fgraph, A, "lower_triangular") == FactState.TRUE:
            res = SolveTriangular(b_ndim=node.op.b_ndim, lower=True)(A, b)
        elif holds_in(fgraph, A, "upper_triangular") == FactState.TRUE:
            res = SolveTriangular(b_ndim=node.op.b_ndim, lower=False)(A, b)
        else:
            return False
        copy_stack_trace(node.outputs[0], res)
        return [res]

    register_specialize(local_solve_to_triangular, name="local_solve_to_triangular")

    @node_rewriter([Solve])
    def local_solve_to_cholesky(fgraph, node):
        """solve(A, b) with A known positive-definite -> the Cholesky path
        (reference linalg/solvers.py:703 psd specialization)."""
        A, b = node.inputs
        if node.op.assume_a != "gen":
            return False
        if holds_in(fgraph, A, "positive_definite") != FactState.TRUE:
            return False
        res = Solve(assume_a="pos", b_ndim=node.op.b_ndim)(A, b)
        copy_stack_trace(node.outputs[0], res)
        return [res]

    register_specialize(local_solve_to_cholesky, name="local_solve_to_cholesky")

    @node_rewriter([CheckAndRaise])
    def local_remove_proven_assert(fgraph, node):
        """Drop asserts whose condition is a proven fact (a condition that
        is proven positive is true).  Where some conditions stay, they
        stay in a ``CheckAndRaise`` of the same exception and message: the
        JAX package's ``type(node.op)(exc_type, msg)`` raises for an
        ``Assert``, and its rewrite then changes nothing."""
        value, *conds = node.inputs
        remaining = []
        for c in conds:
            if holds_in(fgraph, c, "positive") == FactState.TRUE:
                continue
            remaining.append(c)
        if len(remaining) == len(conds):
            return False
        if not remaining:
            return [value]
        return [CheckAndRaise(node.op.exc_type, node.op.msg)(value, *remaining)]

    register_specialize(local_remove_proven_assert, name="local_remove_proven_assert")


_register_rewrites()

"""Matmul assumption rules (reference assumptions/dot.py)."""

from __future__ import annotations

from pytensor_tpu_torch.assumptions import FactState, gram_factor, register_assumption
from pytensor_tpu_torch.tensor.math import Dot


def dot_rule(node, fact, holds_fn):
    """Gram products, triangular / diagonal / orthogonal closure."""
    x, y = node.inputs
    if fact == "diagonal":
        if holds_fn(x, "diagonal") == FactState.TRUE and \
                holds_fn(y, "diagonal") == FactState.TRUE:
            return FactState.TRUE
    if fact in ("lower_triangular", "upper_triangular"):
        if holds_fn(x, fact) == FactState.TRUE and \
                holds_fn(y, fact) == FactState.TRUE:
            return FactState.TRUE
    if fact in ("orthogonal", "permutation"):
        if holds_fn(x, fact) == FactState.TRUE and \
                holds_fn(y, fact) == FactState.TRUE:
            return FactState.TRUE
    if fact in ("symmetric", "positive_definite"):
        base = gram_factor(node)
        if base is not None:
            if fact == "symmetric":
                return FactState.TRUE
            # A A^T is PD when A is an (invertible) Cholesky factor or
            # itself assumed PD/orthogonal
            from pytensor_tpu_torch.tensor.linalg import Cholesky

            if base.owner is not None and isinstance(
                    base.owner.op, Cholesky):
                return FactState.TRUE
            if holds_fn(base, "positive_definite") == FactState.TRUE or \
                    holds_fn(base, "orthogonal") == FactState.TRUE:
                return FactState.TRUE
    return FactState.UNKNOWN


register_assumption(Dot, dot_rule)

try:
    from pytensor_tpu_torch.tensor.blas import Dot22

    register_assumption(Dot22, dot_rule)
except ImportError:
    pass

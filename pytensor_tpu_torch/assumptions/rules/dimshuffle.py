"""Transpose / expand-dims assumption rules (reference
assumptions/dimshuffle.py)."""

from __future__ import annotations

from pytensor_tpu_torch.assumptions import FactState, register_assumption
from pytensor_tpu_torch.tensor.elemwise import DimShuffle


def dimshuffle_rule(node, fact, holds_fn):
    op = node.op
    (x,) = node.inputs
    if op.is_transpose and op.shuffle == tuple(reversed(range(len(op.shuffle)))):
        if fact == "lower_triangular":
            return holds_fn(x, "upper_triangular")
        if fact == "upper_triangular":
            return holds_fn(x, "lower_triangular")
        if fact in ("symmetric", "diagonal", "positive_definite",
                    "orthogonal", "permutation", "non_negative",
                    "positive", "zero"):
            return holds_fn(x, fact)
    if not op.drop and not op.shuffle:
        # pure expand_dims of a scalar: value facts pass through
        if fact in ("non_negative", "positive", "zero"):
            return holds_fn(x, fact)
    return FactState.UNKNOWN


register_assumption(DimShuffle, dimshuffle_rule)

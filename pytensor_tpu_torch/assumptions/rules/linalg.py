"""Linalg-op assumption rules: factorization outputs carry structure
(reference assumptions/{triangular,orthogonal,positive_definite}.py).
"""

from __future__ import annotations

from pytensor_tpu_torch.assumptions import FactState, register_assumption
from pytensor_tpu_torch.tensor.linalg import (
    QR,
    SVD,
    Cholesky,
    Eigh,
    Lu,
    MatrixInverse,
)


def cholesky_rule(node, fact, holds_fn):
    op = node.op
    if fact == "lower_triangular":
        return FactState.TRUE if op.lower else FactState.FALSE
    if fact == "upper_triangular":
        return FactState.FALSE if op.lower else FactState.TRUE
    return FactState.UNKNOWN


def inverse_rule(node, fact, holds_fn):
    (x,) = node.inputs
    if fact in ("positive_definite", "diagonal", "symmetric",
                "lower_triangular", "upper_triangular", "orthogonal"):
        # all preserved under matrix inverse
        return holds_fn(x, fact)
    return FactState.UNKNOWN


def qr_output_rule(node, fact, holds_fn, out_index=None):
    """QR: Q is orthogonal (square mode), R is upper triangular."""
    if out_index is None:
        return FactState.UNKNOWN
    if out_index == 0 and fact == "orthogonal":
        # square Q only: reduced-mode rectangular Q is only column-orthonormal
        q = node.outputs[0]
        if q.type.shape[0] is not None and q.type.shape[0] == q.type.shape[1]:
            return FactState.TRUE
    if out_index == 1 and fact == "upper_triangular":
        return FactState.TRUE
    return FactState.UNKNOWN


def eigh_rule(node, fact, holds_fn, out_index=None):
    """Eigh: eigenvector matrix is orthogonal; eigenvalues of a PD
    operand are positive."""
    if out_index == 1 and fact == "orthogonal":
        return FactState.TRUE
    if out_index == 0 and fact in ("positive", "non_negative"):
        sub = holds_fn(node.inputs[0], "positive_definite")
        if sub == FactState.TRUE:
            return FactState.TRUE
    return FactState.UNKNOWN


def svd_rule(node, fact, holds_fn, out_index=None):
    op = node.op
    if not getattr(op, "compute_uv", True):
        if out_index == 0 and fact == "non_negative":
            return FactState.TRUE  # singular values
        return FactState.UNKNOWN
    if out_index == 1 and fact == "non_negative":
        return FactState.TRUE
    if out_index in (0, 2) and fact == "orthogonal":
        v = node.outputs[out_index]
        if v.type.shape[0] is not None and v.type.shape[0] == v.type.shape[1]:
            return FactState.TRUE
    return FactState.UNKNOWN


def lu_rule(node, fact, holds_fn, out_index=None):
    """Lu outputs (p, l, u): l unit lower triangular, u upper."""
    if out_index == 1 and fact in ("lower_triangular", "unit_diagonal"):
        return FactState.TRUE
    if out_index == 2 and fact == "upper_triangular":
        return FactState.TRUE
    return FactState.UNKNOWN


register_assumption(Cholesky, cholesky_rule)
register_assumption(MatrixInverse, inverse_rule)
register_assumption(QR, qr_output_rule)
register_assumption(Eigh, eigh_rule)
register_assumption(SVD, svd_rule)
register_assumption(Lu, lu_rule)

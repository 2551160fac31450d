"""Structural-op assumption rules: Eye/Alloc/diag construction,
permutation rows, shape ops and value-fact passthrough (reference
assumptions/{alloc,permutation,diagonal,specify,reshape,subtensor}.py).
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.assumptions import FactState, register_assumption
from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.tensor.basic import Alloc, Eye, Join, MakeVector
from pytensor_tpu_torch.tensor.shape import Reshape, SpecifyShape
from pytensor_tpu_torch.tensor.subtensor import (
    AdvancedIncSubtensor,
    AdvancedSubtensor1,
    Subtensor,
)

_VALUE_FACTS = ("positive", "non_negative", "zero")


def eye_rule(node, fact, holds_fn):
    """eye(n, m, k): facts depend on the OFFSET — eye with k=1 is
    strictly upper triangular, not diagonal/symmetric (claiming those
    unconditionally corrupted the eye-mask diag(v, k!=0) form)."""
    from pytensor_tpu_torch.tensor.basic import (
        NotScalarConstantError,
        get_scalar_constant_value,
    )

    def _static(v):
        if v is None:
            return None
        try:
            return int(get_scalar_constant_value(v))
        except NotScalarConstantError:
            return None

    k_static = _static(node.inputs[2] if len(node.inputs) > 2 else None)
    sn, sm = node.outputs[0].type.shape
    n_s = _static(node.inputs[0]) if node.inputs else None
    m_s = _static(node.inputs[1]) if len(node.inputs) > 1 else None
    # squareness: static output dims, constant n == m, or the ctor's
    # m=None default (both dims fed by the same pre-cast variable)
    def _uncast(v):
        from pytensor_tpu_torch.tensor.elemwise import Elemwise

        while v is not None and v.owner is not None \
                and isinstance(v.owner.op, Elemwise) \
                and getattr(v.owner.op.scalar_op, "name", "").startswith("cast"):
            v = v.owner.inputs[0]
        return v

    square = (sn is not None and sn == sm) \
        or (n_s is not None and n_s == m_s) \
        or (len(node.inputs) > 1
            and _uncast(node.inputs[0]) is _uncast(node.inputs[1]))

    if fact == "non_negative":
        return FactState.TRUE
    if fact == "upper_triangular":
        if k_static is not None and k_static >= 0:
            return FactState.TRUE
        return FactState.UNKNOWN
    if fact == "lower_triangular":
        if k_static is not None and k_static <= 0:
            return FactState.TRUE
        return FactState.UNKNOWN
    if fact in ("diagonal", "symmetric"):
        if k_static == 0:
            return FactState.TRUE
        return FactState.UNKNOWN
    if fact in ("positive_definite", "orthogonal", "permutation"):
        if k_static == 0 and square:
            return FactState.TRUE
        return FactState.UNKNOWN
    return FactState.UNKNOWN


def alloc_rule(node, fact, holds_fn):
    v = node.inputs[0]
    if fact in _VALUE_FACTS:
        return holds_fn(v, fact)
    if fact in ("diagonal", "symmetric", "lower_triangular",
                "upper_triangular"):
        if holds_fn(v, "zero") == FactState.TRUE and \
                node.outputs[0].type.ndim == 2:
            return FactState.TRUE
    return FactState.UNKNOWN


def perm_rows_rule(node, fact, holds_fn):
    """P[perm] for a permutation matrix P (e.g. eye(n)[perm]) is again a
    permutation matrix: permutation + orthogonal (reference
    assumptions/permutation.py)."""
    x, idx = node.inputs
    if fact in ("orthogonal", "permutation"):
        base = "permutation" if fact == "permutation" else "orthogonal"
        if holds_fn(x, base) != FactState.TRUE:
            return FactState.UNKNOWN
        if not isinstance(idx, Constant):
            return FactState.UNKNOWN
        iv = np.asarray(idx.data)
        n = x.type.shape[0]
        if n is None or iv.ndim != 1 or iv.size != n:
            return FactState.UNKNOWN
        if np.array_equal(np.sort(iv % n), np.arange(n)):
            return FactState.TRUE
        return FactState.UNKNOWN
    if fact in _VALUE_FACTS:
        return holds_fn(x, fact)
    return FactState.UNKNOWN


def set_diag_rule(node, fact, holds_fn):
    """set_subtensor(zeros[ar, ar], v): how diag(v) is built — diagonal
    (hence symmetric/triangular)."""
    if fact in _VALUE_FACTS:
        x, y, *_ = node.inputs
        if holds_fn(x, "zero") == FactState.TRUE and fact == "non_negative":
            return holds_fn(y, "non_negative")
        return FactState.UNKNOWN
    if fact not in ("diagonal", "symmetric", "lower_triangular",
                    "upper_triangular"):
        return FactState.UNKNOWN
    op = node.op
    if not getattr(op, "set_instead_of_inc", False):
        return FactState.UNKNOWN
    x, y, *indices = node.inputs
    if holds_fn(x, "zero") != FactState.TRUE:
        return FactState.UNKNOWN
    if len(indices) != 2:
        return FactState.UNKNOWN
    r, c = indices
    if r is c:  # literally the same arange: the main diagonal
        return FactState.TRUE
    return FactState.UNKNOWN


def value_passthrough_rule(node, fact, holds_fn):
    """Shape-only ops preserve elementwise value facts (reference
    assumptions/{specify,reshape,subtensor}.py)."""
    if fact not in _VALUE_FACTS:
        return FactState.UNKNOWN
    return holds_fn(node.inputs[0], fact)


def joinlike_value_rule(node, fact, holds_fn):
    if fact not in _VALUE_FACTS:
        return FactState.UNKNOWN
    data = node.inputs[1:] if isinstance(node.op, Join) else node.inputs
    subs = [holds_fn(i, fact) for i in data]
    if subs and all(s == FactState.TRUE for s in subs):
        return FactState.TRUE
    return FactState.UNKNOWN


register_assumption(Eye, eye_rule)
register_assumption(Alloc, alloc_rule)
register_assumption(AdvancedSubtensor1, perm_rows_rule)
register_assumption(AdvancedIncSubtensor, set_diag_rule)
register_assumption(SpecifyShape, value_passthrough_rule)
register_assumption(Reshape, value_passthrough_rule)
register_assumption(Subtensor, value_passthrough_rule)
register_assumption(Join, joinlike_value_rule)
register_assumption(MakeVector, joinlike_value_rule)

"""Top-level value->Variable conversion.

Counterpart of ``pytensor_tpu/basic_symbolic.py`` (PyTensor's basic.py
as_symbolic:8): a singledispatch turning python values into graph
Variables (ndarray -> TensorConstant, slice -> SliceConstant,
scipy.sparse -> sparse constant, None -> NoneConst).
"""

from __future__ import annotations

from functools import singledispatch

import numpy as np

from pytensor_tpu_torch.graph.basic import Variable


@singledispatch
def as_symbolic(x, **kwargs):
    # lazy scipy registration (PyTensor's _sparse_lazy.py trick): only pay
    # the scipy.sparse import when a sparse value actually shows up
    if _register_sparse():
        return as_symbolic(x, **kwargs)
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable

    return as_tensor_variable(x, **kwargs)


@as_symbolic.register(Variable)
def _as_symbolic_var(x, **kwargs):
    return x


@as_symbolic.register(slice)
def _as_symbolic_slice(x, **kwargs):
    from pytensor_tpu_torch.tensor.type_other import as_symbolic_slice

    return as_symbolic_slice(x)


@as_symbolic.register(type(None))
def _as_symbolic_none(x, **kwargs):
    from pytensor_tpu_torch.tensor.type_other import NoneConst

    return NoneConst


_sparse_registered = False


def _register_sparse():
    """Register the scipy.sparse dispatch on first use; True if this call
    added it (caller should redispatch)."""
    global _sparse_registered
    if _sparse_registered:
        return False
    _sparse_registered = True
    try:
        import scipy.sparse as sp

        @as_symbolic.register(sp.spmatrix)
        def _as_symbolic_sparse(x, **kwargs):
            from pytensor_tpu_torch.sparse.basic import as_sparse_variable

            return as_sparse_variable(x)

        return True
    except Exception:
        return False

"""Sparse variable operator sugar.

Counterpart of ``pytensor_tpu/sparse/variable.py``, whole: symbolic
scipy.sparse-like operators on sparse graph variables.  All methods
route to the sparse op constructors lazily (sparse.basic imports this
module's type at import time)."""

from __future__ import annotations

from pytensor_tpu_torch.graph.basic import Constant, Variable


class _SparseOperators:
    def __add__(self, other):
        from pytensor_tpu_torch.sparse.basic import add

        return add(self, other)

    __radd__ = __add__

    def __sub__(self, other):
        from pytensor_tpu_torch.sparse.compat import sub

        return sub(self, other)

    def __rsub__(self, other):
        from pytensor_tpu_torch.sparse.compat import sub

        return sub(other, self)

    def __mul__(self, other):
        from pytensor_tpu_torch.sparse.basic import mul

        return mul(self, other)

    __rmul__ = __mul__

    def __neg__(self):
        from pytensor_tpu_torch.sparse.compat import neg

        return neg(self)

    def __matmul__(self, other):
        from pytensor_tpu_torch.sparse.basic import structured_dot

        return structured_dot(self, other)

    def __getitem__(self, idx):
        from pytensor_tpu_torch.sparse.basic import get_item_scalar
        from pytensor_tpu_torch.sparse.structured import get_item_list

        if isinstance(idx, tuple) and len(idx) == 2:
            return get_item_scalar(self, idx[0], idx[1])
        return get_item_list(self, idx)

    @property
    def T(self):
        from pytensor_tpu_torch.sparse.basic import transpose

        return transpose(self)

    def transpose(self):
        return self.T

    def sum(self, axis=None, sparse_grad=False):
        from pytensor_tpu_torch.sparse.basic import sp_sum

        return sp_sum(self, axis=axis, sparse_grad=sparse_grad)

    def toarray(self):
        from pytensor_tpu_torch.sparse.basic import dense_from_sparse

        return dense_from_sparse(self)

    todense = toarray

    def astype(self, dtype):
        from pytensor_tpu_torch.sparse.compat import cast

        return cast(self, dtype)

    def diagonal(self):
        from pytensor_tpu_torch.sparse.structured import diag

        return diag(self)

    @property
    def shape(self):
        from pytensor_tpu_torch.tensor.shape import shape

        return shape(self.toarray())

    @property
    def dtype(self):
        return self.type.dtype

    @property
    def format(self):
        return self.type.format


class SparseVariable(_SparseOperators, Variable):
    pass


class SparseConstant(_SparseOperators, Constant):
    pass

"""Sparse tensor type.

Counterpart of ``pytensor_tpu/sparse/type.py`` (PyTensor's
sparse/type.py SparseTensorType:36), cut to the csr and csc formats.  A
value on the host is a scipy matrix, as in the JAX package; linked for
torch, a sparse value is the canonical CSR triple of
``link/torch/convert.py sparse_as_torch``.  Left out: the bcoo and bsr
formats, ``xla_typify`` (the JAX package's conversion to BCOO) and the
``csr_matrix``/``csc_matrix`` constructors of symbolic inputs.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.type import Type


class SparseTensorType(Type):
    __props__ = ("format", "dtype", "shape")

    def __init__(self, format: str, dtype: str, shape=None):
        if format not in ("csr", "csc"):
            raise ValueError(f"unsupported sparse format {format}")
        self.format = format
        self.dtype = str(dtype)
        self.shape = tuple(shape) if shape is not None else (None, None)

    @property
    def ndim(self):
        return len(self.shape)

    @property
    def numpy_dtype(self):
        return np.dtype(self.dtype)

    def filter(self, value, strict=False, allow_downcast=None):
        import scipy.sparse as sp

        if not sp.issparse(value):
            raise TypeError(f"expected a scipy sparse matrix, got {type(value)}")
        if value.format != self.format:
            if strict:
                raise TypeError(f"expected format {self.format}, got {value.format}")
            value = value.asformat(self.format)
        if str(value.dtype) != self.dtype:
            if strict:
                raise TypeError(f"expected dtype {self.dtype}, got {value.dtype}")
            value = value.astype(self.dtype)
        return value

    def values_eq(self, a, b):
        return a.shape == b.shape and (a != b).nnz == 0

    def make_constant_signature(self, data):
        # two constants are one only when they hold the same matrix object
        return (self.format, self.dtype, data.shape, id(data))

    def __str__(self):
        return f"Sparse({self.format}, {self.dtype}, {self.shape})"


def _wire_variable_classes():
    from pytensor_tpu_torch.sparse.variable import SparseConstant, SparseVariable

    SparseTensorType.variable_type = SparseVariable
    SparseTensorType.constant_type = SparseConstant


_wire_variable_classes()

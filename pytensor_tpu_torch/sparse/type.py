"""Sparse tensor type.

Counterpart of ``pytensor_tpu/sparse/type.py`` (PyTensor's
sparse/type.py SparseTensorType:36), whole but for the JAX package's own
``bcoo`` format and its ``xla_typify``.  A value on the host is a scipy
matrix, as in the JAX package; a torch sparse compressed tensor is taken
too (``filter``), where the JAX package takes a BCOO.  Linked for torch,
a sparse value of any format is the logical matrix's CSR triple
(``link/torch/convert.py CSR``), and a function returns it as a torch
sparse tensor in the graph's format.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.type import HasDataType, HasShape, Type


def _torch_sparse_format(value):
    """``"csr"`` or ``"csc"`` for a torch sparse compressed tensor of that
    layout, None for anything else."""
    layout = getattr(value, "layout", None)
    if layout is None or not type(value).__module__.startswith("torch"):
        return None
    return {"torch.sparse_csr": "csr", "torch.sparse_csc": "csc"}.get(str(layout))


class SparseTensorType(Type, HasDataType, HasShape):
    __props__ = ("format", "dtype", "shape")

    def __init__(self, format: str, dtype: str, shape=None):
        if format == "bcoo":
            raise ValueError("the bcoo format is jax's own sparse array; the port's sparse "
                             "value is a torch sparse compressed tensor (csr or csc)")
        if format not in ("csr", "csc", "bsr"):
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

        if sp.issparse(value):
            if value.format != self.format:
                value = value.asformat(self.format)
            if str(value.dtype) != self.dtype:
                if strict:
                    raise TypeError(f"expected dtype {self.dtype}, got {value.dtype}")
                value = value.astype(self.dtype)
            return value
        fmt = _torch_sparse_format(value)
        if fmt is not None:
            # the logical matrix: a csc tensor for a csr type is taken as it
            # is, as a scipy matrix of another format is converted
            from pytensor_tpu_torch.link.torch.convert import torch_dtype

            if strict and fmt != self.format:
                raise TypeError(f"expected format {self.format}, got {fmt}")
            want = torch_dtype(self.dtype)
            if value.dtype != want:
                if strict:
                    raise TypeError(f"expected dtype {self.dtype}, got {value.dtype}")
                value = value.to(want)
            return value
        if strict:
            raise TypeError(f"expected a sparse matrix, got {type(value)}")
        arr = np.asarray(value, dtype=self.numpy_dtype)
        return getattr(sp, f"{self.format}_matrix")(arr)

    def values_eq(self, a, b):
        return (a != b).nnz == 0 if hasattr(a, "nnz") else bool(np.array_equal(a, b))

    def values_eq_approx(self, a, b, **kwargs):
        return np.allclose(_dense(a), _dense(b))

    def make_constant_signature(self, data):
        return (self.format, self.dtype, data.shape, data.tobytes()
                if isinstance(data, np.ndarray) else id(data))

    def __str__(self):
        return f"Sparse({self.format}, {self.dtype}, {self.shape})"


def _dense(value):
    """A scipy matrix, a torch sparse tensor or an array as a numpy array."""
    if hasattr(value, "toarray"):
        return value.toarray()
    if _torch_sparse_format(value) is not None:
        return value.to_dense().cpu().numpy()
    return np.asarray(value)


def matrix(format="csr", name=None, dtype=None):
    from pytensor_tpu_torch.config import config

    return SparseTensorType(format, dtype or config.floatX)(name)


csr_matrix = lambda name=None, dtype=None: matrix("csr", name, dtype)  # noqa: E731
csc_matrix = lambda name=None, dtype=None: matrix("csc", name, dtype)  # noqa: E731
bsr_matrix = lambda name=None, dtype=None: matrix("bsr", name, dtype)  # noqa: E731
csr_dmatrix = lambda name=None: matrix("csr", name, "float64")  # noqa: E731
csc_dmatrix = lambda name=None: matrix("csc", name, "float64")  # noqa: E731
bsr_dmatrix = lambda name=None: matrix("bsr", name, "float64")  # noqa: E731
csr_fmatrix = lambda name=None: matrix("csr", name, "float32")  # noqa: E731
csc_fmatrix = lambda name=None: matrix("csc", name, "float32")  # noqa: E731
bsr_fmatrix = lambda name=None: matrix("bsr", name, "float32")  # noqa: E731


def _wire_variable_classes():
    from pytensor_tpu_torch.sparse.variable import SparseConstant, SparseVariable

    SparseTensorType.variable_type = SparseVariable
    SparseTensorType.constant_type = SparseConstant


_wire_variable_classes()

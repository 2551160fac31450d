"""TensorVariable: numpy-like operator sugar on graph variables.

Counterpart of ``pytensor_tpu/tensor/variable.py`` (PyTensor's
tensor/variable.py _tensor_py_operators:26, TensorVariable:838,
TensorConstant:1020), cut to the operators the radon graphs use.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Constant, Variable
from pytensor_tpu_torch.tensor.type import TensorType


def _tm():
    from pytensor_tpu_torch.tensor import math

    return math


def _tb():
    from pytensor_tpu_torch.tensor import basic

    return basic


class _tensor_py_operators:
    # numpy must defer to our reflected dunders: without this,
    # np.float64(0.9) * var routes through numpy's ufunc machinery and the
    # scalar reaches the graph as a downcast python float
    __array_ufunc__ = None
    __array_priority__ = 1000

    # --- arithmetic ---
    def __add__(self, other):
        return _tm().add(self, other)

    def __radd__(self, other):
        return _tm().add(other, self)

    def __sub__(self, other):
        return _tm().sub(self, other)

    def __rsub__(self, other):
        return _tm().sub(other, self)

    def __mul__(self, other):
        return _tm().mul(self, other)

    def __rmul__(self, other):
        return _tm().mul(other, self)

    def __truediv__(self, other):
        return _tm().true_div(self, other)

    def __rtruediv__(self, other):
        return _tm().true_div(other, self)

    def __pow__(self, other):
        return _tm().pow(self, other)

    def __rpow__(self, other):
        return _tm().pow(other, self)

    def __neg__(self):
        return _tm().neg(self)

    def __pos__(self):
        return self

    def __bool__(self):
        raise TypeError(
            "Truth value of a symbolic tensor is ambiguous."
        )

    # --- properties ---
    @property
    def dtype(self):
        return self.type.dtype

    @property
    def ndim(self):
        return self.type.ndim

    @property
    def broadcastable(self):
        return self.type.broadcastable

    @property
    def shape(self):
        from pytensor_tpu_torch.tensor.shape import shape

        return shape(self)

    @property
    def T(self):
        return _tb().transpose(self)

    # --- indexing ---
    def __getitem__(self, args):
        from pytensor_tpu_torch.tensor.subtensor import _getitem

        return _getitem(self, args)

    # --- methods mirroring ndarray ---
    def astype(self, dtype):
        return _tb().cast(self, dtype)

    def reshape(self, shape, *more, ndim=None):
        if more:
            shape = (shape, *more)
        from pytensor_tpu_torch.tensor.shape import reshape

        return reshape(self, shape)

    def flatten(self, ndim=1):
        from pytensor_tpu_torch.tensor.shape import flatten

        return flatten(self, ndim)

    def dimshuffle(self, *pattern):
        if len(pattern) == 1 and isinstance(pattern[0], (list, tuple)):
            pattern = tuple(pattern[0])
        from pytensor_tpu_torch.tensor.elemwise import DimShuffle

        return DimShuffle(self.type.ndim, pattern)(self)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _tb().transpose(self, axes or None)

    def sum(self, axis=None, dtype=None, keepdims=False, acc_dtype=None):
        return _tm().sum(self, axis=axis, dtype=dtype, keepdims=keepdims, acc_dtype=acc_dtype)

    def dot(self, other):
        return _tm().dot(self, other)

    def exp(self):
        return _tm().exp(self)

    def log(self):
        return _tm().log(self)

    def fill(self, value):
        return _tb().fill(self, value)

    def zeros_like(self, dtype=None):
        return _tb().zeros_like(self, dtype=dtype)

    def ones_like(self, dtype=None):
        return _tb().ones_like(self, dtype=dtype)


class TensorVariable(_tensor_py_operators, Variable):
    """Variable subclass for TensorType."""

    __slots__ = ()


class TensorConstant(_tensor_py_operators, Constant):
    """Constant subclass for TensorType."""

    __slots__ = ()

    @property
    def unique_value(self):
        """If all elements are equal, that value; else None."""
        data = np.asarray(self.data)
        if data.size == 0:
            return None
        flat = data.ravel()
        if data.size == 1 or bool(np.all(flat == flat[0])):
            return flat[0]
        return None

    def __str__(self):
        if self.name is not None:
            return self.name
        s = str(np.asarray(self.data))
        if len(s) > 20:
            s = s[:10] + ".." + s[-8:]
        return f"{s}"


TensorType.variable_type = TensorVariable
TensorType.constant_type = TensorConstant

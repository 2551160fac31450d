"""TensorVariable: numpy-like operator sugar on graph variables.

Counterpart of ``pytensor_tpu/tensor/variable.py`` (PyTensor's
tensor/variable.py _tensor_py_operators:26, TensorVariable:838,
TensorConstant:1020).
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

    def __floordiv__(self, other):
        return _tm().int_div(self, other)

    def __rfloordiv__(self, other):
        return _tm().int_div(other, self)

    def __mod__(self, other):
        return _tm().mod(self, other)

    def __rmod__(self, other):
        return _tm().mod(other, self)

    def __divmod__(self, other):
        return _tm().int_div(self, other), _tm().mod(self, other)

    def __pow__(self, other):
        return _tm().pow(self, other)

    def __rpow__(self, other):
        return _tm().pow(other, self)

    def __neg__(self):
        return _tm().neg(self)

    def __pos__(self):
        return self

    def __abs__(self):
        return _tm().abs(self)

    def __invert__(self):
        return _tm().invert(self)

    def __matmul__(self, other):
        return _tm().matmul(self, other)

    def __rmatmul__(self, other):
        return _tm().matmul(other, self)

    # --- comparisons (elementwise, like numpy arrays) ---
    def __lt__(self, other):
        return _tm().lt(self, other)

    def __le__(self, other):
        return _tm().le(self, other)

    def __gt__(self, other):
        return _tm().gt(self, other)

    def __ge__(self, other):
        return _tm().ge(self, other)

    def __and__(self, other):
        return _tm().and_(self, other)

    def __rand__(self, other):
        return _tm().and_(other, self)

    def __or__(self, other):
        return _tm().or_(self, other)

    def __ror__(self, other):
        return _tm().or_(other, self)

    def __xor__(self, other):
        return _tm().xor(self, other)

    def __rxor__(self, other):
        return _tm().xor(other, self)

    def __lshift__(self, other):
        return _tm().left_shift(self, other)

    def __rshift__(self, other):
        return _tm().right_shift(self, other)

    def __bool__(self):
        raise TypeError(
            "Truth value of a symbolic tensor is ambiguous; use .eval() or eq()/neq()."
        )

    def __iter__(self):
        # support tuple-unpacking of known first-dim length
        n = self.type.shape[0] if self.type.ndim > 0 else None
        if n is None:
            raise TypeError("Cannot iterate over a tensor with unknown first dim")
        return iter([self[i] for i in range(n)])

    def __len__(self):
        n = self.type.shape[0] if self.type.ndim > 0 else None
        if n is None:
            raise TypeError("Length of tensor with unknown first dim")
        return n

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
    def size(self):
        # even for 0-d, stay a graph over shape(self) so the input is
        # used (PyTensor's variable.py size property; rewrites fold it)
        if self.ndim == 1:
            return self.shape[0]
        return _tm().prod(self.shape)

    @property
    def T(self):
        return _tb().transpose(self)

    @property
    def mT(self):
        return _tb().matrix_transpose(self)

    @property
    def real(self):
        return _tm().real(self)

    @property
    def imag(self):
        return _tm().imag(self)

    # --- indexing ---
    def __getitem__(self, args):
        from pytensor_tpu_torch.tensor.subtensor import _getitem

        return _getitem(self, args)

    def __setitem__(self, key, value):
        raise TypeError(
            "TensorVariable does not support item assignment; use "
            "pytensor_tpu_torch.tensor.set_subtensor(x[k], v) which returns a new variable."
        )

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

    def ravel(self):
        return self.flatten()

    def dimshuffle(self, *pattern):
        if len(pattern) == 1 and isinstance(pattern[0], (list, tuple)):
            pattern = tuple(pattern[0])
        from pytensor_tpu_torch.tensor.elemwise import DimShuffle

        return DimShuffle(self.type.ndim, pattern)(self)

    def transpose(self, *axes):
        if len(axes) == 1 and isinstance(axes[0], (list, tuple)):
            axes = tuple(axes[0])
        return _tb().transpose(self, axes or None)

    def swapaxes(self, axis1, axis2):
        return _tb().swapaxes(self, axis1, axis2)

    def squeeze(self, axis=None):
        from pytensor_tpu_torch.tensor.extra_ops import squeeze

        return squeeze(self, axis)

    def sum(self, axis=None, dtype=None, keepdims=False, acc_dtype=None):
        return _tm().sum(self, axis=axis, dtype=dtype, keepdims=keepdims, acc_dtype=acc_dtype)

    def prod(self, axis=None, dtype=None, keepdims=False):
        return _tm().prod(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def mean(self, axis=None, dtype=None, keepdims=False):
        return _tm().mean(self, axis=axis, dtype=dtype, keepdims=keepdims)

    def var(self, axis=None, ddof=0, keepdims=False):
        return _tm().var(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def std(self, axis=None, ddof=0, keepdims=False):
        return _tm().std(self, axis=axis, ddof=ddof, keepdims=keepdims)

    def max(self, axis=None, keepdims=False):
        return _tm().max(self, axis=axis, keepdims=keepdims)

    def min(self, axis=None, keepdims=False):
        return _tm().min(self, axis=axis, keepdims=keepdims)

    def argmax(self, axis=None, keepdims=False):
        return _tm().argmax(self, axis=axis, keepdims=keepdims)

    def argmin(self, axis=None, keepdims=False):
        return _tm().argmin(self, axis=axis, keepdims=keepdims)

    def any(self, axis=None, keepdims=False):
        return _tm().any(self, axis=axis, keepdims=keepdims)

    def all(self, axis=None, keepdims=False):
        return _tm().all(self, axis=axis, keepdims=keepdims)

    def cumsum(self, axis=None):
        from pytensor_tpu_torch.tensor.extra_ops import cumsum

        return cumsum(self, axis)

    def cumprod(self, axis=None):
        from pytensor_tpu_torch.tensor.extra_ops import cumprod

        return cumprod(self, axis)

    def dot(self, other):
        return _tm().dot(self, other)

    def norm(self, L=2, axis=None, keepdims=False):
        return _tm().norm(self, L, axis=axis, keepdims=keepdims)

    def exp(self):
        return _tm().exp(self)

    def log(self):
        return _tm().log(self)

    def sqrt(self):
        return _tm().sqrt(self)

    def abs(self):
        return _tm().abs(self)

    def conj(self):
        return _tm().conj(self)

    conjugate = conj

    def round(self, mode=None):
        return _tm().round(self, mode)

    def ptp(self, axis=None):
        return _tm().ptp(self, axis)

    def set(self, y, **kwargs):
        """x[idx].set(y): functional update of the indexed view
        (PyTensor's TensorVariable.set)."""
        from pytensor_tpu_torch.tensor.subtensor import set_subtensor

        return set_subtensor(self, y, **kwargs)

    def inc(self, y, **kwargs):
        from pytensor_tpu_torch.tensor.subtensor import inc_subtensor

        return inc_subtensor(self, y, **kwargs)

    def clip(self, a_min, a_max):
        return _tm().clip(self, a_min, a_max)

    def trace(self):
        from pytensor_tpu_torch.tensor.basic import trace

        return trace(self)

    def diagonal(self, offset=0, axis1=0, axis2=1):
        from pytensor_tpu_torch.tensor.basic import diagonal

        return diagonal(self, offset, axis1, axis2)

    def take(self, indices, axis=None):
        from pytensor_tpu_torch.tensor.subtensor import take

        return take(self, indices, axis)

    def repeat(self, repeats, axis=None):
        from pytensor_tpu_torch.tensor.extra_ops import repeat

        return repeat(self, repeats, axis)

    def sort(self, axis=-1, kind="quicksort", order=None):
        from pytensor_tpu_torch.tensor.sort import sort

        return sort(self, axis, kind, order)

    def argsort(self, axis=-1, kind="quicksort", order=None):
        from pytensor_tpu_torch.tensor.sort import argsort

        return argsort(self, axis, kind, order)

    def nonzero(self, return_matrix=False):
        return _tb().nonzero(self, return_matrix)

    def choose(self, choices, mode="raise"):
        from pytensor_tpu_torch.tensor.math import choose

        return choose(self, choices, mode=mode)

    def fill(self, value):
        return _tb().fill(self, value)

    def zeros_like(self, dtype=None):
        return _tb().zeros_like(self, dtype=dtype)

    def ones_like(self, dtype=None):
        return _tb().ones_like(self, dtype=dtype)

    def copy(self, name=None):
        from pytensor_tpu_torch.compile.ops import deep_copy_op

        out = deep_copy_op(self)
        out.name = name
        return out

    def type_cast(self, dtype):
        return _tb().cast(self, dtype)

    def dprint(self, **kwargs):
        from pytensor_tpu_torch.printing import debugprint

        return debugprint(self, **kwargs)


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


class DenseVariableMeta(type):
    def __instancecheck__(cls, o):
        return isinstance(o, TensorVariable)


class DenseTensorVariable(TensorVariable, metaclass=DenseVariableMeta):
    pass

"""The softmax family and related composites.

Counterpart of ``pytensor_tpu/tensor/special.py``: ``Softmax`` and
``LogSoftmax`` are ``SymbolicOp`` composites, so that rewrites
(``tensor/rewriting/special.py``) track each as one op; their lowering
runs the stable inner graph.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.compile.builders import SymbolicOp
from pytensor_tpu_torch.scalar import math as _psm
from pytensor_tpu_torch.tensor import math as tm
from pytensor_tpu_torch.tensor.basic import as_tensor_variable
from pytensor_tpu_torch.tensor.elemwise import scalar_elemwise as _scalar_elemwise


def _normalize_axis(axis, ndim):
    if axis is None:
        return None
    if isinstance(axis, (int, np.integer)):
        return int(axis) % ndim
    raise TypeError("axis must be an int or None")


class Softmax(SymbolicOp):
    def __init__(self, x, *, axis):
        self.axis = axis
        super().__init__(x)

    def symbolic_call(self, x):
        m = tm.max(x, axis=self.axis, keepdims=True)
        e = tm.exp(x - m)
        return e / tm.sum(e, axis=self.axis, keepdims=True)


class LogSoftmax(SymbolicOp):
    def __init__(self, x, *, axis):
        self.axis = axis
        super().__init__(x)

    def symbolic_call(self, x):
        m = tm.max(x, axis=self.axis, keepdims=True)
        xm = x - m
        return xm - tm.log(tm.sum(tm.exp(xm), axis=self.axis, keepdims=True))


def _apply_sym(cls, x, axis):
    return cls(x, axis=axis)(x)


def _axis(x, axis):
    if axis is None and x.type.ndim != 1:
        axis = x.type.ndim - 1 if x.type.ndim else 0
    return _normalize_axis(axis if axis is not None else 0, max(x.type.ndim, 1))


def softmax(x, axis=None):
    x = as_tensor_variable(x)
    return _apply_sym(Softmax, x, _axis(x, axis))


def log_softmax(x, axis=None):
    x = as_tensor_variable(x)
    return _apply_sym(LogSoftmax, x, _axis(x, axis))


logsoftmax = log_softmax


def logsumexp(x, axis=None, keepdims=False):
    return tm.logsumexp(x, axis=axis, keepdims=keepdims)


def poch(z, m):
    """The Pochhammer symbol (rising factorial)."""
    return tm.gamma(z + m) / tm.gamma(z)


def factorial(n):
    return tm.gamma(n + 1)


def beta(a, b):
    return tm.exp(tm.betaln(a, b))


def log_beta(a, b):
    return tm.betaln(a, b)


# x * log(y) with 0 * log(0) = 0
xlogy = _scalar_elemwise(_psm.xlogy)
xlog1py = _scalar_elemwise(_psm.xlog1py)


def logaddexp(*xs):
    return tm.logaddexp(*xs)

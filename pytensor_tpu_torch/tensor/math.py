"""Tensor math: elemwise wrappers, reductions, Dot.

Counterpart of ``pytensor_tpu/tensor/math.py`` (PyTensor's tensor/math.py
Dot:3041, Sum:3438 and the elemwise wrappers), cut to the ops of the
radon logp+dlogp path, the ported scan tests and the sparse power
iteration (``abs``, ``max``).  The torch linker runs
Dot as ``torch.matmul`` in full float32 (``link/torch/dispatch.py``).
"""

from __future__ import annotations

import builtins

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.scalar import basic as ps
from pytensor_tpu_torch.scalar import math as psm
from pytensor_tpu_torch.tensor import basic as tb
from pytensor_tpu_torch.tensor.basic import as_tensor_variable, cast, constant
from pytensor_tpu_torch.tensor.elemwise import DimShuffle, Elemwise, Max, Sum
from pytensor_tpu_torch.tensor.type import TensorType

# --- elemwise wrappers -----------------------------------------------------
add = Elemwise(ps.add)
sub = Elemwise(ps.sub)
mul = Elemwise(ps.mul)
true_div = Elemwise(ps.true_div)
pow = Elemwise(ps.pow)
neg = Elemwise(ps.neg)
abs = Elemwise(ps.abs)
sign = Elemwise(ps.sign)
sqr = Elemwise(ps.sqr)
sqrt = Elemwise(ps.sqrt)
reciprocal = Elemwise(ps.reciprocal)
exp = Elemwise(ps.exp)
log = Elemwise(ps.log)
sin = Elemwise(ps.sin)
cos = Elemwise(ps.cos)
tanh = Elemwise(ps.tanh)
sigmoid = Elemwise(psm.sigmoid)
maximum = Elemwise(ps.maximum)
lt = Elemwise(ps.lt)
ge = Elemwise(ps.ge)
eq = Elemwise(ps.eq)
second = Elemwise(ps.second)


# --- reductions --------------------------------------------------------------

def _as_axis_tuple(axis):
    """None | int | 0-d array | iterable of those -> None | tuple[int]."""
    if axis is None:
        return None
    if isinstance(axis, (int, np.integer)) or (
        isinstance(axis, np.ndarray) and axis.ndim == 0
    ):
        return (int(axis),)
    return tuple(int(a) for a in axis)


def _reduce(make_op, x, axis, keepdims, **kwargs):
    x = as_tensor_variable(x)
    axis = _as_axis_tuple(axis)
    if axis is not None:
        for a in axis:
            if not (-x.type.ndim <= int(a) < x.type.ndim):
                raise np.exceptions.AxisError(int(a), x.type.ndim)
        axis = tuple(int(a) % x.type.ndim for a in axis)
    res = make_op(axis, **kwargs)(x)
    if keepdims and x.type.ndim:
        full_axis = axis if axis is not None else tuple(builtins.range(x.type.ndim))
        order = []
        j = 0
        for d in builtins.range(x.type.ndim):
            if d in full_axis:
                order.append("x")
            else:
                order.append(j)
                j += 1
        res = DimShuffle(res.type.ndim, order)(res)
    return res


def sum(x, axis=None, dtype=None, keepdims=False, acc_dtype=None):
    return _reduce(lambda a, **k: Sum(a, dtype=dtype, acc_dtype=acc_dtype), x, axis, keepdims)


def max(x, axis=None, keepdims=False):
    return _reduce(lambda a, **k: Max(a), x, axis, keepdims)


# --- dot products ------------------------------------------------------------

class Dot(Op):
    """Matrix/vector product of 1-d/2-d operands (PyTensor's Dot:3041)."""

    __props__ = ()

    def make_node(self, x, y):
        x, y = as_tensor_variable(x), as_tensor_variable(y)
        if x.type.ndim not in (1, 2) or y.type.ndim not in (1, 2):
            raise TypeError(
                f"Dot supports 1-d/2-d operands, got {x.type.ndim}-d and {y.type.ndim}-d; "
                "use tensordot for higher dims"
            )
        k_x = x.type.shape[-1]
        k_y = y.type.shape[0]
        if k_x is not None and k_y is not None and k_x != k_y:
            raise ValueError(
                f"Dot: inner dimensions do not match: "
                f"{x.type.shape} . {y.type.shape}")
        if x.type.ndim == 1 and y.type.ndim == 1:
            out_shape = ()
        elif x.type.ndim == 2 and y.type.ndim == 1:
            out_shape = (x.type.shape[0],)
        elif x.type.ndim == 1 and y.type.ndim == 2:
            out_shape = (y.type.shape[1],)
        else:
            out_shape = (x.type.shape[0], y.type.shape[1])
        out_dtype = ps.upcast(x.type.dtype, y.type.dtype)
        x = cast(x, out_dtype) if x.type.dtype != out_dtype else x
        y = cast(y, out_dtype) if y.type.dtype != out_dtype else y
        return Apply(self, [x, y], [TensorType(out_dtype, out_shape)()])

    def perform(self, node, inputs, output_storage):
        x, y = inputs
        output_storage[0][0] = np.asarray(np.dot(x, y))

    def L_op(self, inputs, outputs, output_grads):
        x, y = inputs
        (gz,) = output_grads
        if x.type.ndim == 1 and y.type.ndim == 1:
            return [gz * y, gz * x]
        if x.type.ndim == 2 and y.type.ndim == 1:
            return [outer(gz, y), dot(tb.transpose(x), gz)]
        if x.type.ndim == 1 and y.type.ndim == 2:
            return [dot(y, gz), outer(x, gz)]
        return [dot(gz, tb.transpose(y)), dot(tb.transpose(x), gz)]


_dot = Dot()


def dot(x, y):
    x, y = as_tensor_variable(x), as_tensor_variable(y)
    if x.type.ndim == 0 or y.type.ndim == 0:
        return x * y
    if x.type.ndim > 2 or y.type.ndim > 2:
        return tensordot(x, y, axes=[[x.type.ndim - 1], [builtins.max(0, y.type.ndim - 2)]])
    return _dot(x, y)


def outer(x, y):
    x, y = as_tensor_variable(x), as_tensor_variable(y)
    if x.type.ndim != 1:
        x = x.flatten()
    if y.type.ndim != 1:
        y = y.flatten()
    return _dot(tb.shape_padright(x), tb.shape_padleft(y))


def tensordot(a, b, axes=2):
    a, b = as_tensor_variable(a), as_tensor_variable(b)
    if isinstance(axes, (int, np.integer)):
        axes_a = list(builtins.range(a.type.ndim - axes, a.type.ndim))
        axes_b = list(builtins.range(axes))
    else:
        axes_a, axes_b = axes
        if isinstance(axes_a, (int, np.integer)):
            axes_a = [axes_a]
        if isinstance(axes_b, (int, np.integer)):
            axes_b = [axes_b]
        axes_a = [int(x) % a.type.ndim for x in axes_a]
        axes_b = [int(x) % b.type.ndim for x in axes_b]
    free_a = [d for d in builtins.range(a.type.ndim) if d not in axes_a]
    free_b = [d for d in builtins.range(b.type.ndim) if d not in axes_b]
    from pytensor_tpu_torch.tensor.shape import shape

    at = tb.transpose(a, free_a + axes_a)
    bt = tb.transpose(b, axes_b + free_b)
    ashp = shape(a)
    bshp = shape(b)
    m = constant(np.int64(1))
    for d in free_a:
        m = m * ashp[d]
    k = constant(np.int64(1))
    for d in axes_a:
        k = k * ashp[d]
    n = constant(np.int64(1))
    for d in free_b:
        n = n * bshp[d]
    a2 = at.reshape([m, k])
    b2 = bt.reshape([k, n])
    res2 = _dot(a2, b2)
    out_shape = [ashp[d] for d in free_a] + [bshp[d] for d in free_b]
    if not out_shape:
        return res2.reshape([]) if res2.type.ndim else res2.flatten().reshape([])
    return res2.reshape(out_shape)

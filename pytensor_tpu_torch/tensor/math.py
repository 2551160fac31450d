"""Tensor math: elemwise wrappers, reductions, Argmax, Dot/matmul.

Counterpart of ``pytensor_tpu/tensor/math.py`` (PyTensor's tensor/math.py
Argmax:142, Dot:3041, Sum/Prod/All/Any:3438-3587 and the elemwise
wrappers).  Left out: the special functions of ``scalar/math.py`` but
``sigmoid`` (ROADMAP Queue 1 item 10).  ``matmul`` of operands above 2-d is a ``Blockwise`` of the core
2-d ``Dot``.  The torch linker runs Dot as ``torch.matmul`` in full
float32 (``link/torch/dispatch.py``).
"""

from __future__ import annotations

import builtins
from typing import Sequence

import numpy as np

from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.graph.basic import Apply, Variable
from pytensor_tpu_torch.graph.null_type import DisconnectedType
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.scalar import basic as ps
from pytensor_tpu_torch.scalar import math as psm
from pytensor_tpu_torch.tensor import basic as tb
from pytensor_tpu_torch.tensor.basic import as_tensor_variable, cast, constant
from pytensor_tpu_torch.tensor.elemwise import (
    CAReduce,
    DimShuffle,
    Elemwise,
    Max,
    Min,
    Prod,
    Sum,
    scalar_elemwise,
)
from pytensor_tpu_torch.tensor.type import TensorType, discrete_dtypes, uint_dtypes

# --- elemwise wrappers -----------------------------------------------------
add = scalar_elemwise(ps.add)
sub = scalar_elemwise(ps.sub)
mul = scalar_elemwise(ps.mul)
true_div = scalar_elemwise(ps.true_div)
div = true_div
int_div = scalar_elemwise(ps.int_div)
floor_div = int_div
mod = scalar_elemwise(ps.mod)
pow = scalar_elemwise(ps.pow)
neg = scalar_elemwise(ps.neg)
abs = scalar_elemwise(ps.abs)
sign = scalar_elemwise(ps.sign)
ceil = scalar_elemwise(ps.ceil)
floor = scalar_elemwise(ps.floor)
trunc = scalar_elemwise(ps.trunc)
round_half_to_even = scalar_elemwise(ps.round_half_to_even)
round_half_away_from_zero = scalar_elemwise(ps.round_half_away_from_zero)
sqr = scalar_elemwise(ps.sqr)
square = sqr
sqrt = scalar_elemwise(ps.sqrt)
reciprocal = scalar_elemwise(ps.reciprocal)
inv = reciprocal
exp = scalar_elemwise(ps.exp)
exp2 = scalar_elemwise(ps.exp2)
expm1 = scalar_elemwise(ps.expm1)
log = scalar_elemwise(ps.log)
log2 = scalar_elemwise(ps.log2)
log10 = scalar_elemwise(ps.log10)
log1p = scalar_elemwise(ps.log1p)
deg2rad = scalar_elemwise(ps.deg2rad)
rad2deg = scalar_elemwise(ps.rad2deg)
sin = scalar_elemwise(ps.sin)
cos = scalar_elemwise(ps.cos)
tan = scalar_elemwise(ps.tan)
arcsin = scalar_elemwise(ps.arcsin)
arccos = scalar_elemwise(ps.arccos)
arctan = scalar_elemwise(ps.arctan)
arctan2 = scalar_elemwise(ps.arctan2)
sinh = scalar_elemwise(ps.sinh)
cosh = scalar_elemwise(ps.cosh)
tanh = scalar_elemwise(ps.tanh)
arcsinh = scalar_elemwise(ps.arcsinh)
arccosh = scalar_elemwise(ps.arccosh)
arctanh = scalar_elemwise(ps.arctanh)
lt = scalar_elemwise(ps.lt)
gt = scalar_elemwise(ps.gt)
le = scalar_elemwise(ps.le)
ge = scalar_elemwise(ps.ge)
eq = scalar_elemwise(ps.eq)
neq = scalar_elemwise(ps.neq)
isnan = scalar_elemwise(ps.isnan)
isinf = scalar_elemwise(ps.isinf)
maximum = scalar_elemwise(ps.maximum)
minimum = scalar_elemwise(ps.minimum)
and_ = scalar_elemwise(ps.and_)
bitwise_and = and_
or_ = scalar_elemwise(ps.or_)
bitwise_or = or_
xor = scalar_elemwise(ps.xor)
bitwise_xor = xor
invert = scalar_elemwise(ps.invert)
bitwise_not = invert
left_shift = scalar_elemwise(ps.left_shift)
right_shift = scalar_elemwise(ps.right_shift)
switch = scalar_elemwise(ps.switch)
_clip_elemwise = scalar_elemwise(ps.clip)


def clip(x, min, max):
    """Clip x to [min, max].  Complex operands are unordered and rejected
    (PyTensor's tensor/math.py clip via scalar comparison dtype rules)."""
    args = [as_tensor_variable(a) for a in (x, min, max)]
    if builtins.any(a.type.dtype.startswith("complex") for a in args):
        raise TypeError("clip is not defined for complex operands")
    return _clip_elemwise(*args)


second = scalar_elemwise(ps.second)
conj = scalar_elemwise(ps.conj)
real = scalar_elemwise(ps.real)
imag = scalar_elemwise(ps.imag)
angle = scalar_elemwise(ps.angle)
complex = scalar_elemwise(ps.complex_op)
# special functions (scalar/math.py)
erf = scalar_elemwise(psm.erf)
erfc = scalar_elemwise(psm.erfc)
erfinv = scalar_elemwise(psm.erfinv)
erfcinv = scalar_elemwise(psm.erfcinv)
erfcx = scalar_elemwise(psm.erfcx)
gamma = scalar_elemwise(psm.gamma)
gammaln = scalar_elemwise(psm.gammaln)
psi = scalar_elemwise(psm.psi)
digamma = psi
tri_gamma = scalar_elemwise(psm.tri_gamma)
polygamma = scalar_elemwise(psm.polygamma)
gammainc = scalar_elemwise(psm.gammainc)
gammaincc = scalar_elemwise(psm.gammaincc)
gammau = scalar_elemwise(psm.gammau)
gammal = scalar_elemwise(psm.gammal)
gammaincinv = scalar_elemwise(psm.gammaincinv)
gammainccinv = scalar_elemwise(psm.gammainccinv)
betainc = scalar_elemwise(psm.betainc)
betaincinv = scalar_elemwise(psm.betaincinv)
betaln = scalar_elemwise(psm.betaln)
sigmoid = scalar_elemwise(psm.sigmoid)
expit = sigmoid
softplus = scalar_elemwise(psm.softplus)
log1pexp = softplus
log1mexp = scalar_elemwise(psm.log1mexp)
logit = scalar_elemwise(psm.logit)
iv = scalar_elemwise(psm.iv)
ive = scalar_elemwise(psm.ive)
jv = scalar_elemwise(psm.jv)
yv = scalar_elemwise(psm.yv)
kve = scalar_elemwise(psm.kve)
kv = scalar_elemwise(psm.kv)
kn = kv
owens_t = scalar_elemwise(psm.owens_t)
ndtri_exp = scalar_elemwise(psm.ndtri_exp)
chi2sf = scalar_elemwise(psm.chi2sf)
i0 = scalar_elemwise(psm.i0)
i1 = scalar_elemwise(psm.i1)
j0 = scalar_elemwise(psm.j0)
j1 = scalar_elemwise(psm.j1)
hyp2f1 = scalar_elemwise(psm.hyp2f1)
ndtr = scalar_elemwise(psm.ndtr)
ndtri = scalar_elemwise(psm.ndtri)
# the shape-parameter gradient ops raise NotImplementedError: ROADMAP.md
# Queue 1 item 10b
betainc_dda = psm.betainc_dda
betainc_ddb = psm.betainc_ddb
gammainc_ddk = psm.gammainc_ddk
gammaincc_ddk = psm.gammaincc_ddk
hyp2f1_dda = psm.hyp2f1_dda
hyp2f1_ddb = psm.hyp2f1_ddb
hyp2f1_ddc = psm.hyp2f1_ddc


def round(x, mode=None):
    """round(x) with mode in {half_to_even (default), half_away_from_zero}
    (PyTensor's tensor/math.py:1639)."""
    if mode is None or mode == "half_to_even":
        return round_half_to_even(x)
    if mode == "half_away_from_zero":
        return round_half_away_from_zero(x)
    raise ValueError(f"round mode must be 'half_to_even' or "
                     f"'half_away_from_zero', got {mode!r}")


def iround(x, mode=None):
    """cast(round(x, mode), 'int64') (PyTensor's tensor/math.py:1634)."""
    return cast(round(x, mode), "int64")


def isclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    a, b = as_tensor_variable(a), as_tensor_variable(b)
    close = le(abs(a - b), atol + rtol * abs(b))
    both_nan = and_(isnan(a), isnan(b)) if equal_nan else None
    finite = and_(close, and_(neq(isinf(a), True), neq(isinf(b), True)))
    same_inf = and_(isinf(a), and_(isinf(b), eq(sign(a), sign(b))))
    res = or_(finite, same_inf)
    if both_nan is not None:
        res = or_(res, both_nan)
    return res


def allclose(a, b, rtol=1e-5, atol=1e-8, equal_nan=False):
    return all(isclose(a, b, rtol, atol, equal_nan))


def power(x, y):
    return pow(x, y)


def divmod(x, y):
    return int_div(x, y), mod(x, y)


def logaddexp(x, y):
    x, y = as_tensor_variable(x), as_tensor_variable(y)
    m = maximum(x, y)
    return m + log1p(exp(-abs(x - y)))


def logsumexp(x, axis=None, keepdims=False):
    x = as_tensor_variable(x)
    m = max(x, axis=axis, keepdims=True)
    m_stop = switch(isinf(abs(m)), zeros_like_f(m), m)
    res = log(sum(exp(x - m_stop), axis=axis, keepdims=True)) + m_stop
    if not keepdims:
        res = _drop_axes(res, axis, x.type.ndim)
    return res


def zeros_like_f(x):
    return tb.zeros_like(x)


def _drop_axes(res, axis, ndim):
    axis = _as_axis_tuple(axis)
    if axis is None:
        axis = tuple(builtins.range(ndim))
    axis = tuple(a % ndim for a in axis)
    keep = [d for d in builtins.range(ndim) if d not in axis]
    order = []
    j = 0
    pattern = []
    for d in builtins.range(ndim):
        if d not in axis:
            pattern.append(d)
    return DimShuffle(ndim, pattern)(res)


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


def prod(x, axis=None, dtype=None, keepdims=False, acc_dtype=None, no_zeros_in_input=False):
    return _reduce(lambda a, **k: Prod(a, dtype=dtype, acc_dtype=acc_dtype), x, axis, keepdims)


def max(x, axis=None, keepdims=False):
    return _reduce(lambda a, **k: Max(a), x, axis, keepdims)


def min(x, axis=None, keepdims=False):
    return _reduce(lambda a, **k: Min(a), x, axis, keepdims)


def all(x, axis=None, keepdims=False):
    from pytensor_tpu_torch.tensor.elemwise import All

    x = as_tensor_variable(x)
    if x.type.dtype != "bool":
        x = neq(x, 0)
    return _reduce(lambda a, **k: All(a), x, axis, keepdims)


def any(x, axis=None, keepdims=False):
    from pytensor_tpu_torch.tensor.elemwise import Any

    x = as_tensor_variable(x)
    if x.type.dtype != "bool":
        x = neq(x, 0)
    return _reduce(lambda a, **k: Any(a), x, axis, keepdims)


def mean(x, axis=None, dtype=None, keepdims=False, acc_dtype=None):
    x = as_tensor_variable(x)
    s = sum(x, axis=axis, dtype=dtype, keepdims=keepdims, acc_dtype=acc_dtype)
    from pytensor_tpu_torch.tensor.shape import shape

    if axis is None:
        n = x.size
    else:
        ax = _as_axis_tuple(axis)
        n = constant(np.int64(1))
        shp = shape(x)
        for a in ax:
            n = n * shp[a % x.type.ndim]
    res_dtype = s.type.dtype
    if res_dtype in discrete_dtypes:
        # PyTensor's semantics: mean of discrete inputs is float64
        # (gradient.py/math.py mean), independent of floatX
        res_dtype = "float64"
        s = cast(s, res_dtype)
    return s / cast(n, res_dtype)


def var(x, axis=None, ddof=0, keepdims=False, corrected=False):
    x = as_tensor_variable(x)
    m = mean(x, axis=axis, keepdims=True)
    sq = sqr(x - m)
    out = mean(sq, axis=axis, keepdims=keepdims)
    if ddof:
        from pytensor_tpu_torch.tensor.shape import shape

        if axis is None:
            n = x.size
        else:
            ax = _as_axis_tuple(axis)
            n = constant(np.int64(1))
            shp = shape(x)
            for a in ax:
                n = n * shp[a % x.type.ndim]
        n = cast(n, out.type.dtype)
        out = out * n / (n - ddof)
    return out


def std(x, axis=None, ddof=0, keepdims=False):
    return sqrt(var(x, axis=axis, ddof=ddof, keepdims=keepdims))


def ptp(x, axis=None):
    return max(x, axis=axis) - min(x, axis=axis)


class Argmax(Op):
    """Index of the maximum along given axes (PyTensor's Argmax:142)."""

    __props__ = ("axis",)

    def __init__(self, axis=None):
        # axis order is irrelevant to which element is the max; sort so
        # the flat index matches numpy's C-order raveling of the reduced
        # block (PyTensor's normalizes via check_and_normalize_axes)
        self.axis = None if axis is None else tuple(sorted(int(a) for a in axis))

    def make_node(self, x):
        x = as_tensor_variable(x)
        if self.axis is None:
            out_shape = ()
        else:
            for a in self.axis:
                if not (-x.type.ndim <= a < x.type.ndim):
                    # silently wrapping (a % ndim) would reduce the WRONG
                    # axis — numpy raises AxisError here
                    raise ValueError(
                        f"argmax axis {a} out of range for "
                        f"{x.type.ndim}-d input")
            axes = tuple(sorted(a % x.type.ndim for a in self.axis))
            if axes != self.axis:
                # resolve negative axes into a canonical instance
                return Argmax(axes).make_node(x)
            out_shape = tuple(s for d, s in enumerate(x.type.shape) if d not in axes)
        return Apply(self, [x], [TensorType("int64", out_shape)()])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        if self.axis is None:
            output_storage[0][0] = np.asarray(np.argmax(x), dtype="int64")
            return
        axes = tuple(a % x.ndim for a in self.axis)
        if len(axes) == 1:
            output_storage[0][0] = np.asarray(np.argmax(x, axis=axes[0]), dtype="int64")
            return
        keep = [d for d in builtins.range(x.ndim) if d not in axes]
        perm = keep + list(axes)
        xt = np.transpose(x, perm)
        newshape = xt.shape[: len(keep)] + (-1,)
        output_storage[0][0] = np.asarray(
            np.argmax(xt.reshape(newshape), axis=-1), dtype="int64"
        )

    def infer_shape(self, fgraph, node, input_shapes):
        (ishp,) = input_shapes
        if self.axis is None:
            return [()]
        axes = tuple(a % node.inputs[0].type.ndim for a in self.axis)
        return [tuple(s for d, s in enumerate(ishp) if d not in axes)]

    def L_op(self, inputs, outputs, output_grads):
        # indices are piecewise-constant in x: the gradient is defined
        # and identically zero (PyTensor's Argmax.grad returns
        # x.zeros_like(), not a disconnected type)
        from pytensor_tpu_torch.tensor.basic import zeros_like

        return [zeros_like(inputs[0])]


def argmax(x, axis=None, keepdims=False):
    x = as_tensor_variable(x)
    axis = _as_axis_tuple(axis)
    res = Argmax(axis)(x)
    if keepdims:
        full_axis = tuple(a % x.type.ndim for a in axis) if axis is not None else tuple(
            builtins.range(x.type.ndim)
        )
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


def argmin(x, axis=None, keepdims=False):
    x = as_tensor_variable(x)
    dt = x.type.dtype
    if dt in uint_dtypes:
        # -x wraps for unsigned: 0 -> 0 would no longer be the extremum.
        # Use the order-reversing itype.max - x instead (PyTensor's
        # argmin, tensor/math.py:557)
        itype = np.iinfo(np.dtype(dt))
        top = constant(np.asarray(itype.max, dtype=dt))
        return argmax(top - x, axis=axis, keepdims=keepdims)
    if dt == "bool":
        return argmax(invert(x), axis=axis, keepdims=keepdims)
    return argmax(-x, axis=axis, keepdims=keepdims)


def max_and_argmax(x, axis=None, keepdims=False):
    return max(x, axis, keepdims), argmax(x, axis, keepdims)


# --- dot products ------------------------------------------------------------

class Dot(Op):
    """Matrix/vector product of 1-d/2-d operands (PyTensor's Dot:3041)."""

    __props__ = ()

    def make_node(self, x, y):
        x, y = as_tensor_variable(x), as_tensor_variable(y)
        if x.type.ndim not in (1, 2) or y.type.ndim not in (1, 2):
            raise TypeError(
                f"Dot supports 1-d/2-d operands, got {x.type.ndim}-d and {y.type.ndim}-d; "
                "use matmul/tensordot for higher dims"
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

    def infer_shape(self, fgraph, node, input_shapes):
        xshp, yshp = input_shapes
        x, y = node.inputs
        if x.type.ndim == 1 and y.type.ndim == 1:
            return [()]
        if x.type.ndim == 2 and y.type.ndim == 1:
            return [(xshp[0],)]
        if x.type.ndim == 1 and y.type.ndim == 2:
            return [(yshp[1],)]
        return [(xshp[0], yshp[1])]

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

    def R_op(self, inputs, eval_points):
        x, y = inputs
        dx, dy = eval_points
        terms = []
        if dx is not None:
            terms.append(dot(dx, y))
        if dy is not None:
            terms.append(dot(x, dy))
        if not terms:
            return [None]
        res = terms[0]
        for t in terms[1:]:
            res = res + t
        return [res]


_dot = Dot()


def dot(x, y):
    x, y = as_tensor_variable(x), as_tensor_variable(y)
    if x.type.ndim == 0 or y.type.ndim == 0:
        return x * y
    if x.type.ndim > 2 or y.type.ndim > 2:
        return tensordot(x, y, axes=[[x.type.ndim - 1], [builtins.max(0, y.type.ndim - 2)]])
    return _dot(x, y)


def matmul(x, y, dtype=None):
    x, y = as_tensor_variable(x), as_tensor_variable(y)
    if x.type.ndim == 0 or y.type.ndim == 0:
        raise ValueError("matmul operands cannot be scalar")
    if dtype is not None:
        x, y = cast(x, dtype), cast(y, dtype)
    if x.type.ndim <= 2 and y.type.ndim <= 2:
        return _dot(x, y)
    # batched: Blockwise over the core 2-d dot
    from pytensor_tpu_torch.tensor.blockwise import Blockwise

    x_ = x if x.type.ndim >= 2 else tb.shape_padleft(x)
    y_ = y if y.type.ndim >= 2 else tb.shape_padright(y)
    out = Blockwise(_dot, signature="(m,k),(k,n)->(m,n)")(x_, y_)
    if x.type.ndim == 1:
        out = out[..., 0, :]
    if y.type.ndim == 1:
        out = out[..., 0]
    return out


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


def vecdot(x, y, dtype=None):
    """Dot over the last axis, batch dims broadcast (PyTensor's vecdot)."""
    x, y = as_tensor_variable(x), as_tensor_variable(y)
    out = sum(x * y, axis=-1)
    return cast(out, dtype) if dtype is not None else out


def vecmat(v, m, dtype=None):
    """v (..., k) @ m (..., k, n) -> (..., n): the last axis of ``v`` is a
    vector even when v is batched (np.vecmat semantics, unlike matmul
    which would treat a 2-d v as a matrix)."""
    v, m = as_tensor_variable(v), as_tensor_variable(m)
    out = matmul(tb.expand_dims(v, -2), m)[..., 0, :]
    return cast(out, dtype) if dtype is not None else out


def matvec(m, v, dtype=None):
    """m (..., r, k) @ v (..., k) -> (..., r) (np.matvec semantics)."""
    m, v = as_tensor_variable(m), as_tensor_variable(v)
    out = matmul(m, tb.expand_dims(v, -1))[..., 0]
    return cast(out, dtype) if dtype is not None else out


def dense_dot(x, y):
    return dot(x, y)


def norm(x, L=2, axis=None, keepdims=False):
    x = as_tensor_variable(x)
    if L == 1:
        return sum(abs(x), axis=axis, keepdims=keepdims)
    if L == 2:
        return sqrt(sum(sqr(x), axis=axis, keepdims=keepdims))
    if L == np.inf or L == "inf":
        return max(abs(x), axis=axis, keepdims=keepdims)
    return pow(sum(pow(abs(x), L), axis=axis, keepdims=keepdims), 1.0 / L)


def smallest(*args):
    res = args[0]
    for a in args[1:]:
        res = minimum(res, a)
    return res


def largest(*args):
    res = args[0]
    for a in args[1:]:
        res = maximum(res, a)
    return res


def cov(m, y=None, rowvar=True, bias=False, ddof=None):
    m = as_tensor_variable(m)
    if m.type.ndim != 2:
        raise ValueError("cov expects a matrix")
    if y is not None:
        m = tb.concatenate([m, as_tensor_variable(y)], axis=0 if rowvar else 1)
    if not rowvar:
        m = tb.matrix_transpose(m)
    avg = mean(m, axis=1, keepdims=True)
    xm = m - avg
    from pytensor_tpu_torch.tensor.shape import shape

    fact = shape(m)[1] - (1 if (ddof is None and not bias) else (ddof or 0))
    return dot(xm, tb.matrix_transpose(xm)) / cast(fact, m.type.dtype)


# names re-exported for wrappers
floor_divide = int_div
true_divide = true_div
not_equal = neq
equal = eq
greater = gt
greater_equal = ge
less = lt
less_equal = le
absolute = abs


def xlogx(x):
    """x * log(x) with 0 log 0 := 0 (PyTensor's tensor/xlogx.py)."""
    x = as_tensor_variable(x)
    return switch(eq(x, 0.0), zeros_like_f(cast(x, config.floatX) if x.type.dtype
                                           in discrete_dtypes else x),
                  x * log(x))


def xlogy0(x, y):
    """x * log(y) with x == 0 forcing 0."""
    x, y = as_tensor_variable(x), as_tensor_variable(y)
    return switch(eq(x, 0.0), zeros_like_f(x * y), x * log(y))


def prod_without_zeros(x, axis=None, keepdims=False):
    """Product of the nonzero elements (PyTensor's ProdWithoutZeros:3816)."""
    x = as_tensor_variable(x)
    from pytensor_tpu_torch.tensor.basic import ones_like

    safe = switch(eq(x, 0.0), ones_like(x), x)
    return prod(safe, axis=axis, keepdims=keepdims)


def permute_row_elements(x, y, inverse=False):
    """Permute the elements of each row of x by the index rows of y
    (PyTensor's PermuteRowElements:3426); broadcasts on leading dims."""
    from pytensor_tpu_torch.tensor.subtensor import take_along_axis

    x = as_tensor_variable(x)
    y = cast(as_tensor_variable(y), "int64")
    if inverse:
        # argsort lives in tensor/sort.py, which the port has not yet
        raise NotImplementedError("permute_row_elements(inverse=True) needs argsort")
    if x.type.ndim == 1 and y.type.ndim == 1:
        return x[y]
    # broadcast x and y to a common shape, then gather along the last axis
    xb = second(y, x) if x.type.ndim < y.type.ndim else x
    yb = cast(second(x, cast(y, x.type.dtype)), "int64") \
        if y.type.ndim < x.type.ndim else y
    return take_along_axis(xb, yb, axis=-1)


def choose(a, choices, mode="raise"):
    """np.choose: a indexes into the stack of choices elementwise.

    ``mode`` follows numpy: 'raise' (out-of-range indices error on the
    oracle, and the torch lowering raises too), 'clip', or 'wrap'.
    """
    from pytensor_tpu_torch.tensor.basic import stack
    from pytensor_tpu_torch.tensor.subtensor import take_along_axis
    from pytensor_tpu_torch.tensor.basic import expand_dims

    a = as_tensor_variable(a)
    if a.type.dtype not in ("bool",) and not a.type.dtype.startswith(
            ("int", "uint")):
        raise TypeError("choose index argument must be an integer tensor")
    a = cast(a, "int64")
    if isinstance(choices, (list, tuple)):
        ch = stack(list(choices), axis=0)
    else:
        ch = as_tensor_variable(choices)
    n = ch.shape[0]
    if mode == "clip":
        a = clip(a, 0, n - 1)
    elif mode == "wrap":
        a = mod(a, n)
    elif mode != "raise":
        raise ValueError(f"invalid choose mode: {mode!r}")
    # gather along axis 0 of ch with index a (broadcast over the rest)
    idx = expand_dims(a, 0)
    res = take_along_axis(ch, second(ch, cast(idx, ch.dtype)).astype("int64")
                          if idx.type.ndim < ch.type.ndim else idx, axis=0)
    return res[0]

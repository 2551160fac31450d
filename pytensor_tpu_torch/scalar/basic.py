"""Scalar op descriptors: the element-wise kernel table.

Counterpart of ``pytensor_tpu/scalar/basic.py`` (PyTensor's
scalar/basic.py ScalarOp:1151), the complex ones (``real``, ``imag``,
``conj``, ``angle``, ``complex``) included.  Each descriptor carries a numpy implementation (what
constant folding evaluates, and the JAX package's oracle), a torch
implementation (what the linker and the plain versions of the kernels
call; where torch and numpy differ, as at an integer divisor of 0 or the
sign of a zero remainder, it gives numpy's value) and its gradient rule,
written against tensor-level graph constructors.  The
kernels emit CUDA C++ from the op's ``name`` (``link/cuda/cexpr.py``):
the fused elementwise kernel (``tensor/fused_kernel.py``) and the
whole-loop scan kernel (``link/cuda/scan_kernel.py``).
"""

from __future__ import annotations

import builtins
from typing import Callable

import numpy as np
import torch

from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.utils import MetaObject, dtype_kind, np_dtype

discrete_kinds = "biu"
int_types = ("int8", "int16", "int32", "int64")


def upcast(*dtypes: str) -> str:
    """numpy dtype promotion over dtype names, bfloat16 by the JAX
    package's rule (its scalar/basic.py:23-54): with a discrete dtype it
    stays bfloat16, with float16 or float32 it is float32, with float64
    float64."""
    dtypes = [str(d) for d in dtypes]
    rest = [d for d in dtypes if d != "bfloat16"]
    if not rest:
        return "bfloat16"
    out = str(np.result_type(*rest))
    if len(rest) == len(dtypes):
        return out
    if out == "float16":
        return "float32"
    return "bfloat16" if np.dtype(out).kind in discrete_kinds else out


def upcast_float(*dtypes: str) -> str:
    out = upcast(*dtypes)
    if dtype_kind(out) in discrete_kinds:
        # discrete inputs promote to the smallest float that holds them
        # (bool/int8/int16 -> float32, int32/int64 -> float64)
        return str(np.promote_types(np.dtype(out), np.float32))
    return out


def real_dtype(dtype: str) -> str:
    """The dtype of a complex dtype's parts; any other dtype is its own."""
    return {"complex64": "float32", "complex128": "float64"}.get(str(dtype), str(dtype))


def _dg():
    """Lazy import of gradient helpers (avoids circular imports)."""
    from pytensor_tpu_torch import gradient

    return gradient


def _tm():
    from pytensor_tpu_torch.tensor import math as tm

    return tm


class ScalarOp(MetaObject):
    """Descriptor of an elementwise scalar kernel.

    name         unique identifier (defines op equality)
    nin          arity; -1 = variadic (add/mul)
    np_fn        numpy implementation (constant folding)
    torch_fn     torch implementation (linker, plain fused path)
    grad_fn      (inputs, outputs, output_grads) -> list of input grads
    dtype_rule   'upcast' | 'float' | callable(*dtypes)
    float_inputs the op takes float inputs only: a graph may hold it on
                 other inputs, and linking such a node raises TypeError
    refused      dtypes the JAX package's lowering refuses, refused so too
    special      a special function of ``scalar/math.py``: on a CUDA device
                 its Elemwise runs as a one-node K1 launch, never the
                 plain torch version (``link/torch/dispatch.py``)
    on_host      the op runs scipy on the host, as the JAX package's
                 ``pure_callback`` lowering does (its Elemwise lowering
                 declares ``reads_back``)
    """

    __props__ = ("name",)

    def __init__(self, name: str, nin: int, np_fn: Callable, torch_fn: Callable,
                 grad_fn: Callable | None = None, dtype_rule="upcast",
                 identity=None, commutative: bool = False, float_inputs: bool = False,
                 special: bool = False, on_host: bool = False, refused=()):
        self.name = name
        self.float_inputs = float_inputs
        self.refused = tuple(refused)
        self.special = special
        self.on_host = on_host
        self.nin = nin
        self.nout = 1
        self.np_fn = np_fn
        self.torch_fn = torch_fn
        self.grad_fn = grad_fn
        self.dtype_rule = dtype_rule
        self.identity = identity
        self.commutative = commutative

    def output_dtype(self, *input_dtypes: str) -> str:
        rule = self.dtype_rule
        if callable(rule):
            return rule(*input_dtypes)
        if rule == "upcast":
            return upcast(*input_dtypes)
        if rule == "float":
            return upcast_float(*input_dtypes)
        if rule == "bool":
            return "bool"
        if rule == "first":
            return str(input_dtypes[0])
        raise ValueError(f"unknown dtype rule {rule}")

    def compute_dtypes(self, input_dtypes, out_dtype) -> list:
        """The dtype each operand is cast to before the op, numpy's rule
        of computing in the promoted dtype: the output's, except for a
        cast and ``second`` (the operands as they are), an op with a bool
        result (the operands' common dtype: a comparison compares the
        values) and ``switch``'s condition (kept).  The plain lowering,
        K1 and K2 all take this rule."""
        input_dtypes = [str(d) for d in input_dtypes]
        if self.name == "second" or self.name.startswith("cast{"):
            return input_dtypes
        if self.name == "complex":
            # the two parts in the output's real dtype
            return [real_dtype(out_dtype)] * 2
        if dtype_kind(out_dtype) != "c" and any(dtype_kind(d) == "c" for d in input_dtypes):
            # a real result of complex operands (real, imag, angle, abs, a
            # comparison): the operands' common dtype
            return [upcast(*input_dtypes)] * len(input_dtypes)
        if out_dtype == "bool":
            return [upcast(*input_dtypes)] * len(input_dtypes)
        if self.name == "switch":
            return [input_dtypes[0], out_dtype, out_dtype]
        return [out_dtype] * len(input_dtypes)

    def check_inputs(self, *input_dtypes: str):
        """Raise TypeError where the op refuses an input dtype (the JAX
        package's lowering raises it when the function is first run)."""
        for d in input_dtypes:
            if self.float_inputs and dtype_kind(d) != "f":
                raise TypeError(f"{self.name} does not accept dtype {d}; it takes floats")
            if str(d) in self.refused:
                raise TypeError(f"{self.name} does not accept dtype {d}")

    def impl(self, *args):
        return self.np_fn(*args)

    def grad(self, inputs, outputs, output_grads):
        if self.grad_fn is None:
            return [_dg().grad_not_implemented(self, i, inp)
                    for i, inp in enumerate(inputs)]
        return self.grad_fn(inputs, outputs, output_grads)

    def __str__(self):
        return self.name

    def __call__(self, *inputs):
        """Apply at the tensor level (scalar ops act through Elemwise)."""
        from pytensor_tpu_torch.tensor.elemwise import Elemwise

        return Elemwise(self)(*inputs)


_registry: dict[str, ScalarOp] = {}


def _op(name, nin, np_fn, torch_fn, grad_fn=None, **kw) -> ScalarOp:
    op = ScalarOp(name, nin, np_fn, torch_fn, grad_fn, **kw)
    _registry[name] = op
    return op


def _fold(fn, args):
    acc = args[0]
    for x in args[1:]:
        acc = fn(acc, x)
    return acc


# ---------------------------------------------------------------------------
# arithmetic
# ---------------------------------------------------------------------------

add = _op(
    "add", -1,
    lambda *a: np.add.reduce(np.broadcast_arrays(*a)) if len(a) > 2 else np.add(*a),
    lambda *a: _fold(torch.add, a),
    lambda i, o, gz: [gz[0]] * len(i),
    identity=0, commutative=True,
)


def _mul_grad(i, o, gz):
    grads = []
    for k in range(len(i)):
        g = gz[0]
        for j, x in enumerate(i):
            if j != k:
                g = g * x
        grads.append(g)
    return grads


mul = _op(
    "mul", -1,
    lambda *a: np.multiply.reduce(np.broadcast_arrays(*a)) if len(a) > 2 else np.multiply(*a),
    lambda *a: _fold(torch.mul, a),
    _mul_grad, identity=1, commutative=True,
)

def _by_parts(fn, parts):
    """``fn``, or for complex operands ``parts`` of their real and
    imaginary parts: numpy's signs of zero (torch's complex neg and sub
    give +0.0 where numpy gives -0.0)."""
    def by_parts(*a):
        if not any(x.is_complex() for x in a):
            return fn(*a)
        a = [x if x.is_complex() else torch.complex(x, torch.zeros_like(x)) for x in a]
        return torch.complex(parts(*(x.real for x in a)), parts(*(x.imag for x in a)))

    return by_parts


sub = _op("sub", 2, np.subtract, _by_parts(torch.sub, torch.sub),
          lambda i, o, gz: [gz[0], -gz[0]])


def _true_div_grad(i, o, gz):
    x, y = i
    return [gz[0] / y, -gz[0] * x / (y * y)]


def _true_div_dtype(a, b):
    # integer / integer divides at floatX, not numpy's float64
    if dtype_kind(upcast(a, b)) in discrete_kinds:
        return config.floatX
    return upcast_float(a, b)


true_div = _op("true_div", 2, np.true_divide, torch.true_divide,
               _true_div_grad, dtype_rule=_true_div_dtype)


def _pow_grad(i, o, gz):
    tm = _tm()
    x, y = i
    return [gz[0] * y * x ** (y - 1), gz[0] * o[0] * tm.log(x)]


pow = _op("pow", 2, np.power, torch.pow, _pow_grad)
neg = _op("neg", 1, np.negative, _by_parts(torch.neg, torch.neg), lambda i, o, gz: [-gz[0]])


def _bool_identity(fn):
    """``fn``, or for a bool tensor a copy of it: abs and sqr of a bool are
    the bool, as the graph's type says and the JAX package gives (torch's
    abs refuses bool, and its square gives int64)."""
    return lambda a: a.clone() if a.dtype == torch.bool else fn(a)


# abs of a complex is its modulus, a real: numpy's dtype (and PyTensor's);
# the JAX package types it complex (ROADMAP Queue 3)
abs = _op("abs", 1, np.abs, _bool_identity(torch.abs),
          lambda i, o, gz: [gz[0] * _tm().sign(i[0])], dtype_rule=lambda a: real_dtype(a))


def _sign(a):
    """jnp.sign's values: a float zero keeps its sign and NaN stays NaN
    (torch.sign gives +0.0 for both); a complex z is z / |z|."""
    if a.is_complex():
        return torch.sgn(a)
    if not a.is_floating_point():
        return torch.sign(a)
    return torch.where((a == 0) | a.isnan(), a, torch.sign(a))


sign = _op("sign", 1, np.sign, _sign, lambda i, o, gz: [_zero_like(i[0])])
sqr = _op("sqr", 1, np.square, _bool_identity(torch.square),
          lambda i, o, gz: [gz[0] * 2 * i[0]])
sqrt = _op("sqrt", 1, np.sqrt, torch.sqrt,
           lambda i, o, gz: [gz[0] / (2 * o[0])], dtype_rule="float")
reciprocal = _op("reciprocal", 1, np.reciprocal, torch.reciprocal,
                 lambda i, o, gz: [-gz[0] * o[0] * o[0]], dtype_rule="float")
exp = _op("exp", 1, np.exp, torch.exp,
          lambda i, o, gz: [gz[0] * o[0]], dtype_rule="float")
def _log(a):
    """torch.log; of a complex tensor numpy's ``npy_clog``, ``log1p`` near
    the unit circle (torch's takes ``log(|z|)``, which cancels there)."""
    if not a.is_complex():
        return torch.log(a)
    ax, ay = a.real.abs(), a.imag.abs()
    h = torch.hypot(ax, ay)
    am, an = torch.maximum(ax, ay), torch.minimum(ax, ay)
    near = (h >= 0.71) & (h <= 1.73)
    rr = torch.where(near, torch.log1p((am - 1) * (am + 1) + an * an) / 2, torch.log(h))
    return torch.complex(rr, torch.atan2(a.imag, a.real))


log = _op("log", 1, np.log, _log, lambda i, o, gz: [gz[0] / i[0]], dtype_rule="float")
sin = _op("sin", 1, np.sin, torch.sin,
          lambda i, o, gz: [gz[0] * _tm().cos(i[0])], dtype_rule="float")
cos = _op("cos", 1, np.cos, torch.cos,
          lambda i, o, gz: [-gz[0] * _tm().sin(i[0])], dtype_rule="float")
tanh = _op("tanh", 1, np.tanh, torch.tanh,
           lambda i, o, gz: [gz[0] * (1 - o[0] * o[0])], dtype_rule="float")


def _zero_like(x):
    return x.zeros_like(dtype=config.floatX) if _is_discrete(x) else x.zeros_like()


def _lexicographic(fn, strict):
    """``fn`` of real tensors; of complex ones numpy's order, the real
    parts first (by ``strict``, the strict form of ``fn``) and the
    imaginary parts where those are equal (torch's comparisons refuse
    complex tensors)."""
    def compare(a, b):
        if not (a.is_complex() or b.is_complex()):
            return fn(a, b)
        return strict(a.real, b.real) | ((a.real == b.real) & fn(a.imag, b.imag))

    return compare


def _complex_maximum(fn, pick):
    """numpy's maximum (``pick=torch.gt``) or minimum (``torch.lt``) of
    complex operands: the operand first in that order, NaN from either."""
    def extreme(a, b):
        if not (a.is_complex() or b.is_complex()):
            return fn(a, b)
        a, b = torch.broadcast_tensors(a, b)
        first = _lexicographic(pick, pick)(a, b) | (a == b) | a.isnan()
        return torch.where(first & ~b.isnan(), a, b)

    return extreme


# comparisons -> bool
lt = _op("lt", 2, np.less, _lexicographic(torch.lt, torch.lt),
         lambda i, o, gz: [_zero_like(i[0]), _zero_like(i[1])], dtype_rule=lambda a, b: "bool")
ge = _op("ge", 2, np.greater_equal, _lexicographic(torch.ge, torch.gt),
         lambda i, o, gz: [_zero_like(i[0]), _zero_like(i[1])], dtype_rule=lambda a, b: "bool")
eq = _op("eq", 2, np.equal, torch.eq,
         lambda i, o, gz: [_zero_like(i[0]), _zero_like(i[1])], dtype_rule=lambda a, b: "bool",
         commutative=True)


def _maximum_grad(i, o, gz):
    tm = _tm()
    x, y = i
    gx = gz[0] * tm.cast(tm.ge(x, y), gz[0].dtype)
    gy = gz[0] * tm.cast(tm.lt(x, y), gz[0].dtype)
    return [gx, gy]


maximum = _op("maximum", 2, np.maximum, _complex_maximum(torch.maximum, torch.gt), _maximum_grad,
              commutative=True)


def _second_grad(i, o, gz):
    from pytensor_tpu_torch.graph.null_type import DisconnectedType

    return [DisconnectedType()(), gz[0]]


def _second_torch(a, b):
    shape = torch.broadcast_shapes(a.shape, b.shape)
    if b.device != a.device and b.device.type == "cpu" and b.numel() == 1:
        # a value from the host (a shape, cast) filled on the model's device:
        # no copy to the device, and a capture records the fill
        return torch.full(shape, b.item(), dtype=b.dtype, device=a.device)
    return torch.broadcast_to(b, shape)


# second(a, b) = broadcast b to the shape of the pair: the "fill" primitive
second = _op(
    "second", 2,
    lambda a, b: np.broadcast_arrays(a, b)[1].copy(),
    _second_torch, _second_grad,
    dtype_rule=lambda a, b: str(b),
)

identity = _op("identity", 1, lambda a: a, lambda a: a.clone(), lambda i, o, gz: [gz[0]],
               dtype_rule="first")


# ---------------------------------------------------------------------------
# integer and rounding arithmetic
# ---------------------------------------------------------------------------

def _zero_guard(fn):
    """``fn`` with numpy's result for an integer divisor of 0, which is 0
    (torch raises on the CPU, and C's ``/`` and ``%`` are undefined there);
    a float divisor of 0 gives torch's value, which is numpy's."""
    def guarded(a, b):
        if a.is_floating_point():
            return fn(a, b)
        zero = b == 0
        return torch.where(zero, torch.zeros_like(a), fn(a, torch.where(zero, torch.ones_like(b), b)))

    return guarded


int_div = _op("int_div", 2, np.floor_divide, _zero_guard(torch.floor_divide),
              lambda i, o, gz: [_zero_like(i[0]), _zero_like(i[1])])


def _mod_grad(i, o, gz):
    # d(x mod y)/dx = 1 ; d/dy = -floor(x/y)
    return [gz[0], -gz[0] * _tm().floor(i[0] / i[1])]


def _remainder(a, b):
    """numpy's mod: a zero remainder takes the divisor's sign (torch's
    keeps the dividend's)."""
    r = torch.remainder(a, b)
    if not r.is_floating_point():
        return r
    return torch.where(r == 0, torch.copysign(torch.zeros_like(r), b), r)


mod = _op("mod", 2, np.mod, _zero_guard(_remainder), _mod_grad)


def _float_only_fn(fn):
    """``fn`` on a float tensor; an integer or bool tensor (whose rounding
    is itself) is copied."""
    return lambda a: fn(a) if a.is_floating_point() else a.clone()


def _zero_grad(i, o, gz):
    return [_zero_like(i[0])]


ceil = _op("ceil", 1, np.ceil, torch.ceil, _zero_grad, dtype_rule="float")
floor = _op("floor", 1, np.floor, torch.floor, _zero_grad, dtype_rule="float")
trunc = _op("trunc", 1, np.trunc, torch.trunc, _zero_grad, dtype_rule="float")
round_half_to_even = _op("round_half_to_even", 1, np.round, _float_only_fn(torch.round),
                         _zero_grad)


def _np_round_away(a):
    return np.copysign(np.floor(np.abs(a) + 0.5), a)


# the JAX package's numpy oracle: copysign(floor(|a| + 0.5), a), so
# 0.49999997f rounds to 1 (C's roundf gives 0)
round_half_away_from_zero = _op(
    "round_half_away_from_zero", 1, _np_round_away,
    _float_only_fn(lambda a: torch.copysign(torch.floor(torch.abs(a) + 0.5), a)),
    _zero_grad)

# ---------------------------------------------------------------------------
# exponentials, logarithms, angles
# ---------------------------------------------------------------------------

_LOG2, _LOG10 = float(np.log(2)), float(np.log(10))
# numpy's constants: float32 deg2rad multiplies by float32(pi / 180), and
# rad2deg by float32(180) / float32(pi), not by float32(180 / pi)
_DEG2RAD = {"float32": np.float32(np.pi / 180), "float64": np.pi / 180}
_RAD2DEG = {"float32": np.float32(180) / np.float32(np.pi), "float64": 180 / np.pi}
# bfloat16 multiplies by the constant rounded to bfloat16, as jnp's
# deg2rad and rad2deg do
_DEG2RAD["bfloat16"] = np_dtype("bfloat16").type(np.pi / 180)
_RAD2DEG["bfloat16"] = np_dtype("bfloat16").type(180 / np.pi)


def _angle_fn(table):
    def fn(a):
        return a * float(table[str(a.dtype).removeprefix("torch.")])

    return fn


exp2 = _op("exp2", 1, np.exp2, torch.exp2,
           lambda i, o, gz: [gz[0] * o[0] * _LOG2], dtype_rule="float")
expm1 = _op("expm1", 1, np.expm1, torch.expm1,
            lambda i, o, gz: [gz[0] * _tm().exp(i[0])], dtype_rule="float")
log2 = _op("log2", 1, np.log2, torch.log2,
           lambda i, o, gz: [gz[0] / (i[0] * _LOG2)], dtype_rule="float")
log10 = _op("log10", 1, np.log10, torch.log10,
            lambda i, o, gz: [gz[0] / (i[0] * _LOG10)], dtype_rule="float")
log1p = _op("log1p", 1, np.log1p, torch.log1p,
            lambda i, o, gz: [gz[0] / (1 + i[0])], dtype_rule="float")
deg2rad = _op("deg2rad", 1, np.deg2rad, _angle_fn(_DEG2RAD),
              lambda i, o, gz: [gz[0] * float(np.pi / 180)], dtype_rule="float")
rad2deg = _op("rad2deg", 1, np.rad2deg, _angle_fn(_RAD2DEG),
              lambda i, o, gz: [gz[0] * float(180 / np.pi)], dtype_rule="float")

# ---------------------------------------------------------------------------
# trigonometric and hyperbolic
# ---------------------------------------------------------------------------

tan = _op("tan", 1, np.tan, torch.tan,
          lambda i, o, gz: [gz[0] * (1 + o[0] * o[0])], dtype_rule="float")
arcsin = _op("arcsin", 1, np.arcsin, torch.arcsin,
             lambda i, o, gz: [gz[0] / _tm().sqrt(1 - i[0] * i[0])], dtype_rule="float")
arccos = _op("arccos", 1, np.arccos, torch.arccos,
             lambda i, o, gz: [-gz[0] / _tm().sqrt(1 - i[0] * i[0])], dtype_rule="float")
arctan = _op("arctan", 1, np.arctan, torch.arctan,
             lambda i, o, gz: [gz[0] / (1 + i[0] * i[0])], dtype_rule="float")


def _arctan2_grad(i, o, gz):
    y, x = i
    denom = x * x + y * y
    return [gz[0] * x / denom, -gz[0] * y / denom]


arctan2 = _op("arctan2", 2, np.arctan2, torch.arctan2, _arctan2_grad, dtype_rule="float")
sinh = _op("sinh", 1, np.sinh, torch.sinh,
           lambda i, o, gz: [gz[0] * _tm().cosh(i[0])], dtype_rule="float")
cosh = _op("cosh", 1, np.cosh, torch.cosh,
           lambda i, o, gz: [gz[0] * _tm().sinh(i[0])], dtype_rule="float")
arcsinh = _op("arcsinh", 1, np.arcsinh, torch.arcsinh,
              lambda i, o, gz: [gz[0] / _tm().sqrt(i[0] * i[0] + 1)], dtype_rule="float")
arccosh = _op("arccosh", 1, np.arccosh, torch.arccosh,
              lambda i, o, gz: [gz[0] / _tm().sqrt(i[0] * i[0] - 1)], dtype_rule="float")
arctanh = _op("arctanh", 1, np.arctanh, torch.arctanh,
              lambda i, o, gz: [gz[0] / (1 - i[0] * i[0])], dtype_rule="float")

# ---------------------------------------------------------------------------
# comparisons, selection, logic
# ---------------------------------------------------------------------------


def _cmp_grad(i, o, gz):
    return [_zero_like(x) for x in i]


gt = _op("gt", 2, np.greater, _lexicographic(torch.gt, torch.gt), _cmp_grad, dtype_rule="bool")
le = _op("le", 2, np.less_equal, _lexicographic(torch.le, torch.lt), _cmp_grad, dtype_rule="bool")
neq = _op("neq", 2, np.not_equal, torch.ne, _cmp_grad, dtype_rule="bool", commutative=True)
isnan = _op("isnan", 1, np.isnan, torch.isnan, _cmp_grad, dtype_rule="bool")
isinf = _op("isinf", 1, np.isinf, torch.isinf, _cmp_grad, dtype_rule="bool")


def _minimum_grad(i, o, gz):
    tm = _tm()
    x, y = i
    gx = gz[0] * tm.cast(tm.le(x, y), gz[0].dtype)
    gy = gz[0] * tm.cast(tm.gt(x, y), gz[0].dtype)
    return [gx, gy]


def _torch_minimum(a, b):
    """numpy's minimum, ``a < b or a is NaN ? a : b``, which also fixes the
    sign of a zero minimum (torch's on the card gives -0.0 for 0.0 and
    -0.0 in either order)."""
    if not a.is_floating_point():
        return torch.minimum(a, b)
    return torch.where((a < b) | a.isnan(), a, b)


minimum = _op("minimum", 2, np.minimum, _complex_maximum(_torch_minimum, torch.lt), _minimum_grad,
              commutative=True)


def _int_only(opname):
    """numpy's bitwise ops refuse floats: the graph does too."""
    def rule(*dts):
        for dt in dts:
            if str(dt).startswith(("float", "complex")):
                raise TypeError(f"{opname} does not accept {dt} operands "
                                "(numpy bitwise semantics)")
        return upcast(*dts)

    return rule


and_ = _op("and_", 2, np.bitwise_and, torch.bitwise_and, _cmp_grad,
           identity="except_bool_one", commutative=True, dtype_rule=_int_only("bitwise_and"))
or_ = _op("or_", 2, np.bitwise_or, torch.bitwise_or, _cmp_grad,
          identity=0, commutative=True, dtype_rule=_int_only("bitwise_or"))
xor = _op("xor", 2, np.bitwise_xor, torch.bitwise_xor, _cmp_grad,
          identity=0, commutative=True, dtype_rule=_int_only("bitwise_xor"))
# torch's bitwise_not of a bool is logical not, as numpy's invert
invert = _op("invert", 1, np.invert, torch.bitwise_not, _cmp_grad,
             dtype_rule=_int_only("invert"))
# a count below 0, or of the width or more, gives 0 (and -1 for a negative
# value shifted right), in numpy and in torch alike
left_shift = _op("left_shift", 2, np.left_shift, torch.bitwise_left_shift)
right_shift = _op("right_shift", 2, np.right_shift, torch.bitwise_right_shift)


def _switch_grad(i, o, gz):
    # switch, not a product with a cast: the gradient of one branch is never
    # evaluated into the other's region
    tm = _tm()
    c = i[0]
    zval = _zero_like(gz[0])
    return [_zero_like(c), tm.switch(c, gz[0], zval), tm.switch(c, zval, gz[0])]


def _torch_switch(c, t, f):
    return torch.where(c if c.dtype == torch.bool else c != 0, t, f)


switch = _op("switch", 3, lambda c, t, f: np.where(c, t, f), _torch_switch, _switch_grad,
             dtype_rule=lambda c, t, f: upcast(t, f))


def _clip_grad(i, o, gz):
    tm = _tm()
    x, lo, hi = i
    inside = tm.and_(tm.ge(x, lo), tm.le(x, hi))
    gx = gz[0] * tm.cast(inside, gz[0].dtype)
    glo = gz[0] * tm.cast(tm.lt(x, lo), gz[0].dtype)
    ghi = gz[0] * tm.cast(tm.gt(x, hi), gz[0].dtype)
    return [gx, glo, ghi]


def _np_clip(x, lo, hi):
    # not np.clip: where lo > hi the reference gives lo (it checks the lower
    # bound first), np.clip gives hi
    return np.where(x < lo, lo, np.where(x > hi, hi, x))


def _torch_clip(x, lo, hi):
    return torch.where(x < lo, lo, torch.where(x > hi, hi, x))


clip = _op("clip", 3, _np_clip, _torch_clip, _clip_grad,
           dtype_rule=lambda x, lo, hi: upcast(x, lo, hi))

# ---------------------------------------------------------------------------
# complex (the JAX package's scalar/basic.py:605-615)
# ---------------------------------------------------------------------------

def _part(fn):
    """A part of a complex tensor, or of a real one (its real part is
    itself and its imaginary part 0), as a fresh tensor: torch's are views."""
    def part(a):
        if a.is_complex():
            return fn(a).clone()
        return a.clone() if fn is torch.real else torch.zeros_like(a)

    return part


def _conj(a):
    # conj_physical: torch.conj only sets a flag, which numpy() refuses
    return torch.conj_physical(a) if a.is_complex() else a.clone()


def _complex_dtype(a, b):
    # the JAX package's rule: complex128 where the parts upcast to float64
    return "complex128" if upcast(a, b) == "float64" else "complex64"


real = _op("real", 1, np.real, _part(torch.real), dtype_rule=real_dtype)
imag = _op("imag", 1, np.imag, _part(torch.imag), dtype_rule=real_dtype)
# numpy's dtype, a real one; the JAX package types the angle of a complex
# complex (ROADMAP Queue 3)
angle = _op("angle", 1, np.angle, torch.angle,
            dtype_rule=lambda a: real_dtype(upcast_float(a)))
conj = _op("conj", 1, np.conj, _conj, lambda i, o, gz: [_tm().conj(gz[0])], dtype_rule="first")
complex_op = _op("complex", 2, lambda re, im: re + 1j * im, torch.complex,
                 dtype_rule=_complex_dtype)

# casts: one op per target dtype
_cast_ops: dict[str, ScalarOp] = {}


def cast_op(dtype: str) -> ScalarOp:
    from pytensor_tpu_torch.link.torch.convert import torch_dtype

    dtype = str(dtype)
    if dtype not in _cast_ops:
        npdt = np_dtype(dtype)
        tdt = torch_dtype(dtype)

        def _cast_grad(i, o, gz, _dtype=dtype):
            if _is_discrete(i[0]) or _is_discrete(o[0]):
                # float -> int is piecewise constant: zero gradient
                return [i[0].zeros_like(dtype=config.floatX)
                        if _is_discrete(i[0]) else i[0].zeros_like()]
            return [_tm().cast(gz[0], i[0].dtype)]

        _cast_ops[dtype] = _op(
            f"cast{{{dtype}}}", 1,
            lambda a, npdt=npdt: np.asarray(a).astype(npdt),
            lambda a, tdt=tdt: a.to(tdt),
            _cast_grad,
            dtype_rule=lambda a, dtype=dtype: dtype,
        )
    return _cast_ops[dtype]


def _is_discrete(x):
    return dtype_kind(x.type.dtype) in discrete_kinds


# ---------------------------------------------------------------------------
# literal autocasting (PyTensor's scalar/basic.py:94 NumpyAutocaster)
# ---------------------------------------------------------------------------

class NumpyAutocaster:
    """Cast python ints/floats to numpy values (PyTensor's 'custom' policy).

    The first dtype of ``self.dtypes`` that represents the value without
    precision loss wins; float literals go to floatX directly when floatX
    is not float64.
    """

    def __init__(self, dtypes):
        self.dtypes = tuple(dtypes)

    def __call__(self, x):
        try:
            if str(x.dtype) in self.dtypes:
                return np.asarray(x)
        except AttributeError:
            pass
        if (isinstance(x, builtins.float)
                and config.floatX in self.dtypes
                and config.floatX != "float64"):
            return np.asarray(x, dtype=config.floatX)
        x_ = np.asarray(x)
        last = x_
        for dtype in self.dtypes:
            if dtype == "float16":
                continue
            cand = x_.astype(dtype)
            if np.array_equal(x_, cand):
                return cand
            last = cand
        if isinstance(x, builtins.int):
            # no listed int dtype holds the value exactly: keep numpy's choice
            return x_
        return last


autocast_int = NumpyAutocaster(int_types)
autocast_float = NumpyAutocaster(("float16", "float32", "float64"))


def convert(x, dtype=None):
    """Convert a python/numpy value per the casting policy."""
    if dtype is not None:
        return np.asarray(x, dtype=dtype)
    if isinstance(x, (builtins.bool, np.bool_)):
        return np.asarray(x, dtype="bool")
    if isinstance(x, int):
        return autocast_int(x)
    if isinstance(x, builtins.float):
        return autocast_float(x)
    return np.asarray(x)

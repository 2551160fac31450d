"""Scalar op descriptors: the element-wise kernel table.

Counterpart of ``pytensor_tpu/scalar/basic.py`` (PyTensor's
scalar/basic.py ScalarOp:1151), cut to the ops the radon logp+dlogp path,
the ported scan tests and the sparse power iteration build.  Each descriptor carries a numpy
implementation (what constant folding evaluates), a torch implementation
(what the linker and the plain versions of the kernels call) and its
gradient rule, written against tensor-level graph constructors.  The
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
from pytensor_tpu_torch.utils import MetaObject

discrete_kinds = "biu"
int_types = ("int8", "int16", "int32", "int64")


def upcast(*dtypes: str) -> str:
    """numpy dtype promotion over dtype names."""
    return str(np.result_type(*[str(d) for d in dtypes]))


def upcast_float(*dtypes: str) -> str:
    out = upcast(*dtypes)
    if np.dtype(out).kind in discrete_kinds:
        # discrete inputs promote to the smallest float that holds them
        # (bool/int8/int16 -> float32, int32/int64 -> float64)
        return str(np.promote_types(np.dtype(out), np.float32))
    return out


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
    """

    __props__ = ("name",)

    def __init__(self, name: str, nin: int, np_fn: Callable, torch_fn: Callable,
                 grad_fn: Callable | None = None, dtype_rule="upcast",
                 identity=None, commutative: bool = False, float_inputs: bool = False):
        self.name = name
        self.float_inputs = float_inputs
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
        raise ValueError(f"unknown dtype rule {rule}")

    def check_inputs(self, *input_dtypes: str):
        """Raise TypeError where the op refuses an input dtype (the JAX
        package's lowering raises it when the function is first run)."""
        for d in input_dtypes:
            if self.float_inputs and not str(d).startswith("float"):
                raise TypeError(f"{self.name} does not accept dtype {d}; it takes floats")

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

sub = _op("sub", 2, np.subtract, torch.sub, lambda i, o, gz: [gz[0], -gz[0]])


def _true_div_grad(i, o, gz):
    x, y = i
    return [gz[0] / y, -gz[0] * x / (y * y)]


def _true_div_dtype(a, b):
    # integer / integer divides at floatX, not numpy's float64
    if np.dtype(upcast(a, b)).kind in discrete_kinds:
        return config.floatX
    return upcast_float(a, b)


true_div = _op("true_div", 2, np.true_divide, torch.true_divide,
               _true_div_grad, dtype_rule=_true_div_dtype)


def _pow_grad(i, o, gz):
    tm = _tm()
    x, y = i
    return [gz[0] * y * x ** (y - 1), gz[0] * o[0] * tm.log(x)]


pow = _op("pow", 2, np.power, torch.pow, _pow_grad)
neg = _op("neg", 1, np.negative, torch.neg, lambda i, o, gz: [-gz[0]])


def _bool_identity(fn):
    """``fn``, or for a bool tensor a copy of it: abs and sqr of a bool are
    the bool, as the graph's type says and the JAX package gives (torch's
    abs refuses bool, and its square gives int64)."""
    return lambda a: a.clone() if a.dtype == torch.bool else fn(a)


abs = _op("abs", 1, np.abs, _bool_identity(torch.abs),
          lambda i, o, gz: [gz[0] * _tm().sign(i[0])])


def _sign(a):
    """jnp.sign's values: a float zero keeps its sign and NaN stays NaN
    (torch.sign gives +0.0 for both)."""
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
log = _op("log", 1, np.log, torch.log,
          lambda i, o, gz: [gz[0] / i[0]], dtype_rule="float")
sin = _op("sin", 1, np.sin, torch.sin,
          lambda i, o, gz: [gz[0] * _tm().cos(i[0])], dtype_rule="float")
cos = _op("cos", 1, np.cos, torch.cos,
          lambda i, o, gz: [-gz[0] * _tm().sin(i[0])], dtype_rule="float")
tanh = _op("tanh", 1, np.tanh, torch.tanh,
           lambda i, o, gz: [gz[0] * (1 - o[0] * o[0])], dtype_rule="float")


def _zero_like(x):
    return x.zeros_like(dtype=config.floatX) if _is_discrete(x) else x.zeros_like()


# comparisons -> bool
lt = _op("lt", 2, np.less, torch.lt,
         lambda i, o, gz: [_zero_like(i[0]), _zero_like(i[1])], dtype_rule=lambda a, b: "bool")
ge = _op("ge", 2, np.greater_equal, torch.ge,
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


maximum = _op("maximum", 2, np.maximum, torch.maximum, _maximum_grad, commutative=True)


def _second_grad(i, o, gz):
    from pytensor_tpu_torch.graph.null_type import DisconnectedType

    return [DisconnectedType()(), gz[0]]


def _second_torch(a, b):
    return torch.broadcast_to(b, torch.broadcast_shapes(a.shape, b.shape))


# second(a, b) = broadcast b to the shape of the pair: the "fill" primitive
second = _op(
    "second", 2,
    lambda a, b: np.broadcast_arrays(a, b)[1].copy(),
    _second_torch, _second_grad,
    dtype_rule=lambda a, b: str(b),
)

# casts: one op per target dtype
_cast_ops: dict[str, ScalarOp] = {}


def cast_op(dtype: str) -> ScalarOp:
    from pytensor_tpu_torch.link.torch.convert import torch_dtype

    dtype = str(dtype)
    if dtype not in _cast_ops:
        npdt = np.dtype(dtype)
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
    return np.dtype(x.type.dtype).kind in discrete_kinds


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

"""PyTensor's scalar namespace on top of the port's scalar design.

Counterpart of ``pytensor_tpu/scalar/compatnames.py``.  There is no
separate scalar graph level here: scalars are 0-d tensors, and the
built-in kernels are ``ScalarOp`` descriptors (``scalar/basic.py``).  This
module gives PyTensor's user-facing scalar API on that design:

- the scalar type objects (``int8`` ... ``complex128``) as 0-d
  ``TensorType`` instances (``ScalarType`` builds one);
- the literal casting (``NumpyAutocaster``, ``autocast_int``,
  ``autocast_float``, ``autocast_float_as``, ``convert``), which
  ``tensor.basic.as_tensor_variable`` uses for python literals under
  ``config.cast_policy``;
- the output-type preferences (``upgrade_to_float``, ``upcast_out``,
  ``same_out``, ...; PyTensor's scalar/basic.py:1023-1140);
- ``UnaryScalarOp`` and ``BinaryScalarOp`` to subclass, as PyMC defines
  its own scalar ops: override ``impl`` (numpy, the oracle) and
  ``grad``/``L_op``.  The numpy ``impl`` is also the op's torch
  lowering, run on the host (``on_host``: the lowering reads the device
  back, as the JAX package's ``pure_callback`` does); override
  ``torch_impl`` for a lowering in torch ops;
- ``LogicalComparison``, ``FixedLogicalComparison``, ``UnaryBitOp``,
  ``BinaryBitOp``, ``Composite`` and the variable constructors.

- the JAX package's graph-level re-exports (``pprint``,
  ``disconnected_type``, ``HasDataType``, ``HasShape``,
  ``applys_between``, ``difference``, ``to_return_values``).  The JAX
  package's lazy ``disconnected_type`` looks in its ``gradient`` module,
  which has none, and raises; the port's is ``graph/null_type.py``'s.
"""

from __future__ import annotations

import builtins

import numpy as np

from pytensor_tpu_torch.config import config

int_types = ("int8", "int16", "int32", "int64")
uint_types = ("uint8", "uint16", "uint32", "uint64")
integer_types = int_types + uint_types
float_types = ("float16", "float32", "float64")
complex_types = ("complex64", "complex128")
discrete_types = integer_types + ("bool",)
continuous_types = float_types + complex_types
all_types = discrete_types + continuous_types
discrete_dtypes = discrete_types
_DTYPES = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32", "uint64",
           "float16", "float32", "float64", "bfloat16", "complex64", "complex128")


# --- literal autocasting (PyTensor's scalar/basic.py:94 NumpyAutocaster) -----

class NumpyAutocaster:
    """Cast python ints and floats to numpy values by ``config.cast_policy``.

    'custom' (the default): the first dtype of ``self.dtypes`` that
    represents the value without precision loss wins; float literals go to
    floatX directly when floatX is not float64.  'numpy+floatX': numpy's
    own choice, but python floats become floatX.  'numpy': numpy's.
    """

    def __init__(self, dtypes):
        self.dtypes = tuple(dtypes)

    def __call__(self, x):
        if config.cast_policy == "numpy":
            return np.asarray(x)
        if config.cast_policy == "numpy+floatX":
            rval = np.asarray(x)
            if (not hasattr(x, "dtype") and rval.dtype in ("float64", "float32")
                    and rval.dtype != config.floatX):
                rval = rval.astype(config.floatX)
            return rval
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
        # floats: the last listed dtype, with its loss
        return last


autocast_int = NumpyAutocaster(int_types)
autocast_float = NumpyAutocaster(("float16", "float32", "float64"))


class autocast_float_as:
    """Change for a block which dtypes float literals may autocast to
    (PyTensor's autocast_float_as:188); the 'custom' cast policy only."""

    def __init__(self, *dtypes):
        self.dtypes = dtypes
        assert config.cast_policy == "custom"

    def __enter__(self):
        self.old_dtypes = autocast_float.dtypes
        autocast_float.dtypes = self.dtypes

    def __exit__(self, *args):
        autocast_float.dtypes = self.old_dtypes


def convert(x, dtype=None):
    """A python or numpy value converted by the casting policy."""
    if dtype is not None:
        return np.asarray(x, dtype=dtype)
    if isinstance(x, (builtins.bool, np.bool_)):
        return np.asarray(x, dtype="bool")
    if isinstance(x, int):
        return autocast_int(x)
    if isinstance(x, builtins.float):
        return autocast_float(x)
    if isinstance(x, builtins.complex):
        return np.asarray(x, dtype="complex128")
    return np.asarray(x)


# --- scalar types: 0-d TensorTypes -------------------------------------------

def _TT():
    from pytensor_tpu_torch.tensor.type import TensorType

    return TensorType


def get_scalar_type(dtype, cache: dict = {}):
    """The 0-d TensorType of ``dtype`` (PyTensor's get_scalar_type:4102)."""
    key = str(dtype)
    t = cache.get(key)
    if t is None:
        t = cache[key] = _TT()(key, ())
    return t


def ScalarType(dtype, shape=(), name=None):
    """Scalars are 0-d tensors here: ``TensorType(dtype, ())``."""
    return _TT()(dtype, ())


def _dtype_of(t) -> str:
    """A type object's, a dtype object's or a dtype string's dtype."""
    return str(getattr(t, "dtype", t))


def as_scalar(x, name=None):
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable

    v = as_tensor_variable(x, name=name)
    if v.type.ndim != 0:
        raise TypeError("as_scalar expects a 0-d value")
    return v


def constant(value, dtype=None):
    from pytensor_tpu_torch.tensor.basic import constant as t_constant

    return t_constant(np.asarray(value, dtype=dtype))


def cast(x, dtype):
    from pytensor_tpu_torch.tensor.basic import cast as t_cast

    return t_cast(as_scalar(x), dtype)


def _sb():
    from pytensor_tpu_torch.scalar import basic

    return basic


# --- output-type preferences (PyTensor's scalar/basic.py:1023) ---------------
# each takes type objects or dtype strings and gives a tuple of 0-d types

def upcast_out(*types):
    return (get_scalar_type(_sb().upcast(*map(_dtype_of, types))),)


def upcast_out_nobool(*types):
    out = upcast_out(*types)
    if _dtype_of(out[0]) == "bool":
        raise TypeError("bool output not supported")
    return out


def upcast_out_min8(*types):
    out = upcast_out(*types)
    if _dtype_of(out[0]) == "bool":
        return (get_scalar_type("int8"),)
    return out


def upgrade_to_float(*types):
    """Integers go to float32 or float64, so that no precision is lost."""
    return (get_scalar_type(_sb().upcast_float(*map(_dtype_of, types))),)


def upgrade_to_float64(*types):
    return (get_scalar_type("float64"),)


def same_out(type):
    return (get_scalar_type(_dtype_of(type)),)


def same_out_nobool(type):
    if _dtype_of(type) == "bool":
        raise TypeError("bool input not supported")
    return same_out(type)


def same_out_min8(type):
    if _dtype_of(type) == "bool":
        return (get_scalar_type("int8"),)
    return same_out(type)


def upcast_out_no_complex(*types):
    if any(_dtype_of(t) in complex_types for t in types):
        raise TypeError("complex type are not supported")
    return upcast_out(*types)


def same_out_float_only(type):
    if _dtype_of(type) not in float_types:
        raise TypeError("only float type are supported")
    return same_out(type)


class specific_out:
    def __init__(self, *spec):
        self.spec = tuple(get_scalar_type(s) if isinstance(s, str) else s for s in spec)

    def __call__(self, *types):
        return self.spec


def int_out(*types):
    return (get_scalar_type("int64"),)


def float_out(*types):
    return (get_scalar_type("float64"),)


def upgrade_to_float_no_complex(*types):
    for t in types:
        if _dtype_of(t) in complex_types:
            raise TypeError("complex argument not supported")
    return upgrade_to_float(*types)


def same_out_nocomplex(type):
    if _dtype_of(type) in complex_types:
        raise TypeError("complex argument not supported")
    return same_out(type)


def real_out(type):
    d = _dtype_of(type)
    if d == "complex64":
        return (get_scalar_type("float32"),)
    if d == "complex128":
        return (get_scalar_type("float64"),)
    return same_out(type)


# --- exceptions and small helpers --------------------------------------------

class ComplexError(NotImplementedError):
    """A complex value where none is supported."""


class IntegerDivisionError(Exception):
    """An integer division in an illegal operation."""


def mod_check(x, y):
    if (_dtype_of(getattr(x, "type", x)) in complex_types
            or _dtype_of(getattr(y, "type", y)) in complex_types):
        raise ComplexError("Modulo is not implemented for complex types")
    return _sb().mod(x, y)


def round_half_away_from_zero_(a):
    return np.copysign(np.floor(np.abs(a) + 0.5), a)


round_half_away_from_zero_vec = round_half_away_from_zero_


def apply_across_args(*fns):
    """PyTensor's helper that maps constructors over argument lists
    (scalar/basic.py:4200)."""

    def f(*names):
        if len(names) == 1:
            return fns[0](names[0])
        return [fn(name) for fn, name in zip(fns, names)]

    return f


# --- PyTensor-style scalar ops to subclass ------------------------------------

from pytensor_tpu_torch.scalar.basic import (  # noqa: E402
    ScalarOp,
    abs as scalar_abs,
    int_div as floor_div,
    maximum as scalar_maximum,
    minimum as scalar_minimum,
    upcast,
    upcast_float,
)


class _RefStyleScalarOp(ScalarOp):
    """Base of custom scalar ops with PyTensor's signatures.

    Subclass, set or inherit ``nin``, override ``impl`` (numpy scalar math,
    the oracle) and, if wanted, ``grad(self, inputs, output_grads)``
    (PyTensor's signature) or ``L_op(self, inputs, outputs, output_grads)``,
    and ``torch_impl(self, *tensors)`` for a lowering in torch ops (else
    the numpy ``impl`` runs on the host).  Built as PyTensor's
    ScalarOp:1155: ``MyOp(output_types_preference, name=None)``.
    """

    nin = -1
    nout = 1
    commutative = False
    identity = None
    float_inputs = False
    refused = ()
    special = False
    grad_fn = None

    def __init__(self, output_types_preference=None, name=None):
        if output_types_preference is not None and not callable(output_types_preference):
            raise TypeError(
                "Expected a callable for the 'output_types_preference' argument to "
                f"{self.__class__} (got: {output_types_preference})")
        self.output_types_preference = output_types_preference
        self.name = name or type(self).__name__

    __props__ = ("name", "output_types_preference")

    def __reduce__(self):
        return (_rebuild_ref_style_op, (type(self), self.output_types_preference, self.name))

    @property
    def on_host(self):
        return type(self).torch_impl is _RefStyleScalarOp.torch_impl

    def output_dtype(self, *input_dtypes):
        pref = self.output_types_preference
        if pref is None:
            raise NotImplementedError(
                f"Cannot calculate the output types for {self}: no output_types_preference given")
        out = pref(*(get_scalar_type(d) for d in input_dtypes))
        if not isinstance(out, (list, tuple)) or len(out) != self.nout:
            raise TypeError("output_types_preference should return a list or tuple "
                            f"of {self.nout} type(s), got {out!r}")
        return _dtype_of(out[0])

    def impl(self, *args):
        raise NotImplementedError(f"{type(self).__name__} must override impl()")

    @property
    def np_fn(self):
        """``impl`` over arrays (numpy's frompyfunc), in the output dtype."""
        fn = self.__dict__.get("_np_fn")
        if fn is None:
            ufn = np.frompyfunc(self.impl, self.nin if self.nin >= 0 else 1, self.nout)

            def fn(*args):
                out = ufn(*args)
                dt = self.output_dtype(*(str(np.asarray(a).dtype) for a in args))
                return np.asarray(out).astype(dt)

            self.__dict__["_np_fn"] = fn
        return fn

    @property
    def torch_fn(self):
        """``torch_impl`` where a subclass gives one, else ``np_fn`` on the
        host values of the operands, the result moved back to their device."""
        if not self.on_host:
            return self.torch_impl
        np_fn = self.np_fn

        def host(*args):
            import torch

            out = np_fn(*[a.detach().cpu().numpy() for a in args])
            return torch.from_numpy(np.ascontiguousarray(out)).to(args[0].device)

        return host

    def torch_impl(self, *args):
        raise NotImplementedError

    def L_op(self, inputs, outputs, output_grads):
        # PyTensor's chain: L_op defaults to grad(inputs, output_grads)
        return self.grad(inputs, output_grads)

    def grad(self, inputs, output_grads):
        from pytensor_tpu_torch import gradient

        return [gradient.grad_not_implemented(self, i, inp) for i, inp in enumerate(inputs)]


def _rebuild_ref_style_op(cls, pref, name):
    return cls(pref, name)


class UnaryScalarOp(_RefStyleScalarOp):
    nin = 1


class BinaryScalarOp(_RefStyleScalarOp):
    nin = 2


class LogicalComparison(BinaryScalarOp):
    """Base of binary comparisons with a bool result."""

    def __init__(self, output_types_preference=None, name=None):
        super().__init__(output_types_preference or specific_out("bool"), name=name)

    def output_dtype(self, *input_dtypes):
        return "bool"


class FixedLogicalComparison(UnaryScalarOp):
    """Base of unary predicates with a bool result."""

    def __init__(self, output_types_preference=None, name=None):
        super().__init__(output_types_preference or specific_out("bool"), name=name)

    def output_dtype(self, *input_dtypes):
        return "bool"


class UnaryBitOp(UnaryScalarOp):
    """Base of unary bitwise ops: integer or bool in, the same type out."""

    def output_dtype(self, *input_dtypes):
        for d in input_dtypes:
            if d.startswith(("float", "complex")):
                raise TypeError(f"{self.name} only works on integer or bool, got {d}")
        if self.output_types_preference is not None:
            return super().output_dtype(*input_dtypes)
        return input_dtypes[0]


class BinaryBitOp(BinaryScalarOp):
    """Base of binary bitwise ops: integer or bool in, the upcast out."""

    def output_dtype(self, *input_dtypes):
        for d in input_dtypes:
            if d.startswith(("float", "complex")):
                raise TypeError(f"{self.name} only works on integer or bool, got {d}")
        if self.output_types_preference is not None:
            return super().output_dtype(*input_dtypes)
        return upcast(*input_dtypes)


# --- Composite (PyTensor's scalar/basic.py:4204) ------------------------------

class Composite:
    """PyTensor's scalar Composite, by substitution: calling it splices the
    stored subgraph onto the arguments (vectorized over tensors), which is
    the fusion pass's ``FusedElemwise`` input in this design."""

    def __init__(self, inputs, outputs, name="Composite"):
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.name = name
        self.nin = len(self.inputs)
        self.nout = len(self.outputs)

    @property
    def fgraph(self):
        from pytensor_tpu_torch.graph.fg import FunctionGraph

        return FunctionGraph(self.inputs, self.outputs, clone=True)

    def __call__(self, *args):
        from pytensor_tpu_torch.graph.replace import clone_replace, vectorize_graph
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        if len(args) != self.nin:
            raise TypeError(f"{self.name} expected {self.nin} inputs, got {len(args)}")
        args = [as_tensor_variable(a) for a in args]
        repl = dict(zip(self.inputs, args))
        if any(a.type != i.type for a, i in zip(args, self.inputs)):
            res = vectorize_graph(self.outputs, repl)
        else:
            res = clone_replace(self.outputs, replace=repl)
        return res[0] if self.nout == 1 else res

    def __str__(self):
        return self.name


def complex(name=None):
    """A 0-d complex128 variable."""
    return get_scalar_type("complex128")(name)


def _multi_ctor(dtype):
    def ctor(*names):
        vs = [get_scalar_type(dtype)(n) for n in names]
        return vs[0] if len(vs) == 1 else vs

    ctor.__name__ = dtype + "s"
    return ctor


floats = _multi_ctor("float64")
ints = _multi_ctor("int64")
complexs = _multi_ctor("complex128")
complexs64 = _multi_ctor("complex64")
complexs128 = _multi_ctor("complex128")

from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable  # noqa: E402,F401
from pytensor_tpu_torch.graph.op import HasInnerGraph, Op  # noqa: E402,F401
from pytensor_tpu_torch.graph.replace import clone_replace  # noqa: E402,F401
from pytensor_tpu_torch.graph.traversal import applys_between  # noqa: E402,F401
from pytensor_tpu_torch.graph.type import HasDataType, HasShape  # noqa: E402,F401
from pytensor_tpu_torch.graph.type import Type as CType  # noqa: E402,F401
from pytensor_tpu_torch.utils import difference, to_return_values  # noqa: E402,F401


class MethodNotDefined(Exception):
    """An optional Op method that an op does not define."""


class COp(Op):
    """PyTensor's COp, as a marker: ops lower through ``torch_funcify``."""


# names that would import tensor or gradient when this module is imported
_LAZY = {"Cast", "ScalarVariable", "ScalarConstant", "ScalarConstantSignature",
         "ScalarInnerGraphOp", "pprint", "grad_undefined", "grad_not_implemented",
         "disconnected_type"} | {
    f"convert_to_{d}" for d in ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
                                "uint32", "uint64", "float16", "float32", "float64",
                                "complex64", "complex128")}


def __getattr__(name):
    if name in _DTYPES:
        t = get_scalar_type(name)
        globals()[name] = t
        return t
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    if name.startswith("convert_to_"):
        return _sb().cast_op(name[len("convert_to_"):])
    if name == "Cast":
        return type(_sb().cast_op("float64"))
    if name == "ScalarVariable":
        from pytensor_tpu_torch.tensor.variable import TensorVariable

        return TensorVariable
    if name == "ScalarConstant":
        from pytensor_tpu_torch.tensor.variable import TensorConstant

        return TensorConstant
    if name == "ScalarConstantSignature":
        return tuple
    if name == "ScalarInnerGraphOp":
        from pytensor_tpu_torch.scalar.loop import ScalarLoop

        return ScalarLoop
    if name == "pprint":
        from pytensor_tpu_torch.printing import pprint

        return pprint
    if name == "disconnected_type":
        from pytensor_tpu_torch.graph.null_type import disconnected_type

        return disconnected_type
    from pytensor_tpu_torch import gradient

    return getattr(gradient, name)

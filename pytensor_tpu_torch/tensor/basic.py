"""Tensor constructors & structural ops.

Counterpart of ``pytensor_tpu/tensor/basic.py`` (PyTensor's
tensor/basic.py as_tensor_variable, Alloc:1545, MakeVector:1900), cut to
what the radon graphs, their gradients and their rewrites build.
"""

from __future__ import annotations

import numbers

import numpy as np

from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable
from pytensor_tpu_torch.graph.null_type import DisconnectedType
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.tensor.elemwise import DimShuffle, Elemwise
from pytensor_tpu_torch.tensor.type import TensorType
from pytensor_tpu_torch.tensor.variable import TensorConstant, TensorVariable


class NotScalarConstantError(Exception):
    pass


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def constant(value, name=None, ndim=None, dtype=None) -> TensorConstant:
    if isinstance(value, TensorConstant):
        if (ndim is None or value.type.ndim == ndim) and (
            dtype is None or value.type.dtype == str(dtype)
        ):
            return value
        value = value.data
    if dtype is None and isinstance(value, (bool, int, float, complex)) \
            and not isinstance(value, np.generic):
        # python literals go through the autocasting policy
        from pytensor_tpu_torch.scalar.basic import convert

        arr = convert(value)
    else:
        arr = np.asarray(value, dtype=np.dtype(dtype) if dtype is not None else None)
    if dtype is None:
        if arr.dtype == np.float64 and isinstance(value, numbers.Real) \
                and not isinstance(value, (float, np.ndarray, np.generic,
                                           numbers.Integral)):
            # non-builtin Real scalars (e.g. fractions) follow floatX
            arr = arr.astype(config.floatX)
    if ndim is not None:
        if arr.ndim < ndim:
            arr = arr.reshape((1,) * (ndim - arr.ndim) + arr.shape)
        elif arr.ndim > ndim:
            try:
                arr = arr.reshape(arr.shape[-ndim:] if ndim else ())
            except ValueError:
                raise ValueError(f"cannot reduce constant to {ndim} dims")
    ttype = TensorType(str(arr.dtype), arr.shape)
    return TensorConstant(ttype, arr, name)


def as_tensor_variable(x, name=None, ndim=None, dtype=None) -> TensorVariable:
    """Convert ``x`` to a TensorVariable (the universal ingestion point)."""
    if isinstance(x, Variable):
        if isinstance(x.type, TensorType):
            if dtype is not None and x.type.dtype != str(dtype):
                x = cast(x, dtype)
            if ndim is not None and x.type.ndim != ndim:
                if x.type.ndim < ndim:
                    x = shape_padleft(x, ndim - x.type.ndim)
                else:
                    # try to squeeze leading broadcastable dims
                    k = x.type.ndim - ndim
                    if all(s == 1 for s in x.type.shape[:k]):
                        x = DimShuffle(x.type.ndim, list(range(k, x.type.ndim)))(x)
                    else:
                        raise ValueError(f"cannot reduce {x} to ndim {ndim}")
            return x
        raise TypeError(f"Cannot convert Variable of type {x.type} to TensorType")
    if isinstance(x, (list, tuple)) and any(isinstance(e, Variable) for e in x):
        return stack(list(x))
    if isinstance(x, bool):
        return constant(np.bool_(x), name)
    if isinstance(x, int) and not isinstance(x, bool) and dtype is None:
        from pytensor_tpu_torch.scalar.basic import autocast_int

        if x > np.iinfo("int64").max or x < np.iinfo("int64").min:
            raise OverflowError(f"int literal {x} does not fit int64")
        return constant(autocast_int(x), name)
    if isinstance(x, np.integer) and dtype is None:
        return constant(np.asarray(x), name)
    if isinstance(x, float) and not isinstance(x, np.floating) \
            and dtype is None:
        # numpy scalars keep their dtype (np.float64 subclasses float)
        from pytensor_tpu_torch.scalar.basic import autocast_float

        return constant(autocast_float(x), name)
    arr = np.asarray(x, dtype=np.dtype(dtype) if dtype is not None else None)
    return constant(arr, name, ndim=ndim)


def get_scalar_constant_value(v, elemwise=True, raise_not_constant=True):
    """Return the python scalar behind ``v`` if it is constant (possibly
    through DimShuffle/Alloc/...); else raise NotScalarConstantError."""
    from pytensor_tpu_torch.tensor.shape import Shape, Shape_i
    from pytensor_tpu_torch.tensor.subtensor import Subtensor

    v0 = v
    while v is not None:
        if isinstance(v, (int, float, np.number)):
            return np.asarray(v)
        if isinstance(v, Constant):
            data = np.asarray(v.data)
            if data.size != 1:
                break  # honor raise_not_constant below
            return data.reshape(())
        if v.owner is not None:
            op = v.owner.op
            if isinstance(op, (DimShuffle,)):
                v = v.owner.inputs[0]
                continue
            if isinstance(op, Alloc):
                v = v.owner.inputs[0]
                continue
            if isinstance(op, Elemwise) and op.scalar_op.name == "second":
                # fill(a, b) is b everywhere
                v = v.owner.inputs[1]
                continue
            if isinstance(op, Shape_i):
                dim = v.owner.inputs[0].type.shape[op.i]
                if dim is not None:
                    return np.asarray(np.int64(dim)).reshape(())
            # Shape of a 1-d operand reached through a dim-dropping
            # DimShuffle (shape(v)[0] after the squeeze rewrites)
            if isinstance(op, Shape) and v.type.shape == (1,):
                dim = v.owner.inputs[0].type.shape[0]
                if dim is not None:
                    return np.asarray(np.int64(dim)).reshape(())
            if isinstance(op, Subtensor) and len(op.idx_list) == 1 and \
                    isinstance(op.idx_list[0], (int, np.integer)):
                inner = v.owner.inputs[0]
                i = int(op.idx_list[0])
                if isinstance(inner, Constant) and inner.type.ndim == 1:
                    return np.asarray(inner.data[i]).reshape(())
                if inner.owner is not None and isinstance(inner.owner.op, Shape):
                    dim = inner.owner.inputs[0].type.shape[i]
                    if dim is not None:
                        return np.asarray(np.int64(dim)).reshape(())
                if inner.owner is not None and isinstance(inner.owner.op, MakeVector):
                    return get_scalar_constant_value(
                        inner.owner.inputs[i], elemwise)
            if elemwise and isinstance(op, Elemwise) and \
                    op.scalar_op.name in ("mul", "add", "sub", "true_div"):
                try:
                    vals = [get_scalar_constant_value(i, elemwise)
                            for i in v.owner.inputs]
                except NotScalarConstantError:
                    vals = None
                if vals is not None:
                    fn = {"mul": np.multiply, "add": np.add,
                          "sub": np.subtract, "true_div": np.true_divide,
                          }[op.scalar_op.name]
                    r = vals[0]
                    for w in vals[1:]:
                        r = fn(r, w)
                    return np.asarray(r).astype(v.type.numpy_dtype).reshape(())
            if elemwise and isinstance(op, Elemwise) and op.scalar_op.name.startswith("cast"):
                try:
                    inner = get_scalar_constant_value(v.owner.inputs[0], elemwise)
                    return inner.astype(v.type.numpy_dtype)
                except NotScalarConstantError:
                    pass
        break
    if raise_not_constant:
        raise NotScalarConstantError(f"{v0} is not a scalar constant")
    return None


def cast(x, dtype):
    from pytensor_tpu_torch.scalar.basic import cast_op
    from pytensor_tpu_torch.tensor.type import _normalize_dtype

    dtype = _normalize_dtype(dtype)
    x = as_tensor_variable(x)
    if x.type.dtype == str(dtype):
        return x
    return Elemwise(cast_op(dtype))(x)


# ---------------------------------------------------------------------------
# Alloc / fills
# ---------------------------------------------------------------------------

class Alloc(Op):
    """Broadcast ``value`` to the given (symbolic) shape."""

    __props__ = ()

    def make_node(self, value, *shape):
        value = as_tensor_variable(value)
        shape, static_shape = _infer_static_shape(shape)
        if value.type.ndim > len(shape):
            raise TypeError(
                f"Alloc value has {value.type.ndim} dims, shape has {len(shape)}"
            )
        out = TensorType(value.type.dtype, static_shape)()
        return Apply(self, [value, *shape], [out])

    def perform(self, node, inputs, output_storage):
        value, *shape = inputs
        shp = tuple(int(s) for s in shape)
        output_storage[0][0] = np.broadcast_to(
            np.asarray(value), shp
        ).astype(node.outputs[0].type.numpy_dtype, copy=True)

    def connection_pattern(self, node):
        return [[True]] + [[False] for _ in node.inputs[1:]]

    def L_op(self, inputs, outputs, output_grads):
        value, *shape = inputs
        (gz,) = output_grads
        from pytensor_tpu_torch.tensor.elemwise import _sum_grad_over_bcasted_dims

        g = _sum_grad_over_bcasted_dims(value, gz)
        return [g, *[DisconnectedType()() for _ in shape]]

    def do_constant_folding(self, fgraph, node):
        # folding big allocs bloats the graph with constants
        clients = fgraph.clients.get(node.outputs[0], ())
        return len(clients) <= 1


def _infer_static_shape(shape):
    """Normalize a shape argument into scalar int64 variables + static tuple."""
    svars = []
    static = []
    for s in shape:
        if isinstance(s, (int, np.integer)):
            static.append(int(s))
            svars.append(constant(np.int64(s)))
        else:
            s = as_tensor_variable(s)
            if s.type.ndim != 0:
                raise TypeError(f"shape entries must be scalars, got {s.type}")
            try:
                static.append(int(get_scalar_constant_value(s)))
            except NotScalarConstantError:
                static.append(None)
            svars.append(cast(s, "int64") if s.type.dtype != "int64" else s)
    return svars, tuple(static)


def fill(model, value):
    """Tensor of ``value`` shaped like broadcast(model, value): ``second``."""
    from pytensor_tpu_torch.tensor import math as tm

    return tm.second(model, value)


def zeros_like(x, dtype=None):
    x = as_tensor_variable(x)
    return fill(x, constant(0, dtype=dtype or x.type.dtype))


def ones_like(x, dtype=None):
    x = as_tensor_variable(x)
    return fill(x, constant(1, dtype=dtype or x.type.dtype))


# ---------------------------------------------------------------------------
# MakeVector / stack
# ---------------------------------------------------------------------------

class MakeVector(Op):
    """Pack scalar variables into a 1-d tensor."""

    __props__ = ("dtype",)

    def __init__(self, dtype="int64"):
        self.dtype = str(dtype)

    def make_node(self, *inputs):
        inputs = [as_tensor_variable(i) for i in inputs]
        if any(i.type.ndim != 0 for i in inputs):
            raise TypeError("MakeVector inputs must be scalars")
        inputs = [cast(i, self.dtype) if i.type.dtype != self.dtype else i for i in inputs]
        out = TensorType(self.dtype, (len(inputs),))()
        return Apply(self, inputs, [out])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(inputs, dtype=self.dtype)

    def L_op(self, inputs, outputs, output_grads):
        (gz,) = output_grads
        return [DisconnectedType()() if np.dtype(inp.type.dtype).kind in "biu"
                else gz[i] for i, inp in enumerate(inputs)]


def stack(tensors, axis=0):
    """Stack 0-d tensors into a vector (the only form the slice needs)."""
    tensors = [as_tensor_variable(t) for t in tensors]
    if not tensors or axis != 0 or any(t.type.ndim != 0 for t in tensors):
        raise NotImplementedError("stack: only 0-d tensors along axis 0")
    from pytensor_tpu_torch.scalar.basic import upcast

    return MakeVector(upcast(*(t.type.dtype for t in tensors)))(*tensors)


# ---------------------------------------------------------------------------
# layout helpers (DimShuffle front ends)
# ---------------------------------------------------------------------------

def shape_padleft(t, n_ones=1):
    t = as_tensor_variable(t)
    pattern = ["x"] * n_ones + list(range(t.type.ndim))
    return DimShuffle(t.type.ndim, pattern)(t)


def shape_padright(t, n_ones=1):
    t = as_tensor_variable(t)
    pattern = list(range(t.type.ndim)) + ["x"] * n_ones
    return DimShuffle(t.type.ndim, pattern)(t)


def transpose(x, axes=None):
    x = as_tensor_variable(x)
    if axes is None:
        axes = tuple(range(x.type.ndim - 1, -1, -1))
    return DimShuffle(x.type.ndim, tuple(int(a) % x.type.ndim for a in axes))(x)


def moveaxis(x, source, destination):
    x = as_tensor_variable(x)
    if isinstance(source, (int, np.integer)):
        source = (source,)
    if isinstance(destination, (int, np.integer)):
        destination = (destination,)
    if len(source) != len(destination):
        raise ValueError(
            "`source` and `destination` arguments must have the same number "
            f"of elements (got {len(source)} and {len(destination)})"
        )
    src = [s % x.type.ndim for s in source]
    dst = [d % x.type.ndim for d in destination]
    order = [a for a in range(x.type.ndim) if a not in src]
    for d, s in sorted(zip(dst, src)):
        order.insert(d, s)
    return transpose(x, order)

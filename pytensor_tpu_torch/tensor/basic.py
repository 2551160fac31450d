"""Tensor constructors and structural ops.

Counterpart of ``pytensor_tpu/tensor/basic.py`` (PyTensor's
tensor/basic.py as_tensor_variable, Alloc:1545, AllocEmpty:4197,
MakeVector:1900, Join:2405, Split:2203, ARange:3139, Eye:1351,
ExtractDiag:3636, Nonzero:960).  The torch lowerings are in
``link/torch/dispatch.py``; the shapes, bounds and sizes that ``Alloc``,
``AllocEmpty``, ``ARange``, ``Eye``, ``Join`` and ``Split`` read are host
values there, and ``Nonzero``'s output length depends on the data.
"""

from __future__ import annotations

import numbers
from typing import Sequence

import numpy as np

from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.graph.null_type import DisconnectedType
from pytensor_tpu_torch.tensor.elemwise import DimShuffle, Elemwise, broadcast_static_shapes
from pytensor_tpu_torch.tensor.type import TensorType, _np_dtype
from pytensor_tpu_torch.tensor.variable import TensorConstant, TensorVariable
from pytensor_tpu_torch.utils import dtype_kind


class NotScalarConstantError(Exception):
    pass


# ---------------------------------------------------------------------------
# conversion
# ---------------------------------------------------------------------------

def constant(value, name=None, ndim=None, dtype=None) -> TensorConstant:
    if isinstance(value, np.ma.MaskedArray):
        # silently dropping the mask would fabricate data
        raise NotImplementedError("masked arrays are not supported")
    if isinstance(value, TensorConstant):
        if (ndim is None or value.type.ndim == ndim) and (
            dtype is None or value.type.dtype == str(dtype)
        ):
            return value
        value = value.data
    if dtype is None and isinstance(value, (bool, int, float, complex)) \
            and not isinstance(value, np.generic):
        # python literals go through the autocasting policy (PyTensor's
        # TensorConstant creation via scalar.convert; NumpyAutocaster)
        from pytensor_tpu_torch.scalar.basic import convert

        arr = convert(value)
    else:
        arr = np.asarray(value,
                         dtype=_np_dtype(dtype) if dtype is not None else None)
    if dtype is None:
        if arr.dtype == np.float64 and isinstance(value, numbers.Real) \
                and not isinstance(value, (float, np.ndarray, np.generic,
                                           numbers.Integral)):
            # non-builtin Real scalars (e.g. fractions) follow floatX
            arr = arr.astype(_np_dtype(config.floatX))
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
    if isinstance(x, np.ma.MaskedArray):
        raise NotImplementedError("masked arrays are not supported")
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
        converted = getattr(x.type, "as_tensor", None)
        if converted is not None:
            return converted(x)
        raise TypeError(f"Cannot convert Variable of type {x.type} to TensorType")
    if isinstance(x, (list, tuple)) and any(isinstance(e, Variable) for e in x):
        return stack(list(x))
    if isinstance(x, bool):
        return constant(np.bool_(x), name)
    if isinstance(x, int) and not isinstance(x, bool) and dtype is None:
        # literal autocasting is delegated to the NumpyAutocaster pair
        # (scalar/basic.py; PyTensor's scalar/basic.py:94): smallest
        # representing dtype under the 'custom' policy, adjustable via
        # autocast_float_as
        from pytensor_tpu_torch.scalar.basic import autocast_int

        if x > np.iinfo("int64").max or x < np.iinfo("int64").min:
            raise OverflowError(f"int literal {x} does not fit int64")
        return constant(autocast_int(x), name)
    if isinstance(x, np.integer) and dtype is None:
        return constant(np.asarray(x), name)
    if isinstance(x, float) and not isinstance(x, np.floating) \
            and dtype is None:
        # numpy scalars keep their dtype (np.float64 subclasses float —
        # exclude it, as PyTensor's NumpyAutocaster does)
        from pytensor_tpu_torch.scalar.basic import autocast_float

        return constant(autocast_float(x), name)
    if isinstance(x, complex) and dtype is None:
        return constant(np.asarray(x, dtype="complex128"), name)
    arr = np.asarray(x, dtype=_np_dtype(dtype) if dtype is not None else None)
    return constant(arr, name, ndim=ndim)


as_tensor = as_tensor_variable


def get_scalar_constant_value(v, elemwise=True, raise_not_constant=True):
    """Return the python scalar behind ``v`` if it is constant (possibly
    through DimShuffle/Alloc/...); else raise NotScalarConstantError."""
    from pytensor_tpu_torch.tensor.shape import Shape_i

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
                # fill(a, b) is b everywhere (PyTensor's
                # get_underlying_scalar_constant_value second handling)
                v = v.owner.inputs[1]
                continue
            if isinstance(op, Shape_i):
                dim = v.owner.inputs[0].type.shape[op.i]
                if dim is not None:
                    return np.asarray(np.int64(dim)).reshape(())
            from pytensor_tpu_torch.tensor.shape import Shape as _Shape
            from pytensor_tpu_torch.tensor.subtensor import Subtensor as _Subtensor

            # Shape of a 1-d operand reached through a dim-dropping
            # DimShuffle (shape(v)[0] after the squeeze rewrites)
            if isinstance(op, _Shape) and v.type.shape == (1,):
                dim = v.owner.inputs[0].type.shape[0]
                if dim is not None:
                    return np.asarray(np.int64(dim)).reshape(())

            if isinstance(op, _Subtensor) and len(op.idx_list) == 1 and \
                    isinstance(op.idx_list[0], (int, np.integer)):
                inner = v.owner.inputs[0]
                i = int(op.idx_list[0])
                if isinstance(inner, Constant) and inner.type.ndim == 1:
                    return np.asarray(inner.data[i]).reshape(())
                if inner.owner is not None and isinstance(inner.owner.op, _Shape):
                    dim = inner.owner.inputs[0].type.shape[i]
                    if dim is not None:
                        return np.asarray(np.int64(dim)).reshape(())
                if inner.owner is not None and isinstance(inner.owner.op, MakeVector):
                    return get_scalar_constant_value(
                        inner.owner.inputs[i], elemwise)
            if elemwise and isinstance(op, Elemwise) and \
                    op.scalar_op.name in ("mul", "add", "sub", "int_div",
                                          "true_div", "maximum", "minimum"):
                try:
                    vals = [get_scalar_constant_value(i, elemwise)
                            for i in v.owner.inputs]
                except NotScalarConstantError:
                    vals = None
                if vals is not None:
                    fn = {"mul": np.multiply, "add": np.add,
                          "sub": np.subtract, "int_div": np.floor_divide,
                          "true_div": np.true_divide,
                          "maximum": np.maximum, "minimum": np.minimum,
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


def get_underlying_scalar_constant_value(v, **kwargs):
    return get_scalar_constant_value(v, **kwargs)


def cast(x, dtype):
    from pytensor_tpu_torch.scalar.basic import cast_op
    from pytensor_tpu_torch.tensor.type import _normalize_dtype

    dtype = _normalize_dtype(dtype)
    x = as_tensor_variable(x)
    if x.type.dtype == str(dtype):
        return x
    if x.type.dtype.startswith("complex") and not str(dtype).startswith("complex"):
        raise TypeError("Casting from complex to real is ambiguous: use real(), imag()")
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
        # runtime broadcasting (a dim that is 1 at runtime but not statically
        # known to be 1) is forbidden: gradients would silently be wrong
        # (PyTensor's Alloc._check_runtime_broadcast, tensor/basic.py:1617)
        v_static = node.inputs[0].type.shape
        for v_stat, v_dim, out_dim in zip(
            v_static[::-1], np.shape(value)[::-1], shp[::-1]
        ):
            if v_stat is None and v_dim == 1 and out_dim != 1:
                raise ValueError(
                    "Runtime broadcasting not allowed. Alloc was asked to "
                    "broadcast a runtime dimension of 1; use "
                    "specify_shape/broadcast_to to make the intent explicit."
                )
        output_storage[0][0] = np.broadcast_to(
            np.asarray(value), shp
        ).astype(node.outputs[0].type.numpy_dtype, copy=True)

    def infer_shape(self, fgraph, node, input_shapes):
        return [tuple(node.inputs[1:])]

    def connection_pattern(self, node):
        return [[True]] + [[False] for _ in node.inputs[1:]]

    def L_op(self, inputs, outputs, output_grads):
        value, *shape = inputs
        (gz,) = output_grads
        from pytensor_tpu_torch.tensor import math as tm
        from pytensor_tpu_torch.tensor.elemwise import _sum_grad_over_bcasted_dims

        g = _sum_grad_over_bcasted_dims(value, gz)
        disc = [DisconnectedType()() for _ in shape]
        return [g, *disc]

    def do_constant_folding(self, fgraph, node):
        # folding big allocs bloats the graph with constants
        clients = fgraph.clients.get(node.outputs[0], ())
        return len(clients) <= 1


alloc = Alloc()


class AllocEmpty(Op):
    """Uninitialized buffer of the given shape (dtype fixed per instance)."""

    __props__ = ("dtype",)

    def __init__(self, dtype):
        self.dtype = str(dtype)

    def make_node(self, *shape):
        shape, static_shape = _infer_static_shape(shape)
        out = TensorType(self.dtype, static_shape)()
        return Apply(self, list(shape), [out])

    def perform(self, node, inputs, output_storage):
        shp = tuple(int(s) for s in inputs)
        output_storage[0][0] = np.empty(shp, dtype=_np_dtype(self.dtype))

    def infer_shape(self, fgraph, node, input_shapes):
        return [tuple(node.inputs)]

    def connection_pattern(self, node):
        return [[False] for _ in node.inputs]

    def do_constant_folding(self, fgraph, node):
        return False


def _infer_static_shape(shape):
    """Normalize a shape argument into scalar int64 variables + static tuple."""
    from pytensor_tpu_torch.tensor.shape import Shape_i

    if isinstance(shape, Variable):
        if shape.type.ndim == 0:
            # a scalar shape means a 1-d result (numpy ones(5) semantics;
            # PyTensor's test_add_scalars)
            shape = [shape]
        elif shape.type.ndim != 1:
            raise TypeError("symbolic shape must be a vector")
        else:
            n = shape.type.shape[0]
            if n is None:
                raise TypeError(
                    "symbolic shape vector must have a static length")
            shape = [shape[i] for i in range(n)]
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
                val = get_scalar_constant_value(s)
                static.append(int(val))
            except NotScalarConstantError:
                static.append(None)
            svars.append(cast(s, "int64") if s.type.dtype != "int64" else s)
    return svars, tuple(static)


def fill(model, value):
    """Tensor of ``value`` shaped like broadcast(model, value) — the
    PyTensor's ``second``."""
    from pytensor_tpu_torch.tensor import math as tm

    return tm.second(model, value)


def zeros_like(x, dtype=None):
    x = as_tensor_variable(x)
    z = fill(x, constant(0, dtype=dtype or x.type.dtype))
    return z


def ones_like(x, dtype=None):
    x = as_tensor_variable(x)
    return fill(x, constant(1, dtype=dtype or x.type.dtype))


def zeros(shape, dtype=None):
    if not isinstance(shape, (list, tuple, Variable)):
        shape = [shape]
    return alloc(constant(0, dtype=dtype or config.floatX), *_as_shape_list(shape))


def ones(shape, dtype=None):
    if not isinstance(shape, (list, tuple, Variable)):
        shape = [shape]
    return alloc(constant(1, dtype=dtype or config.floatX), *_as_shape_list(shape))


def empty(shape, dtype=None):
    if not isinstance(shape, (list, tuple, Variable)):
        shape = [shape]
    return AllocEmpty(dtype or config.floatX)(*_as_shape_list(shape))


def full(shape, fill_value, dtype=None):
    if not isinstance(shape, (list, tuple, Variable)):
        shape = [shape]
    v = as_tensor_variable(fill_value)
    if dtype is not None:
        v = cast(v, dtype)
    return alloc(v, *_as_shape_list(shape))


def full_like(x, fill_value, dtype=None):
    v = as_tensor_variable(fill_value)
    if dtype is not None:
        v = cast(v, dtype)
    return fill(x, v)


def empty_like(x, dtype=None):
    x = as_tensor_variable(x)
    return empty(tuple(x.shape[i] for i in range(x.type.ndim)), dtype or x.type.dtype)


def _as_shape_list(shape):
    if isinstance(shape, Variable):
        shape, _ = _infer_static_shape(shape)
        return shape
    return list(shape)


# ---------------------------------------------------------------------------
# MakeVector / Join / Split / Stack
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
        output_storage[0][0] = np.asarray(inputs, dtype=_np_dtype(self.dtype))

    def infer_shape(self, fgraph, node, input_shapes):
        return [(constant(np.int64(len(node.inputs))),)]

    def L_op(self, inputs, outputs, output_grads):
        (gz,) = output_grads
        grads = []
        for i, inp in enumerate(inputs):
            if dtype_kind(inp.type.dtype) in "biu":
                grads.append(DisconnectedType()())
            else:
                grads.append(gz[i])
        return grads

    def connection_pattern(self, node):
        return [[True] for _ in node.inputs]


make_vector = MakeVector()


def as_tensor_or_make_vector(entries, dtype="int64"):
    try:
        return as_tensor_variable(entries)
    except Exception:
        return MakeVector(dtype)(*entries)


class Join(Op):
    """Concatenate along an axis (PyTensor's Join:2405)."""

    __props__ = ()

    def make_node(self, axis, *tensors):
        if not tensors:
            raise ValueError("Join needs at least one tensor")
        tensors = [as_tensor_variable(t) for t in tensors]
        axis = as_tensor_variable(axis)
        ndim = tensors[0].type.ndim
        if ndim == 0:
            raise TypeError("Join cannot handle scalar arguments")
        if any(t.type.ndim != ndim for t in tensors):
            raise TypeError("Join inputs must have the same ndim")
        from pytensor_tpu_torch.scalar.basic import upcast

        out_dtype = upcast(*(t.type.dtype for t in tensors))
        try:
            static_axis = int(get_scalar_constant_value(axis))
        except NotScalarConstantError:
            static_axis = None
        if static_axis is None:
            out_shape = (None,) * ndim
        else:
            static_axis = static_axis % ndim
            out_shape = []
            for d in range(ndim):
                if d == static_axis:
                    dims = [t.type.shape[d] for t in tensors]
                    out_shape.append(None if any(x is None for x in dims) else sum(dims))
                else:
                    dims = {t.type.shape[d] for t in tensors} - {None}
                    if len(dims) > 1:
                        raise ValueError(
                            f"all input array dimensions other than the specified "
                            f"`axis` ({static_axis}) must match exactly, or be unknown "
                            f"(None), but along dimension {d}, the inputs shapes are "
                            f"incompatible: {[t.type.shape[d] for t in tensors]}"
                        )
                    out_shape.append(next(iter(dims)) if dims else None)
        out = TensorType(out_dtype, tuple(out_shape))()
        return Apply(self, [cast(axis, "int64"), *[cast(t, out_dtype) if t.type.dtype != out_dtype else t for t in tensors]], [out])

    def perform(self, node, inputs, output_storage):
        axis, *tensors = inputs
        output_storage[0][0] = np.concatenate(tensors, axis=int(axis)).astype(
            node.outputs[0].type.numpy_dtype
        )

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor import math as tm

        axis = node.inputs[0]
        n = len(node.inputs) - 1
        first = input_shapes[1]
        ndim = len(first)
        try:
            a = int(get_scalar_constant_value(axis)) % ndim
        except NotScalarConstantError:
            raise NotImplementedError("Join shape with symbolic axis")
        out = []
        for d in range(ndim):
            if d == a:
                s = input_shapes[1][d]
                for k in range(2, n + 1):
                    s = s + input_shapes[k][d]
                out.append(s)
            else:
                out.append(first[d])
        return [tuple(out)]

    def connection_pattern(self, node):
        return [[False]] + [[True] for _ in node.inputs[1:]]

    def L_op(self, inputs, outputs, output_grads):
        axis, *tensors = inputs
        (gz,) = output_grads
        from pytensor_tpu_torch.tensor.shape import shape

        sizes = [shape(t)[axis] for t in tensors]
        if len(tensors) == 1:
            gs = [gz]
        else:
            gs = split(gz, stack(sizes), len(tensors), axis)
            if len(tensors) == 1:
                gs = [gs]
        rval = [DisconnectedType()()]
        for t, g in zip(tensors, gs):
            if dtype_kind(t.type.dtype) in "biu":
                rval.append(DisconnectedType()())
            else:
                rval.append(cast(g, t.type.dtype) if g.type.dtype != t.type.dtype else g)
        return rval


join_ = Join()


def join(axis, *tensors):
    if len(tensors) == 1:
        return as_tensor_variable(tensors[0])
    return join_(axis, *tensors)


def concatenate(tensors, axis=0):
    return join(axis, *tensors)


class Split(Op):
    """Split along an axis into ``len_splits`` parts (PyTensor's Split:2203)."""

    __props__ = ("len_splits",)

    def __init__(self, len_splits: int):
        self.len_splits = int(len_splits)

    def make_node(self, x, axis, splits):
        x = as_tensor_variable(x)
        axis = cast(as_tensor_variable(axis), "int64")
        splits = cast(as_tensor_variable(splits), "int64")
        if splits.type.ndim != 1:
            raise TypeError("splits must be a vector")
        try:
            a = int(get_scalar_constant_value(axis)) % x.type.ndim
        except NotScalarConstantError:
            a = None
        outs = []
        for _ in range(self.len_splits):
            shp = tuple(
                None if (a is None or d == a) else s
                for d, s in enumerate(x.type.shape)
            )
            outs.append(TensorType(x.type.dtype, shp)())
        return Apply(self, [x, axis, splits], outs)

    def perform(self, node, inputs, output_storage):
        x, axis, splits = inputs
        if len(splits) != self.len_splits:
            raise ValueError("wrong number of splits")
        if np.any(np.asarray(splits) < 0):
            raise ValueError("split sizes must be non-negative")
        if np.sum(splits) != x.shape[int(axis) % x.ndim]:
            raise ValueError(
                f"split sizes sum to {int(np.sum(splits))}, expected "
                f"{x.shape[int(axis) % x.ndim]} along axis {int(axis)}"
            )
        idx = np.cumsum(splits[:-1])
        for s, out in zip(np.split(x, idx, axis=int(axis)), output_storage):
            out[0] = s

    def infer_shape(self, fgraph, node, input_shapes):
        xshp, _, _ = input_shapes
        splits = node.inputs[2]
        try:
            a = int(get_scalar_constant_value(node.inputs[1]))
        except NotScalarConstantError:
            raise NotImplementedError()
        out = []
        for i in range(self.len_splits):
            shp = list(xshp)
            shp[a] = splits[i]
            out.append(tuple(shp))
        return out

    def connection_pattern(self, node):
        return [[True] * self.len_splits, [False] * self.len_splits,
                [False] * self.len_splits]

    def L_op(self, inputs, outputs, output_grads):
        x, axis, splits = inputs
        from pytensor_tpu_torch.gradient import DisconnectedType as _Disc

        gs = []
        for out, gz in zip(outputs, output_grads):
            if isinstance(gz.type, (DisconnectedType,)):
                gs.append(zeros_like(out))
            elif hasattr(gz.type, "why_null"):
                return [gz, DisconnectedType()(), DisconnectedType()()]
            else:
                gs.append(gz)
        return [join(axis, *gs) if len(gs) > 1 else gs[0],
                DisconnectedType()(), DisconnectedType()()]


def split(x, splits_size, n_splits, axis=0):
    # a statically known splits_size length must match n_splits — fail at
    # graph build (the PyTensor's JAX linker only catches it at runtime:
    # test_runtime_errors)
    if isinstance(splits_size, (list, tuple)):
        if len(splits_size) != int(n_splits):
            raise ValueError(
                f"Length of splits is not equal to n_splits: "
                f"{len(splits_size)} vs {n_splits}")
    elif isinstance(splits_size, Variable) \
            and splits_size.type.ndim == 1 \
            and splits_size.type.shape[0] is not None \
            and splits_size.type.shape[0] != int(n_splits):
        raise ValueError(
            f"Length of splits is not equal to n_splits: "
            f"{splits_size.type.shape[0]} vs {n_splits}")
    out = Split(n_splits)(x, axis, splits_size)
    if n_splits == 1:
        return [out]
    return out


def stack(tensors, axis=0):
    if isinstance(tensors, Variable):
        raise TypeError("stack expects a list of tensors")
    tensors = [as_tensor_variable(t) for t in tensors]
    if not tensors:
        raise ValueError("stack needs at least one tensor")
    if all(t.type.ndim == 0 for t in tensors) and axis == 0:
        from pytensor_tpu_torch.scalar.basic import upcast

        dtype = upcast(*(t.type.dtype for t in tensors))
        return MakeVector(dtype)(*tensors)
    expanded = [shape_padaxis(t, axis) for t in tensors]
    return join(axis, *expanded)


def shape_padleft(t, n_ones=1):
    t = as_tensor_variable(t)
    pattern = ["x"] * n_ones + list(range(t.type.ndim))
    return DimShuffle(t.type.ndim, pattern)(t)


def shape_padright(t, n_ones=1):
    t = as_tensor_variable(t)
    pattern = list(range(t.type.ndim)) + ["x"] * n_ones
    return DimShuffle(t.type.ndim, pattern)(t)


def shape_padaxis(t, axis):
    t = as_tensor_variable(t)
    ndim = t.type.ndim + 1
    if not -ndim <= axis < ndim:
        raise IndexError(f"axis {axis} out of range")
    axis = axis % ndim
    pattern = list(range(t.type.ndim))
    pattern.insert(axis, "x")
    return DimShuffle(t.type.ndim, pattern)(t)


def expand_dims(x, axis):
    x = as_tensor_variable(x)
    if isinstance(axis, (int, np.integer)):
        axis = (axis,)
    out_ndim = x.type.ndim + len(axis)
    axis = tuple(a % out_ndim for a in axis)
    pattern = []
    j = 0
    for d in range(out_ndim):
        if d in axis:
            pattern.append("x")
        else:
            pattern.append(j)
            j += 1
    return DimShuffle(x.type.ndim, pattern)(x)


def transpose(x, axes=None):
    x = as_tensor_variable(x)
    if axes is None:
        axes = tuple(range(x.type.ndim - 1, -1, -1))
    return DimShuffle(x.type.ndim, tuple(int(a) % x.type.ndim for a in axes))(x)


def matrix_transpose(x):
    x = as_tensor_variable(x)
    if x.type.ndim < 2:
        raise ValueError("matrix_transpose needs ndim >= 2")
    axes = list(range(x.type.ndim))
    axes[-1], axes[-2] = axes[-2], axes[-1]
    return transpose(x, axes)


def swapaxes(x, axis1, axis2):
    x = as_tensor_variable(x)
    axes = list(range(x.type.ndim))
    axes[axis1], axes[axis2] = axes[axis2], axes[axis1]
    return transpose(x, axes)


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


def atleast_1d(*args):
    res = [shape_padleft(a, 1 - a.type.ndim) if as_tensor_variable(a).type.ndim < 1
           else as_tensor_variable(a) for a in (as_tensor_variable(x) for x in args)]
    return res[0] if len(res) == 1 else res


def atleast_2d(*args):
    res = []
    for a in args:
        a = as_tensor_variable(a)
        if a.type.ndim < 2:
            a = shape_padleft(a, 2 - a.type.ndim)
        res.append(a)
    return res[0] if len(res) == 1 else res


def atleast_Nd(x, n=1, left=True):
    x = as_tensor_variable(x)
    if x.type.ndim >= n:
        return x
    return shape_padleft(x, n - x.type.ndim) if left else shape_padright(x, n - x.type.ndim)


def _oriented_stack_args(args):
    # deliberately stricter than numpy's hstack/vstack (which are
    # incoherent on 1-D inputs): >=2 args, all matrices (PyTensor's
    # tensor/basic.py:2898 comment)
    if len(args) < 2:
        raise ValueError("Too few arguments")
    _args = [as_tensor_variable(a) for a in args]
    if any(a.type.ndim != 2 for a in _args):
        raise ValueError("All arguments must have two dimensions")
    return _args


def horizontal_stack(*args):
    return concatenate(_oriented_stack_args(args), axis=1)


def vertical_stack(*args):
    return concatenate(_oriented_stack_args(args), axis=0)


# ---------------------------------------------------------------------------
# ARange / Eye / diag
# ---------------------------------------------------------------------------

class ARange(Op):
    """np.arange as an op; the output length depends on the bounds
    (PyTensor's ARange:3139).  The torch lowering reads them on the host."""

    __props__ = ("dtype",)

    def __init__(self, dtype):
        self.dtype = str(dtype)

    def make_node(self, start, stop, step):
        start, stop, step = (as_tensor_variable(v) for v in (start, stop, step))
        static = None
        try:
            sa = get_scalar_constant_value(start)
            so = get_scalar_constant_value(stop)
            se = get_scalar_constant_value(step)
            static = len(np.arange(sa, so, se))
        except NotScalarConstantError:
            pass
        out = TensorType(self.dtype, (static,))()
        return Apply(self, [start, stop, step], [out])

    def perform(self, node, inputs, output_storage):
        start, stop, step = inputs
        output_storage[0][0] = np.arange(start, stop, step, dtype=_np_dtype(self.dtype))

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor import math as tm

        start, stop, step = node.inputs
        n = tm.maximum(
            cast(tm.ceil(cast(stop - start, "float64") / cast(step, "float64")), "int64"),
            constant(np.int64(0)),
        )
        return [(n,)]

    def connection_pattern(self, node):
        return [[False], [False], [False]]

    def L_op(self, inputs, outputs, output_grads):
        return [DisconnectedType()() for _ in inputs]


_arange_cache: dict = {}


def arange(start, stop=None, step=1, dtype=None):
    if stop is None:
        start, stop = 0, start
    if dtype is None:
        if all(isinstance(v, (int, np.integer)) for v in (start, stop, step)):
            dtype = "int64"  # literal bounds: index-friendly dtype
        else:
            start_, stop_, step_ = (as_tensor_variable(v) for v in (start, stop, step))
            from pytensor_tpu_torch.scalar.basic import upcast

            dtype = upcast(start_.type.dtype, stop_.type.dtype, step_.type.dtype)
            if dtype in ("int8", "int16", "int32"):
                dtype = "int64"
    if dtype not in _arange_cache:
        _arange_cache[dtype] = ARange(dtype)
    return _arange_cache[dtype](start, stop, step)


class Eye(Op):
    __props__ = ("dtype",)

    def __init__(self, dtype=None):
        self.dtype = str(dtype or config.floatX)

    def make_node(self, n, m, k):
        n, m, k = (cast(as_tensor_variable(v), "int64") for v in (n, m, k))
        sn = sm = None
        try:
            sn = int(get_scalar_constant_value(n))
        except NotScalarConstantError:
            pass
        try:
            sm = int(get_scalar_constant_value(m))
        except NotScalarConstantError:
            pass
        out = TensorType(self.dtype, (sn, sm))()
        return Apply(self, [n, m, k], [out])

    def perform(self, node, inputs, output_storage):
        n, m, k = inputs
        output_storage[0][0] = np.eye(int(n), int(m), int(k), dtype=_np_dtype(self.dtype))

    def infer_shape(self, fgraph, node, input_shapes):
        return [(node.inputs[0], node.inputs[1])]

    def connection_pattern(self, node):
        return [[False]] * 3

    def L_op(self, inputs, outputs, output_grads):
        return [DisconnectedType()() for _ in inputs]


def eye(n, m=None, k=0, dtype=None):
    if m is None:
        m = n
    return Eye(dtype)(n, m, k)


def identity_like(x, dtype=None):
    x = as_tensor_variable(x)
    from pytensor_tpu_torch.tensor.shape import shape

    return eye(shape(x)[0], shape(x)[1], 0, dtype or x.type.dtype)


def tri(n, m=None, k=0, dtype=None):
    if m is None:
        m = n
    from pytensor_tpu_torch.tensor import math as tm

    r = shape_padright(arange(n, dtype="int64"), 1)
    c = shape_padleft(arange(m, dtype="int64"), 1)
    return cast(tm.ge(r + k, c), dtype or config.floatX)


def tril(x, k=0):
    x = as_tensor_variable(x)
    from pytensor_tpu_torch.tensor.shape import shape
    from pytensor_tpu_torch.tensor import math as tm

    mask = tri(shape(x)[-2], shape(x)[-1], k=k, dtype="bool")
    return tm.switch(mask, x, zeros_like(x))


def triu(x, k=0):
    x = as_tensor_variable(x)
    from pytensor_tpu_torch.tensor.shape import shape
    from pytensor_tpu_torch.tensor import math as tm

    mask = tri(shape(x)[-2], shape(x)[-1], k=k - 1, dtype="bool")
    return tm.switch(mask, zeros_like(x), x)


class ExtractDiag(Op):
    """View of the k-th diagonal (PyTensor's ExtractDiag:3636)."""

    __props__ = ("offset", "axis1", "axis2")
    view_map = {0: [0]}

    def __init__(self, offset=0, axis1=0, axis2=1):
        self.offset = int(offset)
        self.axis1 = int(axis1)
        self.axis2 = int(axis2)

    def make_node(self, x):
        x = as_tensor_variable(x)
        if x.type.ndim < 2:
            raise TypeError("ExtractDiag needs ndim >= 2")
        a1, a2 = self.axis1 % x.type.ndim, self.axis2 % x.type.ndim
        in_shape = x.type.shape
        base = [s for d, s in enumerate(in_shape) if d not in (a1, a2)]
        d1, d2 = in_shape[a1], in_shape[a2]
        if d1 is None or d2 is None:
            diag_len = None
        else:
            diag_len = max(0, min(d1 + min(0, self.offset), d2 - max(0, self.offset)))
        out = TensorType(x.type.dtype, (*base, diag_len))()
        return Apply(self, [x], [out])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        output_storage[0][0] = np.diagonal(x, self.offset, self.axis1, self.axis2).copy()

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor import math as tm

        (ishp,) = input_shapes
        x = node.inputs[0]
        a1, a2 = self.axis1 % x.type.ndim, self.axis2 % x.type.ndim
        base = [s for d, s in enumerate(ishp) if d not in (a1, a2)]
        d1, d2 = ishp[a1], ishp[a2]
        k = self.offset
        if k >= 0:
            dl = tm.maximum(constant(np.int64(0)), tm.minimum(d1, d2 - k))
        else:
            dl = tm.maximum(constant(np.int64(0)), tm.minimum(d1 + k, d2))
        return [(*base, dl)]

    def L_op(self, inputs, outputs, output_grads):
        # scatter the diag cotangent back; general ndim/axes by moving
        # (axis1, axis2) last (numpy's diagonal appends the diag axis last)
        (x,) = inputs
        (gz,) = output_grads
        from pytensor_tpu_torch.tensor.shape import shape
        from pytensor_tpu_torch.tensor.subtensor import set_subtensor

        nd = x.type.ndim
        a1, a2 = self.axis1 % nd, self.axis2 % nd
        rest = [d for d in range(nd) if d not in (a1, a2)]
        perm = rest + [a1, a2]
        xt = transpose(x, perm)
        z = zeros_like(xt)
        ar = arange(shape(gz)[-1])
        if self.offset >= 0:
            rows, cols = ar, ar + self.offset
        else:
            rows, cols = ar - self.offset, ar
        idx = (slice(None),) * len(rest) + (rows, cols)
        g = set_subtensor(z[idx], gz)
        inv = [perm.index(d) for d in range(nd)]
        return [transpose(g, inv)]


def diagonal(x, offset=0, axis1=0, axis2=1):
    return ExtractDiag(offset, axis1, axis2)(x)


def diag(v, k=0):
    v = as_tensor_variable(v)
    if v.type.ndim == 1:
        # eye-mask and broadcast: elementwise only, so it fuses
        from pytensor_tpu_torch.tensor.shape import shape

        m = v.type.shape[0]
        n = m + abs(int(k)) if m is not None \
            else shape(v)[0] + int(np.abs(k))
        from pytensor_tpu_torch.tensor.math import switch

        # select (not multiply) so non-finite entries in v stay confined
        # to the diagonal: mask*v would give 0*inf=nan off-diagonal
        mask = eye(n, n, k, dtype="bool")
        zero = as_tensor_variable(np.zeros((), dtype=v.type.dtype))
        if k == 0:
            w = v
        else:
            w = join(0, zeros((abs(int(k)),), dtype=v.type.dtype), v)
        if k >= 0:
            # value sits at column j = i + k: broadcast along rows
            return switch(mask, w.dimshuffle("x", 0), zero)
        # k < 0: value sits at row i = j - k: broadcast along columns
        return switch(mask, w.dimshuffle(0, "x"), zero)
    elif v.type.ndim == 2:
        return diagonal(v, offset=k, axis1=-2, axis2=-1)
    raise ValueError("Input must be 1- or 2-d.")


def alloc_diag(v, offset=0, axis1=0, axis2=1):
    return diag(v, k=offset)


def trace(x, offset=0, axis1=0, axis2=1):
    from pytensor_tpu_torch.tensor import math as tm

    return tm.sum(diagonal(x, offset, axis1, axis2), axis=-1)


# ---------------------------------------------------------------------------
# Nonzero (its output length depends on the data)
# ---------------------------------------------------------------------------

class Nonzero(Op):
    """Indices of nonzero elements; output shape is data dependent
    (PyTensor's Nonzero:960).  A plan that holds it is never captured
    into a CUDA graph."""

    __props__ = ()

    def make_node(self, a):
        a = as_tensor_variable(a)
        outs = [TensorType("int64", (None,))() for _ in range(a.type.ndim)]
        return Apply(self, [a], outs)

    def perform(self, node, inputs, output_storage):
        res = np.nonzero(inputs[0])
        for s, r in zip(output_storage, res):
            s[0] = r.astype("int64")

    def connection_pattern(self, node):
        return [[False] * len(node.outputs)]


_nonzero = Nonzero()


def nonzero(a, return_matrix=False):
    a = as_tensor_variable(a)
    if a.type.ndim == 0:
        raise ValueError("nonzero is not defined for 0-d arrays")
    res = _nonzero(a)
    if isinstance(res, Variable):
        res = [res]
    if return_matrix:
        return stack(res, axis=0)
    return tuple(res)


def flatnonzero(a):
    from pytensor_tpu_torch.tensor.shape import flatten

    return nonzero(flatten(a))[0]


def nonzero_values(a):
    from pytensor_tpu_torch.tensor.shape import flatten

    af = flatten(a)
    return af[nonzero(af)[0]]


def where(cond, x=None, y=None):
    if x is None and y is None:
        return nonzero(cond)
    if x is None or y is None:
        raise ValueError("where() takes exactly 1 or 3 arguments")
    from pytensor_tpu_torch.tensor import math as tm

    return tm.switch(cond, x, y)


def tile(x, reps):
    x = as_tensor_variable(x)
    if isinstance(reps, (int, np.integer)):
        reps = (reps,)
    if isinstance(reps, (float, np.floating)):
        raise ValueError("tile reps must be integers")
    if isinstance(reps, Variable):
        raise NotImplementedError("symbolic reps not supported; pass a tuple")
    if any(not isinstance(r, (int, np.integer)) or isinstance(r, bool)
           for r in reps):
        raise ValueError(f"tile reps must be integers, got {reps!r}")
    reps = tuple(int(r) for r in reps)
    if len(reps) < x.type.ndim:
        reps = (1,) * (x.type.ndim - len(reps)) + reps
    if len(reps) > x.type.ndim:
        x = shape_padleft(x, len(reps) - x.type.ndim)
    from pytensor_tpu_torch.tensor.shape import shape, reshape
    from pytensor_tpu_torch.tensor import math as tm

    # tile dim-by-dim: x -> expand 'x' before dim, alloc, reshape merge
    out = x
    for d, r in enumerate(reps):
        if r == 1:
            continue
        e = expand_dims(out, d)
        shp = [shape(out)[i] for i in range(out.type.ndim)]
        alloc_shape = shp[:d] + [constant(np.int64(r))] + shp[d:]
        tiled = alloc(e, *alloc_shape)
        new_shape = shp[:d] + [shp[d] * r] + shp[d + 1:]
        out = reshape(tiled, new_shape)
    return out


def flatten_list(x):
    return x


def meshgrid(*xi, indexing="xy"):
    """Symbolic np.meshgrid (PyTensor's tensor/basic.py meshgrid)."""
    if indexing not in ("xy", "ij"):
        raise ValueError("indexing must be 'xy' or 'ij'")
    args = [as_tensor_variable(x) for x in xi]
    if any(a.type.ndim != 1 for a in args):
        raise ValueError("meshgrid expects 1d inputs")
    n = len(args)
    outs = []
    for k, a in enumerate(args):
        idx = [None] * n
        idx[k] = slice(None)
        outs.append(a[tuple(idx)])
    if indexing == "xy" and n >= 2:
        outs = ([outs[0].swapaxes(0, 1)] + [outs[1].swapaxes(0, 1)]
                + outs[2:])
    return _broadcast_arrays(outs)


class _Grid:
    """``mgrid``/``ogrid`` index helpers (PyTensor's tensor/basic.py:3339):
    ``mgrid[0:5, 0:3]`` builds dense symbolic coordinate grids, ``ogrid``
    builds open (broadcastable singleton) ones."""

    def __init__(self, sparse):
        self.sparse = sparse

    def __getitem__(self, key):
        if not isinstance(key, tuple):
            key = (key,)
        ranges = []
        for sl in key:
            if not isinstance(sl, slice):
                raise NotImplementedError("mgrid/ogrid take slices")
            start = 0 if sl.start is None else sl.start
            step = 1 if sl.step is None else sl.step
            ranges.append(arange(start, sl.stop, step))
        from pytensor_tpu_torch.scalar.basic import upcast

        dtype = upcast(*[r.type.dtype for r in ranges])
        ranges = [r.astype(dtype) for r in ranges]
        n = len(ranges)
        outs = []
        for k, r in enumerate(ranges):
            idx = [None] * n
            idx[k] = slice(None)
            outs.append(r[tuple(idx)])
        if self.sparse:
            return outs if n > 1 else outs[0]
        dense = _broadcast_arrays(outs)
        if n == 1:
            return dense[0]
        return stack(dense, axis=0)


mgrid = _Grid(sparse=False)
ogrid = _Grid(sparse=True)


def _broadcast_arrays(tensors):
    """Each tensor broadcast against all the others (``second``); the
    JAX package takes ``extra_ops.broadcast_arrays``, which the port has
    not yet."""
    from pytensor_tpu_torch.tensor import math as tm

    out = []
    for k, t in enumerate(tensors):
        for m, other in enumerate(tensors):
            if m != k:
                t = tm.second(other, t)
        out.append(t)
    return out

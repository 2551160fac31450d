"""Extra ops: cumsum/cumprod, repeat, unique, searchsorted, diff, etc.

Counterpart of ``pytensor_tpu/tensor/extra_ops.py``, all of it
(PyTensor's tensor/extra_ops.py CumOp:286, Repeat:622, Unique:1163,
SearchsortedOp:111, UnravelIndex:1285, RavelMultiIndex:1362).  The torch
lowerings of the ops live in ``link/torch/dispatch.py`` (section
"extra_ops"): ``Repeat`` needs concrete counts and ``Unique`` raises when
it is linked (its output shape depends on the data), as in the JAX
package; ``RavelMultiIndex(mode="raise")`` raises on an entry out of
bounds, as the numpy oracle does, where the JAX package's XLA path clips.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply, Variable
from pytensor_tpu_torch.graph.null_type import DisconnectedType
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.tensor.basic import (
    arange,
    as_tensor_variable,
    cast,
    constant,
    stack,
    zeros_like,
)
from pytensor_tpu_torch.tensor.elemwise import DimShuffle
from pytensor_tpu_torch.tensor.type import TensorType


class CumOp(Op):
    __props__ = ("axis", "mode")

    def __init__(self, axis=None, mode="add"):
        self.axis = None if axis is None else int(axis)
        if mode not in ("add", "mul"):
            raise ValueError("mode must be add or mul")
        self.mode = mode

    def make_node(self, x):
        x = as_tensor_variable(x)
        if self.axis is None:
            shp = (int(np.prod([s for s in x.type.shape]))
                   if all(s is not None for s in x.type.shape) else None,)
            out = TensorType(x.type.dtype, shp)()
        else:
            out = TensorType(x.type.dtype, x.type.shape)()
        return Apply(self, [x], [out])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        fn = np.cumsum if self.mode == "add" else np.cumprod
        output_storage[0][0] = fn(x, axis=self.axis).astype(
            node.outputs[0].type.numpy_dtype
        )

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor import math as tm

        (ishp,) = input_shapes
        if self.axis is None:
            total = constant(np.int64(1))
            for s in ishp:
                total = total * s
            return [(total,)]
        return [tuple(ishp)]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.tensor.subtensor import flip

        (x,) = inputs
        (gz,) = output_grads
        if self.mode == "add":
            if self.axis is None:
                from pytensor_tpu_torch.tensor.shape import reshape, shape

                g = flip(CumOp(None, "add")(flip(gz, 0)), 0)
                return [reshape(g, [shape(x)[i] for i in range(x.type.ndim)],
                                ndim=x.type.ndim)]
            return [flip(CumOp(self.axis, "add")(flip(gz, self.axis)), self.axis)]
        # cumprod grad: reverse-cumsum of gz*out, divided by x
        (out,) = outputs
        if self.axis is None:
            from pytensor_tpu_torch.tensor.shape import reshape, shape

            g = flip(CumOp(None, "add")(flip(gz * out, 0)), 0) / x.flatten()
            return [reshape(g, [shape(x)[i] for i in range(x.type.ndim)],
                            ndim=x.type.ndim)]
        g = flip(CumOp(self.axis, "add")(flip(gz * out, self.axis)), self.axis) / x
        return [g]


def cumsum(x, axis=None):
    return CumOp(axis, "add")(x)


def cumprod(x, axis=None):
    return CumOp(axis, "mul")(x)


def diff(x, n=1, axis=-1):
    x = as_tensor_variable(x)
    if x.type.ndim == 0:
        raise ValueError(
            "diff requires input that is at least one dimensional")
    for _ in range(n):
        nd = x.type.ndim
        a = axis % nd
        sl1 = [slice(None)] * nd
        sl2 = [slice(None)] * nd
        sl1[a] = slice(1, None)
        sl2[a] = slice(None, -1)
        x = x[tuple(sl1)] - x[tuple(sl2)]
    return x


def squeeze(x, axis=None):
    x = as_tensor_variable(x)
    if axis is None:
        axis = tuple(d for d, s in enumerate(x.type.shape) if s == 1)
    elif isinstance(axis, (int, np.integer)):
        axis = (axis % x.type.ndim,)
    else:
        axis = tuple(a % x.type.ndim for a in axis)
    for a in axis:
        if x.type.shape[a] != 1:
            raise ValueError(f"cannot squeeze non-unit dim {a} of {x.type}")
    if not axis:
        return x
    pattern = [d for d in range(x.type.ndim) if d not in axis]
    return DimShuffle(x.type.ndim, pattern)(x)


class Repeat(Op):
    __props__ = ("axis",)

    def __init__(self, axis=None):
        self.axis = None if axis is None else int(axis)

    def make_node(self, x, repeats):
        x = as_tensor_variable(x)
        repeats = as_tensor_variable(repeats)
        if self.axis is None:
            shp = (None,)
        else:
            shp = tuple(None if d == self.axis else s
                        for d, s in enumerate(x.type.shape))
        out = TensorType(x.type.dtype, shp)()
        return Apply(self, [x, repeats], [out])

    def perform(self, node, inputs, output_storage):
        x, repeats = inputs
        output_storage[0][0] = np.repeat(x, repeats, axis=self.axis)

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor import math as tm

        xshp, rshp = input_shapes
        x, repeats = node.inputs
        if self.axis is None:
            total = constant(np.int64(1))
            for s in xshp:
                total = total * s
            if repeats.type.ndim == 0:
                return [(total * cast(repeats, "int64"),)]
            return [(tm.sum(cast(repeats, "int64")),)]
        out = list(xshp)
        if repeats.type.ndim == 0:
            out[self.axis] = out[self.axis] * cast(repeats, "int64")
        else:
            out[self.axis] = tm.sum(cast(repeats, "int64"))
        return [tuple(out)]

    def connection_pattern(self, node):
        return [[True], [False]]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import grad_not_implemented
        from pytensor_tpu_torch.tensor import math as tm
        from pytensor_tpu_torch.tensor.basic import NotScalarConstantError, get_scalar_constant_value
        from pytensor_tpu_torch.tensor.shape import reshape, shape

        x, repeats = inputs
        (gz,) = output_grads
        try:
            r = int(get_scalar_constant_value(repeats))
        except NotScalarConstantError:
            return [grad_not_implemented(self, 0, x, "symbolic repeats"),
                    DisconnectedType()()]
        if self.axis is None:
            g = reshape(gz, [x.size, r], ndim=2).sum(axis=1)
            g = reshape(g, [shape(x)[i] for i in range(x.type.ndim)], ndim=x.type.ndim)
            return [g, DisconnectedType()()]
        a = self.axis % x.type.ndim
        shp = [shape(x)[i] for i in range(x.type.ndim)]
        new_shape = shp[:a] + [shp[a], r] + shp[a + 1:]
        g = reshape(gz, new_shape, ndim=x.type.ndim + 1).sum(axis=a + 1)
        return [g, DisconnectedType()()]


def repeat(x, repeats, axis=None):
    x = as_tensor_variable(x)
    if axis is None and x.type.ndim != 1:
        from pytensor_tpu_torch.tensor.shape import flatten

        x = flatten(x)
    return Repeat(None if axis is None else axis % x.type.ndim)(x, repeats)


class Unique(Op):
    """np.unique; dynamic output shape — oracle only under XLA."""

    __props__ = ("return_index", "return_inverse", "return_counts", "axis")

    def __init__(self, return_index=False, return_inverse=False,
                 return_counts=False, axis=None):
        self.return_index = return_index
        self.return_inverse = return_inverse
        self.return_counts = return_counts
        self.axis = axis

    def make_node(self, x):
        x = as_tensor_variable(x)
        out_ndim = x.type.ndim if self.axis is not None else 1
        outs = [TensorType(x.type.dtype, (None,) * out_ndim)()]
        if self.return_index:
            outs.append(TensorType("int64", (None,))())
        if self.return_inverse:
            inv_ndim = 1 if self.axis is not None else x.type.ndim
            outs.append(TensorType("int64", (None,) * max(1, inv_ndim))())
        if self.return_counts:
            outs.append(TensorType("int64", (None,))())
        return Apply(self, [x], outs)

    def perform(self, node, inputs, output_storage):
        res = np.unique(inputs[0], return_index=self.return_index,
                        return_inverse=self.return_inverse,
                        return_counts=self.return_counts, axis=self.axis)
        if not isinstance(res, tuple):
            res = (res,)
        for s, r in zip(output_storage, res):
            s[0] = np.asarray(r)


def unique(x, return_index=False, return_inverse=False, return_counts=False, axis=None):
    return Unique(return_index, return_inverse, return_counts, axis)(x)


class SearchsortedOp(Op):
    __props__ = ("side",)

    def __init__(self, side="left"):
        self.side = side

    def make_node(self, a, v, sorter=None):
        a = as_tensor_variable(a)
        v = as_tensor_variable(v)
        inputs = [a, v]
        if sorter is not None:
            inputs.append(as_tensor_variable(sorter))
        out = TensorType("int64", v.type.shape)()
        return Apply(self, inputs, [out])

    def perform(self, node, inputs, output_storage):
        a, v, *rest = inputs
        sorter = rest[0] if rest else None
        output_storage[0][0] = np.searchsorted(a, v, side=self.side,
                                               sorter=sorter).astype("int64")

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[1]]

    def connection_pattern(self, node):
        return [[False] for _ in node.inputs]


def searchsorted(a, v, side="left", sorter=None):
    return SearchsortedOp(side)(a, v, sorter)


def bincount(x, weights=None, minlength=None):
    from pytensor_tpu_torch.tensor import math as tm
    from pytensor_tpu_torch.tensor.subtensor import AdvancedIncSubtensor1
    from pytensor_tpu_torch.tensor.basic import zeros

    x = as_tensor_variable(x)
    if minlength is None:
        raise NotImplementedError(
            "bincount needs a static minlength (dynamic output shape)"
        )
    n = int(minlength)
    if weights is None:
        vals = as_tensor_variable(np.ones((), dtype="int64"))
        out = zeros((n,), dtype="int64")
        from pytensor_tpu_torch.tensor.basic import ones_like

        w = cast(ones_like(x, dtype="int64"), "int64")
    else:
        w = as_tensor_variable(weights)
        out = zeros((n,), dtype=w.type.dtype)
    return AdvancedIncSubtensor1(set_instead_of_inc=False)(out, w, cast(x, "int64"))


def broadcast_to(x, shape):
    from pytensor_tpu_torch.tensor.basic import alloc

    x = as_tensor_variable(x)
    if isinstance(shape, (list, tuple)):
        return alloc(x, *shape)
    return alloc(x, shape)


def broadcast_arrays(*args):
    from pytensor_tpu_torch.tensor import math as tm

    args = [as_tensor_variable(a) for a in args]
    if len(args) < 2:
        return list(args)
    # broadcast via repeated `second`
    model = args[0]
    for a in args[1:]:
        model = tm.second(a, model)  # shape broadcast carrier
    return [tm.second(model, a) for a in args]


class UnravelIndex(Op):
    __props__ = ("order",)

    def __init__(self, order="C"):
        self.order = order

    def make_node(self, indices, dims):
        indices = as_tensor_variable(indices)
        dims = as_tensor_variable(dims)
        n = dims.type.shape[0]
        if n is None:
            raise ValueError("UnravelIndex needs a static-length dims vector")
        outs = [TensorType("int64", indices.type.shape)() for _ in range(n)]
        return Apply(self, [indices, dims], outs)

    def perform(self, node, inputs, output_storage):
        indices, dims = inputs
        res = np.unravel_index(indices, tuple(int(d) for d in dims), order=self.order)
        for s, r in zip(output_storage, res):
            s[0] = np.asarray(r, dtype="int64")

    def connection_pattern(self, node):
        return [[False] * len(node.outputs), [False] * len(node.outputs)]


def unravel_index(indices, dims, order="C"):
    res = UnravelIndex(order)(indices, dims)
    if isinstance(res, Variable):
        return (res,)
    return tuple(res)


class RavelMultiIndex(Op):
    __props__ = ("mode", "order")

    def __init__(self, mode="raise", order="C"):
        self.mode = mode
        self.order = order

    def make_node(self, *inp):
        multi_index = [as_tensor_variable(i) for i in inp[:-1]]
        dims = as_tensor_variable(inp[-1])
        out = TensorType("int64", multi_index[0].type.shape)()
        return Apply(self, [*multi_index, dims], [out])

    def perform(self, node, inputs, output_storage):
        *multi_index, dims = inputs
        output_storage[0][0] = np.ravel_multi_index(
            tuple(multi_index), tuple(int(d) for d in dims),
            mode=self.mode, order=self.order
        ).astype("int64")

    def connection_pattern(self, node):
        return [[False] for _ in node.inputs]


def ravel_multi_index(multi_index, dims, mode="raise", order="C"):
    return RavelMultiIndex(mode, order)(*multi_index, dims)


def bartlett(M):
    from pytensor_tpu_torch.tensor import math as tm

    M = as_tensor_variable(M)
    n = arange(0, M, dtype="float64")
    m = cast(M, "float64")
    den = tm.maximum(m - 1.0, 1.0)  # M == 1: numpy returns [1.], not 0/0
    left = 2.0 * n / den
    right = 2.0 - 2.0 * n / den
    win = tm.switch(tm.le(n, (m - 1) / 2.0), left, right)
    return tm.switch(tm.eq(m, 1.0), win + 1.0, win)


def fill_diagonal(a, val):
    from pytensor_tpu_torch.tensor import math as tm
    from pytensor_tpu_torch.tensor.basic import eye
    from pytensor_tpu_torch.tensor.shape import shape

    a = as_tensor_variable(a)
    if a.type.ndim != 2:
        raise ValueError("fill_diagonal expects a matrix")
    mask = cast(eye(shape(a)[0], shape(a)[1], 0, dtype="int8"), "bool")
    return tm.switch(mask, cast(as_tensor_variable(val), a.type.dtype), a)


def fill_diagonal_offset(a, val, offset):
    from pytensor_tpu_torch.tensor import math as tm
    from pytensor_tpu_torch.tensor.basic import eye
    from pytensor_tpu_torch.tensor.shape import shape

    a = as_tensor_variable(a)
    mask = cast(eye(shape(a)[0], shape(a)[1], offset, dtype="int8"), "bool")
    return tm.switch(mask, cast(as_tensor_variable(val), a.type.dtype), a)


def compress(condition, x, axis=None):
    from pytensor_tpu_torch.tensor.basic import nonzero

    x = as_tensor_variable(x)
    idx = nonzero(condition)[0]
    from pytensor_tpu_torch.tensor.subtensor import take

    return take(x, idx, axis=axis)


def geomspace(start, end, steps, base=10.0):
    from pytensor_tpu_torch.tensor import math as tm

    start, end = as_tensor_variable(start), as_tensor_variable(end)
    return base ** linspace(tm.log(start) / np.log(base), tm.log(end) / np.log(base), steps)


def linspace(start, end, steps, endpoint=True):
    from pytensor_tpu_torch.tensor import math as tm

    start = cast(as_tensor_variable(start), "float64")
    end = cast(as_tensor_variable(end), "float64")
    arr = arange(0, steps, dtype="float64")
    denom = cast(as_tensor_variable(steps), "float64") - (1.0 if endpoint else 0.0)
    return start + arr * (end - start) / denom


def logspace(start, end, steps, base=10.0, endpoint=True):
    return base ** linspace(start, end, steps, endpoint=endpoint)


# --- the names PyTensor's tensor.extra_ops also holds --------------------------
_PARENT_REEXPORTS = frozenset({"broadcast_shape", "concat_with_broadcast"})


def __getattr__(name):
    if name in _PARENT_REEXPORTS:
        import pytensor_tpu_torch.tensor as _t

        return getattr(_t, name)
    raise AttributeError(
        f"module {__name__!r} has no attribute {name!r}")

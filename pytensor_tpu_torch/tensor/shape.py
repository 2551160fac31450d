"""Shape ops: Shape, Shape_i, SpecifyShape, Reshape.

Counterpart of ``pytensor_tpu/tensor/shape.py`` (PyTensor's
tensor/shape.py Shape:53, Shape_i:201, SpecifyShape:369, Unbroadcast,
Reshape:613).
The torch linker keeps shape values on the host, so shape arithmetic
never waits on the device.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable
from pytensor_tpu_torch.graph.null_type import DisconnectedType
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.tensor.type import TensorType


class ShapeError(Exception):
    pass


class Shape(Op):
    """shape(x) as an int64 vector."""

    __props__ = ()
    _output_type = None

    def make_node(self, x):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        x = as_tensor_variable(x)
        out = TensorType("int64", (x.type.ndim,))()
        return Apply(self, [x], [out])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(np.shape(inputs[0]), dtype="int64")

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor.basic import constant

        return [(constant(np.int64(node.inputs[0].type.ndim)),)]

    def connection_pattern(self, node):
        return [[False]]

    def L_op(self, inputs, outputs, output_grads):
        return [DisconnectedType()()]


_shape_op = Shape()


def shape(x):
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable

    x = as_tensor_variable(x)
    return _shape_op(x)


class Shape_i(Op):
    """shape(x)[i] as an int64 scalar (allows per-dim static folding)."""

    __props__ = ("i",)

    def __init__(self, i: int):
        self.i = int(i)

    def make_node(self, x):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        x = as_tensor_variable(x)
        if not (0 <= self.i < x.type.ndim):
            raise ValueError(f"Shape_i: axis {self.i} out of range for {x.type}")
        out = TensorType("int64", ())()
        return Apply(self, [x], [out])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(np.shape(inputs[0])[self.i], dtype="int64")

    def infer_shape(self, fgraph, node, input_shapes):
        return [()]

    def connection_pattern(self, node):
        return [[False]]

    def L_op(self, inputs, outputs, output_grads):
        return [DisconnectedType()()]


def shape_i(x, i):
    return Shape_i(i)(x)


class SpecifyShape(Op):
    """Assert/attach static shape info at runtime."""

    __props__ = ()
    view_map = {0: [0]}

    def make_node(self, x, *shape):
        from pytensor_tpu_torch.tensor.basic import (
            NotScalarConstantError,
            as_tensor_variable,
            cast,
            constant,
            get_scalar_constant_value,
        )
        from pytensor_tpu_torch.tensor.type_other import NoneConst

        x = as_tensor_variable(x)
        if len(shape) == 1 and isinstance(shape[0], (tuple, list)):
            shape = tuple(shape[0])
        if (len(shape) == 1 and isinstance(shape[0], Variable)
                and shape[0].type.ndim == 1):
            # a shape VECTOR (e.g. specify_shape(x, other.shape)) unpacks
            # into one scalar per dim
            shape = tuple(shape[0][i] for i in range(x.type.ndim))
        if len(shape) != x.type.ndim:
            raise ValueError(f"specify_shape: got {len(shape)} dims for {x.type}")
        svars = []
        static = list(x.type.shape)
        for d, s in enumerate(shape):
            if s is None:
                svars.append(NoneConst)
                continue
            if isinstance(s, (int, np.integer)):
                svars.append(constant(np.int64(s)))
                if static[d] is not None and static[d] != int(s):
                    raise ValueError(
                        f"specify_shape: dim {d} is {static[d]}, cannot specify {s}"
                    )
                static[d] = int(s)
                continue
            s = as_tensor_variable(s)
            try:
                v = int(get_scalar_constant_value(s))
                if static[d] is not None and static[d] != v:
                    raise ValueError(
                        f"specify_shape: dim {d} is {static[d]}, cannot specify {v}"
                    )
                static[d] = v
            except NotScalarConstantError:
                pass
            svars.append(cast(s, "int64") if s.type.dtype != "int64" else s)
        out = TensorType(x.type.dtype, tuple(static))()
        return Apply(self, [x, *svars], [out])

    def perform(self, node, inputs, output_storage):
        x, *shape = inputs
        for d, s in enumerate(shape):
            if s is not None and np.shape(x)[d] != int(s):
                raise AssertionError(
                    f"SpecifyShape: dim {d} of shape {np.shape(x)} != {int(s)}"
                )
        output_storage[0][0] = x

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor.type_other import NoneTypeT

        xshp = input_shapes[0]
        out = []
        for d in range(node.inputs[0].type.ndim):
            s = node.inputs[1 + d]
            if isinstance(s.type, NoneTypeT):
                out.append(xshp[d])
            else:
                out.append(s)
        return [tuple(out)]

    def connection_pattern(self, node):
        return [[True]] + [[False]] * (len(node.inputs) - 1)

    def L_op(self, inputs, outputs, output_grads):
        (gz,) = output_grads
        return [gz] + [DisconnectedType()() for _ in inputs[1:]]


_specify_shape = SpecifyShape()


def specify_shape(x, shape):
    return _specify_shape(x, *(shape if isinstance(shape, (tuple, list)) else [shape]))


def specify_broadcastable(x, *axes):
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable

    x = as_tensor_variable(x)
    shape = [1 if d in tuple(a % x.type.ndim for a in axes) else None
             for d in range(x.type.ndim)]
    keep = [s if s == 1 else x.type.shape[d] for d, s in enumerate(shape)]
    return specify_shape(x, keep)


class Reshape(Op):
    """Reshape to an ndim-length symbolic shape (PyTensor's Reshape:613)."""

    __props__ = ("ndim",)
    view_map = {0: [0]}

    def __init__(self, ndim: int):
        self.ndim = int(ndim)

    def make_node(self, x, shp):
        from pytensor_tpu_torch.tensor.basic import (
            NotScalarConstantError,
            as_tensor_variable,
            cast,
            get_scalar_constant_value,
        )

        x = as_tensor_variable(x)
        shp = as_tensor_variable(shp, ndim=1)
        shp = cast(shp, "int64") if shp.type.dtype != "int64" else shp
        static = [None] * self.ndim
        if isinstance(shp, Constant) or (shp.owner is not None):
            # try per-element folding
            entries = _try_shape_entries(shp, self.ndim)
            if entries is not None:
                for d, e in enumerate(entries):
                    try:
                        v = int(get_scalar_constant_value(e))
                        if v != -1:
                            static[d] = v
                    except NotScalarConstantError:
                        pass
        # resolve a single -1 when total size is known
        if static.count(None) == 1 and all(s is not None for s in x.type.shape):
            total = int(np.prod([s for s in x.type.shape], initial=1))
            known = int(np.prod([s for s in static if s is not None], initial=1))
            if known > 0 and total % known == 0:
                static[static.index(None)] = total // known
        out = TensorType(x.type.dtype, tuple(static))()
        return Apply(self, [x, shp], [out])

    def perform(self, node, inputs, output_storage):
        x, shp = inputs
        output_storage[0][0] = np.reshape(x, tuple(int(s) for s in shp))

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor import math as tm
        from pytensor_tpu_torch.tensor.basic import cast, constant

        shp = node.inputs[1]
        entries = _try_shape_entries(shp, self.ndim)
        if entries is None:
            entries = [shp[i] for i in range(self.ndim)]
        # handle -1: size / prod(others).  Entries that are provably
        # non-negative (shape graphs, non-negative constants) skip the
        # switch so the symbolic entry stays structurally comparable
        # (ShapeFeature.same_shape on dynamic graphs).
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable, stack

        xshp = input_shapes[0]

        def _prod(items):
            if not items:
                return constant(np.int64(1))
            acc = cast(as_tensor_variable(items[0]), "int64")
            for it in items[1:]:
                acc = acc * cast(as_tensor_variable(it), "int64")
            return acc

        out = []
        for i, e in enumerate(entries):
            e = as_tensor_variable(e)
            if _provably_nonneg(e):
                out.append(e)
                continue
            total = _prod(list(xshp) if xshp else [])
            prod_others = _prod(
                [entries[j] for j in range(self.ndim) if j != i])
            resolved = tm.switch(tm.lt(e, 0), total // prod_others, e)
            out.append(resolved)
        return [tuple(out)]

    def connection_pattern(self, node):
        return [[True], [False]]

    def L_op(self, inputs, outputs, output_grads):
        x, shp = inputs
        (gz,) = output_grads
        return [reshape(gz, shape(x), ndim=x.type.ndim), DisconnectedType()()]


def _try_shape_entries(shp, ndim):
    """Break a shape vector into per-dim scalar entries when possible."""
    from pytensor_tpu_torch.tensor.basic import MakeVector

    if isinstance(shp, Constant):
        from pytensor_tpu_torch.tensor.basic import constant as make_const

        return [make_const(np.int64(v)) for v in np.asarray(shp.data)]
    if shp.owner is not None and isinstance(shp.owner.op, MakeVector):
        return list(shp.owner.inputs)
    if shp.owner is not None and isinstance(shp.owner.op, Shape):
        x = shp.owner.inputs[0]
        return [shape_i(x, i) for i in range(x.type.ndim)]
    if shp.type.shape[0] is not None and shp.type.shape[0] == ndim:
        return [shp[i] for i in range(ndim)]
    return None


def _provably_nonneg(v, depth=0):
    """Conservative: True only when the scalar graph is certainly >= 0
    (shape queries, non-negative constants, and closed arithmetic over
    them).  Used to skip -1 handling in Reshape.infer_shape."""
    if depth > 8:
        return False
    if isinstance(v, Constant):
        try:
            return bool(np.all(np.asarray(v.data) >= 0))
        except Exception:
            return False
    if v.owner is None:
        return False
    op = v.owner.op
    if isinstance(op, (Shape, Shape_i)):
        return True
    name = getattr(getattr(op, "scalar_op", None), "name", None)
    if name in ("add", "mul", "maximum", "minimum", "int_div", "true_div"):
        return all(_provably_nonneg(i, depth + 1) for i in v.owner.inputs)
    from pytensor_tpu_torch.tensor.elemwise import DimShuffle

    if isinstance(op, DimShuffle):
        return _provably_nonneg(v.owner.inputs[0], depth + 1)
    return False


def reshape(x, newshape, ndim=None):
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable, stack, cast

    x = as_tensor_variable(x)
    if isinstance(newshape, (tuple, list)):
        if len(newshape) == 0:
            op = Reshape(0)
            from pytensor_tpu_torch.tensor.basic import constant as make_const

            return op(x, make_const(np.zeros((0,), dtype="int64")))
        parts = [as_tensor_variable(s) for s in newshape]
        newshape = stack([cast(p, "int64") for p in parts])
        ndim = len(parts)
    else:
        newshape = as_tensor_variable(newshape, ndim=1)
        if ndim is None:
            if newshape.type.shape[0] is None:
                raise ValueError(
                    "reshape: cannot infer output ndim from a shape vector of "
                    "unknown length; pass ndim explicitly"
                )
            ndim = newshape.type.shape[0]
    return Reshape(ndim)(x, newshape)


def flatten(x, ndim=1):
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable

    x = as_tensor_variable(x)
    if not 1 <= ndim <= max(1, x.type.ndim):
        raise ValueError(
            f"ndim {ndim} out of bound [1, {max(1, x.type.ndim)}]")
    if x.type.ndim == ndim:
        return x
    from pytensor_tpu_torch.tensor import math as tm

    dims = [shape_i(x, i) for i in range(ndim - 1)]
    rest = None
    if x.type.ndim == 0:
        return reshape(x, [1] * ndim)
    lead = [shape_i(x, i) for i in range(ndim - 1)]
    prod_rest = None
    from pytensor_tpu_torch.tensor.basic import constant

    rest_dims = [shape_i(x, i) for i in range(ndim - 1, x.type.ndim)]
    if rest_dims:
        prod_rest = rest_dims[0]
        for r in rest_dims[1:]:
            prod_rest = prod_rest * r
    else:
        prod_rest = constant(np.int64(1))
    return reshape(x, [*lead, prod_rest], ndim=ndim)


def shape_tuple(x):
    """Tuple of per-dim scalar shapes, folding static dims to constants."""
    from pytensor_tpu_torch.tensor.basic import constant

    x_type = x.type
    res = []
    for i, s in enumerate(x_type.shape):
        if s is not None:
            res.append(constant(np.int64(s)))
        else:
            res.append(shape_i(x, i))
    return tuple(res)


class Unbroadcast(Op):
    """Erase static-1 info on given axes (compat shim; rarely needed)."""

    __props__ = ("axes",)
    view_map = {0: [0]}

    def __init__(self, *axes):
        self.axes = tuple(sorted(int(a) for a in axes))

    def make_node(self, x):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        x = as_tensor_variable(x)
        shp = tuple(
            None if d in self.axes else s for d, s in enumerate(x.type.shape)
        )
        return Apply(self, [x], [TensorType(x.type.dtype, shp)()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = inputs[0]

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def L_op(self, inputs, outputs, output_grads):
        return [specify_shape(output_grads[0], inputs[0].type.shape)]


def unbroadcast(x, *axes):
    return Unbroadcast(*axes)(x)

"""Shape rewrites: fold static shapes to constants, lift shape queries
through the ops that compute a value, and the ShapeFeature: per-variable
symbolic shape tuples.

Counterpart of ``pytensor_tpu/tensor/rewriting/shape.py`` (PyTensor's
tensor/rewriting/shape.py ShapeFeature:70, ShapeOptimizer:420), whole:
the local rewrites in the JAX package's order, and the ShapeFeature,
attached by ``ShapeOpt`` in ``FAST_RUN`` and ``FAST_COMPILE`` and detached
by ``UnShapeOpt`` after specialize, whose ``same_shape`` queries give
graphs with ``None`` dims the shape-driven rewrites of static ones
(``local_useless_reshape`` here, ``_is_shape_of_dim`` in
``subtensor.py``).
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.compile.mode import (
    optdb,
    register_canonicalize,
    register_specialize,
    register_useless,
)
from pytensor_tpu_torch.graph.features import Feature
from pytensor_tpu_torch.graph.fg import equal_computations
from pytensor_tpu_torch.graph.rewriting.basic import GraphRewriter, copy_stack_trace, node_rewriter
from pytensor_tpu_torch.tensor.basic import MakeVector, constant
from pytensor_tpu_torch.tensor.elemwise import CAReduce as _CAReduce
from pytensor_tpu_torch.tensor.shape import Reshape, Shape, Shape_i, _try_shape_entries, shape_i
from pytensor_tpu_torch.tensor.subtensor import Subtensor


class ShapeFeature(Feature):
    """Lazily computed symbolic shape tuples per variable.

    ``shape_tuple(var)`` returns one entry per dim: a python int for a
    statically known dim, else a (loose, not-in-fgraph) int64 scalar
    graph derived through each op's ``infer_shape`` down to ``Shape_i``
    of fgraph inputs.  ``same_shape(a, b)`` decides structural equality
    of the symbolic entries — the query rewrites use to treat
    ``None``-dim graphs like static ones.

    PyTensor's tensor/rewriting/shape.py ShapeFeature:70; this version,
    as the JAX package's, is pull-based with whole-cache invalidation (the
    graph mutates far less often than shapes are queried during
    specialize).
    """

    def on_attach(self, fgraph):
        if hasattr(fgraph, "shape_feature"):
            raise RuntimeError("ShapeFeature already attached")
        fgraph.shape_feature = self
        self._cache = {}

    def on_detach(self, fgraph):
        if getattr(fgraph, "shape_feature", None) is self:
            del fgraph.shape_feature
        self._cache = {}

    def on_import(self, fgraph, node, reason):
        self._cache.clear()

    def on_prune(self, fgraph, node, reason):
        self._cache.clear()

    def on_change_input(self, fgraph, node, i, old_var, new_var,
                        reason=None):
        self._cache.clear()

    def shape_tuple(self, var, _depth=0):
        """Tuple of per-dim entries (int | int64 scalar Variable)."""
        if not hasattr(var.type, "ndim") or not hasattr(var.type, "shape"):
            return None
        cached = self._cache.get(var)
        if cached is not None:
            return cached
        static = var.type.shape
        if all(s is not None for s in static):
            out = tuple(int(s) for s in static)
            self._cache[var] = out
            return out
        out = None
        if var.owner is not None and _depth < 40:
            node = var.owner
            try:
                in_shapes = []
                for inp in node.inputs:
                    st = self.shape_tuple(inp, _depth + 1)
                    in_shapes.append(
                        None if st is None else tuple(
                            constant(np.int64(e)) if isinstance(e, int)
                            else e for e in st))
                inferred = node.op.infer_shape(None, node, in_shapes)
                idx = node.outputs.index(var)
                entries = []
                for d, e in enumerate(inferred[idx]):
                    if static[d] is not None:
                        entries.append(int(static[d]))
                        continue
                    ev = _as_int_entry(e)
                    entries.append(ev)
                out = tuple(entries)
            except Exception:
                out = None
        if out is None:
            out = tuple(
                int(s) if s is not None else shape_i(var, d)
                for d, s in enumerate(static))
        self._cache[var] = out
        return out

    def get_shape(self, var, dim):
        st = self.shape_tuple(var)
        return None if st is None else st[dim]

    def same_shape(self, a, b, dim_a=None, dim_b=None):
        """True iff the (selected dims of the) shapes are provably equal."""
        sa = self.shape_tuple(a)
        sb = self.shape_tuple(b)
        if sa is None or sb is None:
            return False
        if dim_a is not None or dim_b is not None:
            return self._entry_eq(sa[dim_a], sb[dim_b])
        if len(sa) != len(sb):
            return False
        return all(self._entry_eq(x, y) for x, y in zip(sa, sb))

    @staticmethod
    def _entry_eq(x, y):
        if isinstance(x, int) and isinstance(y, int):
            return x == y
        if isinstance(x, int) or isinstance(y, int):
            return False
        if x is y:
            return True
        try:
            return equal_computations([x], [y])
        except Exception:
            return False


def _as_int_entry(e):
    """Normalize an infer_shape entry to an int (when constant) or an
    int64 scalar Variable."""
    from pytensor_tpu_torch.graph.basic import Constant
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable, cast

    v = as_tensor_variable(e)
    if isinstance(v, Constant):
        return int(np.asarray(v.data))
    if v.type.dtype != "int64":
        v = cast(v, "int64")
    return v


class ShapeOptimizer(GraphRewriter):
    """Attach the ShapeFeature (PyTensor's ShapeOptimizer:420)."""

    def add_requirements(self, fgraph):
        if not hasattr(fgraph, "shape_feature"):
            fgraph.attach_feature(ShapeFeature())

    def apply(self, fgraph):
        pass


class UnShapeOptimizer(GraphRewriter):
    """Detach the ShapeFeature after specialize (PyTensor's :444)."""

    def apply(self, fgraph):
        feature = getattr(fgraph, "shape_feature", None)
        if feature is not None:
            fgraph.remove_feature(feature)


optdb.register("ShapeOpt", ShapeOptimizer(), "fast_run", "fast_compile",
               position=0.1)
optdb.register("UnShapeOpt", UnShapeOptimizer(), "fast_run",
               "fast_compile", position=10)


@node_rewriter([Shape_i])
def local_shape_i_to_constant(fgraph, node):
    x = node.inputs[0]
    s = x.type.shape[node.op.i]
    if s is not None:
        return [constant(np.int64(s))]
    return False


register_canonicalize(local_shape_i_to_constant, name="local_shape_i_to_constant")


@node_rewriter([Shape])
def local_shape_to_makevector(fgraph, node):
    """Shape(x) -> MakeVector(dims): splits per-dim so static dims fold."""
    x = node.inputs[0]
    if x.type.ndim == 0:
        return [constant(np.zeros((0,), dtype="int64"))]
    if all(s is None for s in x.type.shape) and x.owner is None:
        # a graph input with fully unknown shape: Shape(x) is already
        # minimal.  When x is computed, split anyway so that the per-dim
        # Shape_i entries can lift through the op (the ShapeFeature
        # propagation, PyTensor's tensor/rewriting/shape.py:70) and the
        # computation leaves shape-only graphs.
        return False
    entries = []
    for i, s in enumerate(x.type.shape):
        if s is not None:
            entries.append(constant(np.int64(s)))
        else:
            entries.append(shape_i(x, i))
    out = MakeVector("int64")(*entries)
    copy_stack_trace(node.outputs[0], out)
    return [out]


register_canonicalize(local_shape_to_makevector, name="local_shape_to_makevector")


@node_rewriter([Subtensor])
def local_subtensor_of_shape(fgraph, node):
    """shape(x)[i] -> Shape_i(x); makevector(...)[i] -> element."""
    x = node.inputs[0]
    if len(node.op.idx_list) != 1:
        return False
    entry = node.op.idx_list[0]
    if not isinstance(entry, (int, np.integer)):
        return False
    if x.owner is None:
        return False
    if isinstance(x.owner.op, Shape):
        inner = x.owner.inputs[0]
        i = int(entry) % inner.type.ndim
        return [shape_i(inner, i)]
    if isinstance(x.owner.op, MakeVector):
        i = int(entry) % len(x.owner.inputs)
        elem = x.owner.inputs[i]
        out = node.outputs[0]
        if elem.type == out.type:
            return [elem]
        from pytensor_tpu_torch.tensor.basic import cast

        if elem.type.ndim == 0:
            return [cast(elem, out.type.dtype)]
    return False


register_canonicalize(local_subtensor_of_shape, name="local_subtensor_of_shape")




@node_rewriter([Reshape])
def local_useless_reshape(fgraph, node):
    """reshape(x, shape-of-x) -> x: statically, or via the ShapeFeature's
    symbolic same_shape on ``None``-dim graphs (PyTensor's
    tensor/rewriting/shape.py local_useless_reshape)."""
    x = node.inputs[0]
    out = node.outputs[0]
    if x.type == out.type and all(s is not None for s in x.type.shape):
        return [x]
    feature = getattr(fgraph, "shape_feature", None)
    if (feature is not None and x.type.ndim == out.type.ndim
            and x.type.dtype == out.type.dtype
            and feature.same_shape(x, out)
            and out.type.is_super(x.type)):
        return [x]
    return False


register_useless(local_useless_reshape, name="local_useless_reshape")
register_specialize(local_useless_reshape, name="local_useless_reshape")


@node_rewriter([_CAReduce])
def local_reduce_of_makevector(fgraph, node):
    """Sum/Prod/Max/Min over a MakeVector -> a scalar elemwise chain
    (shape products like ``prod(shape(x))`` fold to the entries;
    PyTensor's tensor/rewriting/basic.py local_sum_make_vector)."""
    from pytensor_tpu_torch.tensor import math as tm
    from pytensor_tpu_torch.tensor.basic import cast

    x = node.inputs[0]
    if x.owner is None or not isinstance(x.owner.op, MakeVector):
        return False
    if node.op.axis not in (None, (0,)):
        return False
    name = getattr(node.op.scalar_op, "name", None)
    binop = {"add": tm.add, "mul": tm.mul, "maximum": tm.maximum,
             "minimum": tm.minimum}.get(name)
    if binop is None:
        return False
    entries = x.owner.inputs
    if not entries:
        if name == "add":
            acc = constant(np.asarray(0))
        elif name == "mul":
            acc = constant(np.asarray(1))
        else:
            return False  # empty max/min is an error; keep the reduce
    else:
        acc = entries[0]
        for e in entries[1:]:
            acc = binop(acc, e)
    out = node.outputs[0]
    if acc.type.dtype != out.type.dtype:
        acc = cast(acc, out.type.dtype)
    if not out.type.is_super(acc.type):
        return False
    copy_stack_trace(out, acc)
    return [acc]


register_canonicalize(local_reduce_of_makevector,
                      name="local_reduce_of_makevector")


@node_rewriter([Reshape])
def local_reshape_reshape(fgraph, node):
    """reshape(reshape(x, s1), s2) -> reshape(x, s2)."""
    x = node.inputs[0]
    if x.owner is not None and isinstance(x.owner.op, Reshape) and \
            len(fgraph.clients.get(x, ())) == 1:
        out = Reshape(node.op.ndim)(x.owner.inputs[0], node.inputs[1])
        if out.type.is_super(node.outputs[0].type) or node.outputs[0].type.is_super(out.type):
            copy_stack_trace(node.outputs[0], out)
            if node.outputs[0].type.is_super(out.type):
                return [out]
    return False


register_canonicalize(local_reshape_reshape, name="local_reshape_reshape")


@node_rewriter([Shape_i])
def local_shape_i_through_op(fgraph, node):
    """Shape_i(op(...), i) -> the op's symbolic infer_shape entry.

    The local equivalent of PyTensor's ShapeFeature propagation
    (tensor/rewriting/shape.py:70): shape queries bypass the computation
    (Shape_i(dot(a, b), 0) becomes Shape_i(a, 0)), which keeps shape
    values on the host and removes dead compute.
    """
    x = node.inputs[0]
    if x.owner is None:
        return False
    op = x.owner.op
    try:
        input_shapes = [
            tuple(shape_i(inp, d) for d in range(inp.type.ndim))
            if hasattr(inp.type, "ndim") and hasattr(inp.type, "dtype")
            else None
            for inp in x.owner.inputs
        ]
        out_shapes = op.infer_shape(fgraph, x.owner, input_shapes)
    except (NotImplementedError, Exception):
        return False
    idx = x.index or 0
    if out_shapes is None or idx >= len(out_shapes):
        return False
    entry = out_shapes[idx][node.op.i]
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable, cast

    entry = as_tensor_variable(entry)
    if entry.type.dtype != "int64":
        entry = cast(entry, "int64")
    out = node.outputs[0]
    if not out.type.is_super(entry.type):
        return False
    # avoid replacing with something that still contains this very node
    copy_stack_trace(out, entry)
    return [entry]


register_canonicalize(local_shape_i_through_op, name="local_shape_i_through_op")


@node_rewriter([Reshape])
def local_reshape_to_static(fgraph, node):
    """Rebuild a Reshape whose output type has unknown dims when the shape
    entries now fold to constants (rewrites run after make_node, so types
    never retighten on their own).  Static output types feed the whole-loop
    scan kernel's eligibility check."""
    from pytensor_tpu_torch.tensor.basic import (NotScalarConstantError, constant,
                                           get_scalar_constant_value)

    out = node.outputs[0]
    if all(s is not None for s in out.type.shape):
        return False
    x, shp = node.inputs
    entries = _try_shape_entries(shp, node.op.ndim)
    if entries is None:
        return False
    dims = []
    for e in entries:
        try:
            dims.append(int(get_scalar_constant_value(e)))
        except NotScalarConstantError:
            return False
    if dims.count(-1) == 1 and all(s is not None for s in x.type.shape):
        total = int(np.prod(x.type.shape, initial=1))
        known = int(np.prod([d for d in dims if d != -1], initial=1))
        if known > 0 and total % known == 0:
            dims[dims.index(-1)] = total // known
    if any(d < 0 for d in dims):
        return False
    new_out = Reshape(node.op.ndim)(x, constant(np.asarray(dims, "int64")))
    if all(s is None for s in new_out.type.shape):
        return False  # nothing gained
    copy_stack_trace(out, new_out)
    return [new_out]


register_canonicalize(local_reshape_to_static, name="local_reshape_to_static")
register_specialize(local_reshape_to_static, name="local_reshape_to_static")

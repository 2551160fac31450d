"""Basic tensor rewrites: constant folding, useless-op removal, the
DimShuffle, fill, alloc, join and SpecifyShape rewrites.

Counterpart of ``pytensor_tpu/tensor/rewriting/basic.py`` (PyTensor's
tensor/rewriting/basic.py constant_folding:1236), every ``local_*``
rewrite of it.  Each keeps its name, tags and database, and the modules
register in the JAX package's order.
"""

from __future__ import annotations

from pytensor_tpu_torch.compile.mode import (
    register_canonicalize,
    register_specialize,
    register_useless,
)
import numpy as np

from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from pytensor_tpu_torch.tensor.basic import Alloc, Join, MakeVector, Split, as_tensor_variable, cast, constant
from pytensor_tpu_torch.tensor.elemwise import DimShuffle, Elemwise
from pytensor_tpu_torch.tensor.shape import SpecifyShape, Unbroadcast
from pytensor_tpu_torch.compile.ops import DeepCopyOp, ViewOp


@node_rewriter(None)
def constant_folding(fgraph, node):
    """Evaluate nodes whose inputs are all constants through their numpy
    ``perform``."""
    if not node.inputs:
        return False
    if not all(isinstance(i, Constant) for i in node.inputs):
        return False
    if not node.op.do_constant_folding(fgraph, node):
        return False
    storage = [[None] for _ in node.outputs]
    try:
        node.op.perform(node, [i.data for i in node.inputs], storage)
    except (NotImplementedError, Exception) as e:
        if isinstance(e, NotImplementedError):
            return False
        return False
    outs = []
    for o, s in zip(node.outputs, storage):
        if s[0] is None:
            return False
        try:
            c = o.type.make_constant(s[0])
        except Exception:
            return False
        copy_stack_trace(o, c)
        outs.append(c)
    return outs


register_canonicalize(constant_folding, name="constant_folding")
register_specialize(constant_folding, name="constant_folding_spec")


@node_rewriter([DimShuffle])
def local_useless_dimshuffle(fgraph, node):
    """Remove identity DimShuffles."""
    op = node.op
    if op.new_order == tuple(range(op.input_ndim)):
        return [node.inputs[0]]
    return False


register_canonicalize(local_useless_dimshuffle, name="local_useless_dimshuffle")


@node_rewriter([DimShuffle])
def local_dimshuffle_lift(fgraph, node):
    """Merge DimShuffle(DimShuffle(x)) into one DimShuffle."""
    op = node.op
    inner = node.inputs[0].owner
    if inner is None or not isinstance(inner.op, DimShuffle):
        return False
    inner_op = inner.op
    new_order = tuple(
        "x" if o == "x" else inner_op.new_order[o] for o in op.new_order
    )
    x = inner.inputs[0]
    if new_order == tuple(range(x.type.ndim)):
        return [x]
    out = DimShuffle(x.type.ndim, new_order)(x)
    copy_stack_trace(node.outputs[0], out)
    return [out]


register_canonicalize(local_dimshuffle_lift, name="local_dimshuffle_merge")


@node_rewriter([SpecifyShape])
def local_useless_specify_shape(fgraph, node):
    """Drop SpecifyShape when the input type already carries the info."""
    x = node.inputs[0]
    out = node.outputs[0]
    if x.type == out.type:
        return [x]
    return False


register_useless(local_useless_specify_shape, name="local_useless_specify_shape")


@node_rewriter([Unbroadcast])
def local_useless_unbroadcast(fgraph, node):
    x = node.inputs[0]
    if x.type == node.outputs[0].type:
        return [x]
    return False


register_useless(local_useless_unbroadcast, name="local_useless_unbroadcast")


@node_rewriter([Elemwise])
def local_useless_switch(fgraph, node):
    """switch(const, a, b) -> a or b; switch(c, x, x) -> x."""
    if node.op.scalar_op.name != "switch":
        return False
    cond, t, f = node.inputs
    out = node.outputs[0]
    if isinstance(cond, Constant):
        data = np.asarray(cond.data)
        if data.size and np.all(data == data.flat[0]):
            chosen = t if data.flat[0] else f
            chosen = _broadcast_like(chosen, out)
            if chosen is not None:
                return [chosen]
    if t is f:
        b = _broadcast_like(t, out)
        if b is not None:
            return [b]
    return False


def _broadcast_like(v, model):
    """Return v broadcast/cast to model's type, or None if not provable."""
    from pytensor_tpu_torch.tensor import math as tm

    v = as_tensor_variable(v)
    if v.type == model.type:
        return v
    if v.type.dtype != model.type.dtype:
        v = cast(v, model.type.dtype)
    if v.type.ndim == model.type.ndim and all(
        ms is None or vs == ms for vs, ms in zip(v.type.shape, model.type.shape)
    ) and all(vs is not None for vs in v.type.shape):
        return v
    if model.type.is_super(v.type):
        return v
    # use `second` to broadcast against the model variable
    return tm.second(model, v) if _cheap(model) else None


def _cheap(model):
    # only safe to reference the model output if it's not what we're
    # replacing; use its inputs instead — conservatively bail out
    return False


register_canonicalize(local_useless_switch, name="local_useless_switch")


@node_rewriter([DeepCopyOp, ViewOp])
def local_remove_copies(fgraph, node):
    """DeepCopy/View are identities inside a graph: the executor copies an
    output that aliases an input or a shared value itself
    (``compile/executor.py``), so no copy node is needed to protect one."""
    return [node.inputs[0]]


register_specialize(local_remove_copies, name="local_remove_copies")


@node_rewriter([Elemwise])
def local_useless_cast(fgraph, node):
    name = node.op.scalar_op.name
    if not name.startswith("cast{"):
        return False
    x = node.inputs[0]
    if x.type.dtype == node.outputs[0].type.dtype and x.type == node.outputs[0].type:
        return [x]
    inner = x.owner
    if inner is not None and isinstance(inner.op, Elemwise) and \
            inner.op.scalar_op.name.startswith("cast{"):
        # cast(cast(x)) -> cast(x) when outer dtype wins losslessly is
        # subtle; only collapse identical casts
        if inner.op.scalar_op.name == node.op.scalar_op.name:
            return [x]
    return False


register_canonicalize(local_useless_cast, name="local_useless_cast")


@node_rewriter([Join])
def local_join_1(fgraph, node):
    """join(axis, x) -> x."""
    if len(node.inputs) == 2:
        x = node.inputs[1]
        if x.type == node.outputs[0].type:
            return [x]
    return False


register_canonicalize(local_join_1, name="local_join_1")


@node_rewriter([Elemwise])
def local_fill_thin_carrier(fgraph, node):
    """second(carrier, v): only the carrier's *shape* matters, so replace
    an Elemwise carrier by any of its same-typed inputs — the dead
    computation then gets garbage-collected (reference local_fill_sink)."""
    if node.op.scalar_op.name != "second":
        return False
    carrier, v = node.inputs
    if carrier.owner is None or not isinstance(carrier.owner.op, Elemwise):
        return False
    for i in carrier.owner.inputs:
        if i.type == carrier.type:
            from pytensor_tpu_torch.tensor import math as tm

            res = tm.second(i, v)
            copy_stack_trace(node.outputs[0], res)
            return [res]
    return False


register_canonicalize(local_fill_thin_carrier, name="local_fill_thin_carrier")


@node_rewriter([Elemwise])
def local_useless_fill(fgraph, node):
    """second(model, v) -> v when v already has the output's exact type."""
    if node.op.scalar_op.name != "second":
        return False
    _, v = node.inputs
    if v.type == node.outputs[0].type:
        return [v]
    return False


register_useless(local_useless_fill, name="local_useless_fill")


@node_rewriter([Alloc])
def local_useless_alloc(fgraph, node):
    """Alloc(v, shape) -> v when the types already match exactly."""
    v = node.inputs[0]
    if v.type == node.outputs[0].type:
        return [v]
    return False


register_useless(local_useless_alloc, name="local_useless_alloc")


@node_rewriter([Alloc])
def local_alloc_of_alloc(fgraph, node):
    """Alloc(Alloc(v, s...), t...) -> Alloc(v, t...): broadcasting is
    transitive, the inner materialization is dead work."""
    v = node.inputs[0]
    if v.owner is None or not isinstance(v.owner.op, Alloc):
        return False
    inner_value = v.owner.inputs[0]
    out = node.outputs[0]
    res = Alloc()(inner_value, *node.inputs[1:])
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_alloc_of_alloc, name="local_alloc_of_alloc")


@node_rewriter([Elemwise])
def local_unary_of_alloc_lift(fgraph, node):
    """unary_op(Alloc(v, s...)) -> Alloc(unary_op(v), s...): compute the
    scalar once instead of over the whole materialized buffer."""
    if len(node.inputs) != 1:
        return False
    a = node.inputs[0]
    if a.owner is None or not isinstance(a.owner.op, Alloc):
        return False
    if len(fgraph.clients.get(a, ())) != 1:
        return False
    v, *shape = a.owner.inputs
    if v.type.ndim != 0:
        return False
    applied = Elemwise(node.op.scalar_op)(v)
    res = Alloc()(applied, *shape)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_unary_of_alloc_lift, name="local_unary_of_alloc_lift")


@node_rewriter([Join])
def local_join_empty(fgraph, node):
    """Drop statically-empty pieces from a join."""
    from pytensor_tpu_torch.tensor.basic import (
        NotScalarConstantError, get_scalar_constant_value, join)

    axis_var, *tensors = node.inputs
    try:
        a = int(get_scalar_constant_value(axis_var))
    except NotScalarConstantError:
        return False
    a = a % tensors[0].type.ndim
    keep = [t for t in tensors if t.type.shape[a] != 0]
    if len(keep) == len(tensors) or not keep:
        return False
    out = node.outputs[0]
    res = join(axis_var, *keep)
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_join_empty, name="local_join_empty")


@node_rewriter([Join])
def local_join_of_join(fgraph, node):
    """join(a, ..., join(a, x, y), ...) -> one flat join on the same
    constant axis."""
    from pytensor_tpu_torch.tensor.basic import (
        NotScalarConstantError, get_scalar_constant_value, join)

    axis_var, *tensors = node.inputs
    try:
        a = int(get_scalar_constant_value(axis_var))
    except NotScalarConstantError:
        return False
    new_tensors = []
    changed = False
    for t in tensors:
        if (t.owner is not None and isinstance(t.owner.op, Join)
                and len(fgraph.clients.get(t, ())) == 1):
            try:
                inner_a = int(get_scalar_constant_value(t.owner.inputs[0]))
            except NotScalarConstantError:
                new_tensors.append(t)
                continue
            if inner_a % t.type.ndim == a % t.type.ndim:
                new_tensors.extend(t.owner.inputs[1:])
                changed = True
                continue
        new_tensors.append(t)
    if not changed:
        return False
    out = node.outputs[0]
    res = join(axis_var, *new_tensors)
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_join_of_join, name="local_join_of_join")


@node_rewriter([Split])
def local_useless_split(fgraph, node):
    """Split into one piece -> the input itself."""
    if node.op.len_splits != 1:
        return False
    x = node.inputs[0]
    out = node.outputs[0]
    if out.type.is_super(x.type) and x.type.dtype == out.type.dtype:
        copy_stack_trace(out, x)
        return [x]
    return False


register_useless(local_useless_split, name="local_useless_split")


@node_rewriter([MakeVector])
def local_makevector_cast_fold(fgraph, node):
    """MakeVector over all-Constant scalars folds even when
    do_constant_folding is conservative elsewhere."""
    if not all(isinstance(i, Constant) for i in node.inputs):
        return False
    vals = np.asarray([i.data for i in node.inputs],
                      dtype=node.outputs[0].type.numpy_dtype)
    c = node.outputs[0].type.make_constant(vals)
    copy_stack_trace(node.outputs[0], c)
    return [c]


register_canonicalize(local_makevector_cast_fold, name="local_makevector_cast_fold")


@node_rewriter([DimShuffle])
def local_dimshuffle_of_elemwise(fgraph, node):
    """dimshuffle(elemwise(a, b)) -> elemwise(dimshuffle(a), ...): move the
    layout change to the (smaller) leaves; enables further lifts and keeps
    the Elemwise chain whole for the fusion pass."""
    v = node.inputs[0]
    if v.owner is None or not isinstance(v.owner.op, Elemwise):
        return False
    if len(fgraph.clients.get(v, ())) != 1:
        return False
    if v.owner.op.scalar_op.name == "second":
        return False
    op = node.op
    out_ndim = v.type.ndim
    new_inputs = []
    for i in v.owner.inputs:
        if i.type.ndim == 0:
            new_inputs.append(i)
            continue
        offset = out_ndim - i.type.ndim
        order_i = tuple(
            "x" if (o == "x" or o < offset) else o - offset
            for o in op.new_order
        )
        if order_i == tuple(range(i.type.ndim)):
            new_inputs.append(i)
        else:
            new_inputs.append(DimShuffle(i.type.ndim, order_i)(i))
    res = Elemwise(v.owner.op.scalar_op)(*new_inputs)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_dimshuffle_of_elemwise,
                      name="local_dimshuffle_of_elemwise")


@node_rewriter([DimShuffle])
def local_dimshuffle_of_alloc(fgraph, node):
    """dimshuffle(alloc(v, s...)) -> alloc(v, permuted s...) for scalar
    fills and non-dropping dimshuffles."""
    v = node.inputs[0]
    if v.owner is None or not isinstance(v.owner.op, Alloc):
        return False
    fill, *shape_vars = v.owner.inputs
    if fill.type.ndim != 0:
        return False
    op = node.op
    if sorted(o for o in op.new_order if o != "x") != list(range(v.type.ndim)):
        return False
    new_shape = [
        constant(np.int64(1)) if o == "x" else shape_vars[o]
        for o in op.new_order
    ]
    out = node.outputs[0]
    res = Alloc()(fill, *new_shape)
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_dimshuffle_of_alloc, name="local_dimshuffle_of_alloc")


@node_rewriter([SpecifyShape])
def local_specify_shape_merge(fgraph, node):
    """specify_shape(specify_shape(x, s1), s2) -> one SpecifyShape with the
    union of the static info."""
    x = node.inputs[0]
    if x.owner is None or not isinstance(x.owner.op, SpecifyShape):
        return False
    from pytensor_tpu_torch.tensor.shape import specify_shape

    inner_x = x.owner.inputs[0]
    out = node.outputs[0]
    res = specify_shape(inner_x, out.type.shape)
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_specify_shape_merge, name="local_specify_shape_merge")

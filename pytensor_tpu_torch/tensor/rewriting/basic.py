"""Basic tensor rewrites: constant folding, DimShuffle and fill rewrites.

Counterpart of ``pytensor_tpu/tensor/rewriting/basic.py`` (PyTensor's
tensor/rewriting/basic.py constant_folding:1236), cut to the rewrites that
fire on the radon logp+dlogp graphs, the Elman BPTT step and the GP,
Kalman and batched-Cholesky graphs.  Each keeps its name, tags and
database, and the modules register in the JAX package's order.
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
from pytensor_tpu_torch.tensor.basic import Alloc, MakeVector, as_tensor_variable, cast, constant
from pytensor_tpu_torch.tensor.elemwise import DimShuffle, Elemwise


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

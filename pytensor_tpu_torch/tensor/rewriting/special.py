"""Softmax-family rewrites.

Counterpart of ``pytensor_tpu/tensor/rewriting/special.py``, ported
whole: log(softmax) -> log_softmax (``:41``), exp(log_softmax) ->
softmax (``:64``) and the subtensor lift (``:103``).
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.compile.mode import register_specialize, register_stabilize
from pytensor_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from pytensor_tpu_torch.tensor.elemwise import Elemwise
from pytensor_tpu_torch.tensor.special import LogSoftmax, Softmax, log_softmax, softmax
from pytensor_tpu_torch.tensor.subtensor import DYN, Subtensor


def _replaced(node, res):
    out = node.outputs[0]
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


@node_rewriter([Elemwise])
def local_logsoftmax(fgraph, node):
    """log(softmax(x)) -> log_softmax(x), stable for large logits."""
    if node.op.scalar_op.name != "log":
        return False
    arg = node.inputs[0]
    if arg.owner is None or not isinstance(arg.owner.op, Softmax):
        return False
    if len(fgraph.clients.get(arg, ())) > 1:
        return False
    return _replaced(node, log_softmax(arg.owner.inputs[0], axis=arg.owner.op.axis))


register_stabilize(local_logsoftmax, name="local_logsoftmax")


@node_rewriter([Elemwise])
def local_exp_logsoftmax(fgraph, node):
    """exp(log_softmax(x)) -> softmax(x)."""
    if node.op.scalar_op.name != "exp":
        return False
    arg = node.inputs[0]
    if arg.owner is None or not isinstance(arg.owner.op, LogSoftmax):
        return False
    if len(fgraph.clients.get(arg, ())) > 1:
        return False
    return _replaced(node, softmax(arg.owner.inputs[0], axis=arg.owner.op.axis))


register_stabilize(local_exp_logsoftmax, name="local_exp_logsoftmax")


@node_rewriter([Subtensor])
def local_subtensor_of_softmax(fgraph, node):
    """softmax(x, axis)[idx] -> softmax(x[idx], axis') when the index
    covers only dims before the softmax axis: dropped rows are never
    computed."""
    x = node.inputs[0]
    if x.owner is None or not isinstance(x.owner.op, (Softmax, LogSoftmax)):
        return False
    if len(fgraph.clients.get(x, ())) > 1:
        return False
    sm_op = x.owner.op
    axis = sm_op.axis
    n_dropped = 0
    for d, e in enumerate(node.op.idx_list):
        if d >= axis:
            return False
        if e == DYN or isinstance(e, (int, np.integer)):
            n_dropped += 1
        elif not (isinstance(e, tuple) and e[0] == "slice"):
            return False
    sub = Subtensor(node.op.idx_list)(x.owner.inputs[0], *node.inputs[1:])
    ctor = softmax if isinstance(sm_op, Softmax) else log_softmax
    return _replaced(node, ctor(sub, axis=axis - n_dropped))


register_specialize(local_subtensor_of_softmax, name="local_subtensor_of_softmax")

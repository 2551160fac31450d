"""The executed prefix of a while-scan's traces.

Counterpart of ``pytensor_tpu/scan/dynlen.py:40-117``.  A while-scan's
raw outputs are static ``(n_steps, *core)`` buffers, zero past the step
at which its condition held, and a trailing int64 ``steps_done``;
``scan()`` wraps each user-visible trace in :class:`TruncateToDone`,
whose value is the executed prefix ``trace[:steps_done]``, and whose
gradient pads a cotangent back to the buffer (:class:`PadTraceGrad`).

The port's shapes live on the host, so the prefix is a real op here: its
lowering (``link/torch/dispatch.py``) slices the buffer by
``steps_done``, which the while-scan's step loop returns as a host
integer (a 0-d int64 tensor on the CPU: the loop counted its steps and
read nothing more from the device).  Not ported: ``WhileScanDynLen``
(``pytensor_tpu/scan/dynlen.py:163``), the pass that the JAX package's
XLA path needs to express these ops with static shapes (tagged "xla";
ROADMAP.md "Do not carry over").
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.null_type import DisconnectedType
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.tensor.basic import as_tensor_variable
from pytensor_tpu_torch.tensor.type import TensorType


class TruncateToDone(Op):
    """``out = trace[:steps_done]``: the executed prefix of a while-scan
    trace; ``steps_done`` is the scan's trailing int64 output."""

    __props__ = ()
    view_map = {0: [0]}

    def make_node(self, trace, steps_done):
        trace = as_tensor_variable(trace)
        steps_done = as_tensor_variable(steps_done)
        if steps_done.type.ndim != 0:
            raise TypeError("steps_done must be a scalar")
        out = TensorType(trace.type.dtype, (None, *trace.type.shape[1:]))()
        return Apply(self, [trace, steps_done], [out])

    def perform(self, node, inputs, output_storage):
        trace, k = inputs
        output_storage[0][0] = np.asarray(trace)[: int(k)]

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor.basic import cast

        return [(cast(node.inputs[1], "int64"), *input_shapes[0][1:])]

    def connection_pattern(self, node):
        return [[True], [False]]

    def L_op(self, inputs, outputs, output_grads):
        trace, k = inputs
        (g,) = output_grads
        return [PadTraceGrad()(g, trace, k), DisconnectedType()()]

    def __str__(self):
        return "TruncateToDone"


class PadTraceGrad(Op):
    """The adjoint of :class:`TruncateToDone`: a cotangent of the executed
    prefix, zero-padded to the trace buffer's shape (``out =
    zeros_like(like); out[:len(g)] = g``)."""

    __props__ = ()

    def make_node(self, g, like, steps_done):
        g = as_tensor_variable(g)
        like = as_tensor_variable(like)
        steps_done = as_tensor_variable(steps_done)
        out = TensorType(like.type.dtype, like.type.shape)()
        return Apply(self, [g, like, steps_done], [out])

    def perform(self, node, inputs, output_storage):
        g, like, k = inputs
        buf = np.zeros_like(np.asarray(like))
        g = np.asarray(g)
        buf[: g.shape[0]] = g
        output_storage[0][0] = buf

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[1]]

    def connection_pattern(self, node):
        return [[True], [False], [False]]

    def L_op(self, inputs, outputs, output_grads):
        g, like, k = inputs
        (gg,) = output_grads
        return [TruncateToDone()(gg, k), DisconnectedType()(), DisconnectedType()()]

    def __str__(self):
        return "PadTraceGrad"


truncate_to_done = TruncateToDone()

"""Compile-support ops: TypeCastingOp, ViewOp, DeepCopyOp.

Counterpart of ``pytensor_tpu/compile/ops.py:18-43`` (PyTensor's
compile/ops.py ViewOp:87, DeepCopyOp:121).  The torch lowerings
(``link/torch/dispatch.py``) alias the input for ``ViewOp`` and clone it
for ``DeepCopyOp``; K2 aliases and copies slots for them.  Left out:
``FromFunctionOp`` and ``as_op`` (ROADMAP Queue 1 item 15).
"""

from __future__ import annotations

import copy

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.op import Op


class TypeCastingOp(Op):
    """Base for ops that merely reinterpret their input."""

    view_map = {0: [0]}

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = inputs[0]


class ViewOp(TypeCastingOp):
    __props__ = ()

    def make_node(self, x):
        return Apply(self, [x], [x.type()])

    def infer_shape(self, fgraph, node, input_shapes):
        return input_shapes

    def L_op(self, inputs, outputs, output_grads):
        return output_grads


view_op = ViewOp()


class DeepCopyOp(Op):
    """Copy the input (protects function outputs from aliasing shared
    storage)."""

    __props__ = ()

    def make_node(self, x):
        return Apply(self, [x], [x.type()])

    def perform(self, node, inputs, output_storage):
        x = inputs[0]
        if isinstance(x, np.ndarray):
            output_storage[0][0] = x.copy()
        else:
            output_storage[0][0] = copy.deepcopy(x)

    def infer_shape(self, fgraph, node, input_shapes):
        return input_shapes

    def L_op(self, inputs, outputs, output_grads):
        return output_grads


deep_copy_op = DeepCopyOp()

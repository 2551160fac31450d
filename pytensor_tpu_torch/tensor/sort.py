"""Sorting ops: ``SortOp`` and ``ArgSortOp``.

Counterpart of ``pytensor_tpu/tensor/sort.py`` (PyTensor's tensor/sort.py
SortOp:31, ArgSortOp:156), ported as far as the linalg rewrites of the
diagonal closed forms need it; ``TopKOp`` waits for ROADMAP.md Queue 1
item 12.  The torch lowering sorts stably, as ``jnp.sort`` does.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.null_type import DisconnectedType
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.tensor.basic import as_tensor_variable
from pytensor_tpu_torch.tensor.type import TensorType


class SortOp(Op):
    __props__ = ("kind", "order")

    def __init__(self, kind="quicksort", order=None):
        self.kind = kind
        self.order = order

    def make_node(self, input, axis=-1):
        input = as_tensor_variable(input)
        axis = as_tensor_variable(axis)
        out = TensorType(input.type.dtype, input.type.shape)()
        return Apply(self, [input, axis], [out])

    def perform(self, node, inputs, output_storage):
        x, axis = inputs
        output_storage[0][0] = np.sort(x, int(axis), self.kind, self.order)

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def connection_pattern(self, node):
        return [[True], [False]]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.tensor.basic import NotScalarConstantError, get_scalar_constant_value
        from pytensor_tpu_torch.tensor.subtensor import take_along_axis
        from pytensor_tpu_torch.gradient import grad_not_implemented

        x, axis = inputs
        (gz,) = output_grads
        try:
            a = int(get_scalar_constant_value(axis)) % x.type.ndim
        except NotScalarConstantError:
            return [grad_not_implemented(self, 0, x, "symbolic sort axis"),
                    DisconnectedType()()]
        idx = ArgSortOp(self.kind, self.order)(x, axis)
        rev = ArgSortOp(self.kind, self.order)(idx, axis)
        return [take_along_axis(gz, rev, axis=a), DisconnectedType()()]


class ArgSortOp(Op):
    __props__ = ("kind", "order")

    def __init__(self, kind="quicksort", order=None):
        self.kind = kind
        self.order = order

    def make_node(self, input, axis=-1):
        input = as_tensor_variable(input)
        axis = as_tensor_variable(axis)
        out = TensorType("int64", input.type.shape)()
        return Apply(self, [input, axis], [out])

    def perform(self, node, inputs, output_storage):
        x, axis = inputs
        output_storage[0][0] = np.argsort(x, int(axis), self.kind,
                                          self.order).astype("int64")

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def connection_pattern(self, node):
        return [[False], [False]]

    def L_op(self, inputs, outputs, output_grads):
        return [DisconnectedType()(), DisconnectedType()()]


def sort(a, axis=-1, kind="quicksort", order=None):
    a = as_tensor_variable(a)
    if axis is None:
        a = a.flatten()
        axis = 0
    return SortOp(kind, order)(a, axis)


def argsort(a, axis=-1, kind="quicksort", order=None):
    a = as_tensor_variable(a)
    if axis is None:
        a = a.flatten()
        axis = 0
    return ArgSortOp(kind, order)(a, axis)

"""Sorting ops: ``SortOp``, ``ArgSortOp`` and ``TopKOp``.

Counterpart of ``pytensor_tpu/tensor/sort.py``, all of it (PyTensor's
tensor/sort.py SortOp:31, ArgSortOp:156).  The torch lowerings sort
stably, as ``jnp.sort`` does, and ``TopKOp``'s gives the JAX package's
``lax.top_k`` order (values descending, the lowest index first among
ties) whether or not ``sorted`` is asked for; the numpy oracle's order
among ties, and its unsorted order, differ.
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


class TopKOp(Op):
    """Top-k values and/or indices along the last axis."""

    __props__ = ("k", "sorted", "return_values", "return_indices")

    def __init__(self, k, sorted=True, return_values=True, return_indices=True):
        self.k = int(k)
        self.sorted = sorted
        self.return_values = return_values
        self.return_indices = return_indices

    def make_node(self, x):
        x = as_tensor_variable(x)
        shp = (*x.type.shape[:-1], self.k)
        outs = []
        if self.return_values:
            outs.append(TensorType(x.type.dtype, shp)())
        if self.return_indices:
            outs.append(TensorType("int64", shp)())
        return Apply(self, [x], outs)

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        k = self.k
        idx = np.argpartition(-x, kth=min(k - 1, x.shape[-1] - 1), axis=-1)[..., :k]
        vals = np.take_along_axis(x, idx, axis=-1)
        if self.sorted:
            order = np.argsort(-vals, axis=-1)
            idx = np.take_along_axis(idx, order, axis=-1)
            vals = np.take_along_axis(vals, order, axis=-1)
        outs = []
        if self.return_values:
            outs.append(vals)
        if self.return_indices:
            outs.append(idx.astype("int64"))
        for s, r in zip(output_storage, outs):
            s[0] = r

    def L_op(self, inputs, outputs, output_grads):
        # d(topk values)/dx: route gz back to the selected positions
        from pytensor_tpu_torch.gradient import (DisconnectedType,
                                           grad_not_implemented,
                                           grad_undefined)
        from pytensor_tpu_torch.graph.null_type import NullType
        from pytensor_tpu_torch.tensor.basic import zeros_like

        (x,) = inputs
        if not (self.return_values and self.return_indices):
            return [grad_not_implemented(
                self, 0, x, "topk grad needs both values and indices")]
        vals, idx = outputs
        gv = output_grads[0]
        if isinstance(getattr(gv, "type", None), (DisconnectedType, NullType)):
            return [grad_undefined(self, 0, x, "only indices used")]
        from pytensor_tpu_torch.tensor.subtensor import inc_subtensor

        if x.type.ndim != 1:
            return [grad_not_implemented(
                self, 0, x, "topk grad for ndim > 1")]
        return [inc_subtensor(zeros_like(x)[idx], gv)]


def topk(x, k, sorted=True):
    return TopKOp(k, sorted=sorted)(x)

"""Slice and None types: how Subtensor carries symbolic slices.

Counterpart of ``pytensor_tpu/tensor/type_other.py`` (PyTensor's
tensor/type_other.py SliceType:53, MakeSlice:27, NoneTypeT:120,
NoneConst).  A ``MakeSlice`` value is a Python ``slice`` of host ints in
the torch linker (``link/torch/dispatch.py``).
"""


from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.graph.type import Type


class SliceType(Type):
    __props__ = ()

    def filter(self, data, strict=False, allow_downcast=None):
        if isinstance(data, slice):
            return data
        raise TypeError(f"expected a slice, got {type(data)}")

    def make_constant_signature(self, data):
        return (data.start, data.stop, data.step)

    def __str__(self):
        return "slice"


slicetype = SliceType()


class SliceConstant(Constant):
    def __init__(self, type, data, name=None):
        assert isinstance(data, slice)
        super().__init__(type, data, name)

    def signature(self):
        return (SliceType, self.data.start, self.data.stop, self.data.step)

    def __str__(self):
        return f"slice({self.data.start}, {self.data.stop}, {self.data.step})"


SliceType.constant_type = SliceConstant


class MakeSlice(Op):
    __props__ = ()

    def make_node(self, start, stop, step):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable
        inputs = []
        for v in (start, stop, step):
            if v is None or isinstance(v.type if isinstance(v, Variable) else None, NoneTypeT):
                inputs.append(NoneConst if v is None else v)
            else:
                inputs.append(as_tensor_variable(v))
        return Apply(self, inputs, [slicetype()])

    def perform(self, node, inputs, output_storage):
        vals = [None if v is None else int(v) for v in inputs]
        output_storage[0][0] = slice(*vals)

    def connection_pattern(self, node):
        return [[False] for _ in node.inputs]


make_slice = MakeSlice()


class NoneTypeT(Type):
    __props__ = ()

    def filter(self, data, strict=False, allow_downcast=None):
        if data is None:
            return None
        raise TypeError("expected None")

    def make_constant_signature(self, data):
        return (None,)

    def __str__(self):
        return "None"


none_type_t = NoneTypeT()
NoneConst = Constant(none_type_t, None, name="NoneConst")


def as_symbolic_slice(s: slice):
    """Convert a python slice (possibly containing Variables) to a graph value."""
    if any(isinstance(p, Variable) for p in (s.start, s.stop, s.step)):
        return make_slice(s.start, s.stop, s.step)
    return SliceConstant(slicetype, s)

"""Typed lists of graph values.

Counterpart of ``pytensor_tpu/typed_list/basic.py`` (PyTensor's
typed_list/, 827 lines).  A value is a Python list of the element type's
values: numpy arrays for ``perform``, tensors on the plan's device for
the torch lowerings (``link/torch/dispatch.py``, section "typed lists").
Their host traffic: ``GetItem`` and ``Insert`` by a constant or host index
read nothing back, by a device index they read it (a ``host`` port);
``Index`` and ``Remove`` compare values and read the answer back
(``reads_back``), where ``Count`` sums the comparisons on the device and
reads nothing; ``Length`` is a host value, as the shape ops are
(``link/torch/linker.py _host_variables``), since a list's length is fixed
by the input signature a capture is keyed by.  A linked function takes a
Python list of arrays or tensors for a list input (``Plan._convert``).
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.graph.type import Type


class TypedListType(Type):
    __props__ = ("ttype",)

    def __init__(self, ttype):
        self.ttype = ttype

    def filter(self, data, strict=False, allow_downcast=None):
        if not isinstance(data, (list, tuple)):
            raise TypeError("expected a list")
        return [self.ttype.filter(d, strict=strict, allow_downcast=allow_downcast)
                for d in data]

    def values_eq(self, a, b):
        return len(a) == len(b) and all(
            self.ttype.values_eq(x, y) for x, y in zip(a, b)
        )

    def __str__(self):
        return f"TypedList<{self.ttype}>"


class MakeList(Op):
    __props__ = ()

    def make_node(self, *elems):
        if not elems:
            raise ValueError("make_list needs at least one element")
        elems = list(elems)
        t = elems[0].type
        for e in elems:
            if e.type != t:
                raise TypeError("all list elements must have the same type")
        return Apply(self, elems, [TypedListType(t)()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = list(inputs)


make_list_ = MakeList()


def make_list(elems):
    return make_list_(*elems)


class GetItem(Op):
    __props__ = ()

    def make_node(self, x, index):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        index = as_tensor_variable(index)
        return Apply(self, [x, index], [x.type.ttype()])

    def perform(self, node, inputs, output_storage):
        x, i = inputs
        output_storage[0][0] = x[int(i)]


getitem = GetItem()


class Append(Op):
    __props__ = ()

    def make_node(self, x, elem):
        elem = x.type.ttype.filter_variable(elem)
        return Apply(self, [x, elem], [x.type()])

    def perform(self, node, inputs, output_storage):
        x, e = inputs
        output_storage[0][0] = list(x) + [e]


append = Append()


class Extend(Op):
    __props__ = ()

    def make_node(self, x, y):
        if x.type != y.type:
            raise TypeError("extend needs lists of the same type")
        return Apply(self, [x, y], [x.type()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = list(inputs[0]) + list(inputs[1])


extend = Extend()


class Insert(Op):
    __props__ = ()

    def make_node(self, x, index, elem):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        elem = x.type.ttype.filter_variable(elem)
        return Apply(self, [x, as_tensor_variable(index), elem], [x.type()])

    def perform(self, node, inputs, output_storage):
        x, i, e = inputs
        res = list(x)
        res.insert(int(i), e)
        output_storage[0][0] = res


insert = Insert()


class Remove(Op):
    __props__ = ()

    def make_node(self, x, elem):
        elem = x.type.ttype.filter_variable(elem)
        return Apply(self, [x, elem], [x.type()])

    def perform(self, node, inputs, output_storage):
        x, e = inputs
        res = list(x)
        for k, v in enumerate(res):
            if np.array_equal(np.asarray(v), np.asarray(e)):
                del res[k]
                break
        output_storage[0][0] = res


remove = Remove()


class Reverse(Op):
    __props__ = ()

    def make_node(self, x):
        return Apply(self, [x], [x.type()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = list(reversed(inputs[0]))


reverse = Reverse()


class Length(Op):
    __props__ = ()

    def make_node(self, x):
        from pytensor_tpu_torch.tensor.type import TensorType

        return Apply(self, [x], [TensorType("int64", ())()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(len(inputs[0]), dtype="int64")


length = Length()


class Count(Op):
    __props__ = ()

    def make_node(self, x, elem):
        from pytensor_tpu_torch.tensor.type import TensorType

        elem = x.type.ttype.filter_variable(elem)
        return Apply(self, [x, elem], [TensorType("int64", ())()])

    def perform(self, node, inputs, output_storage):
        x, e = inputs
        n = sum(1 for v in x if np.array_equal(np.asarray(v), np.asarray(e)))
        output_storage[0][0] = np.asarray(n, dtype="int64")


count = Count()


class Index(Op):
    """Position of the first matching element (reference typed_list
    Index op / list.index semantics)."""

    __props__ = ()

    def make_node(self, x, elem):
        from pytensor_tpu_torch.tensor.type import TensorType

        elem = x.type.ttype.filter_variable(elem)
        return Apply(self, [x, elem], [TensorType("int64", ())()])

    def perform(self, node, inputs, output_storage):
        x, e = inputs
        for i, v in enumerate(x):
            if np.array_equal(np.asarray(v), np.asarray(e)):
                output_storage[0][0] = np.asarray(i, dtype="int64")
                return
        raise ValueError("element not in typed list")


index_ = Index()


class TypedListVariable(Variable):
    """Variable sugar for typed lists (reference typed_list/basic.py
    TypedListVariable): list-style methods build the corresponding ops."""

    def __getitem__(self, index):
        return getitem(self, index)

    def append(self, elem):
        return append(self, elem)

    def extend(self, other):
        return extend(self, other)

    def insert(self, index, elem):
        return insert(self, index, elem)

    def remove(self, elem):
        return remove(self, elem)

    def reverse(self):
        return reverse(self)

    def count(self, elem):
        return count(self, elem)

    def ind(self, elem):
        return index_(self, elem)


class TypedListConstant(Constant, TypedListVariable):
    pass


TypedListType.variable_type = TypedListVariable
TypedListType.constant_type = TypedListConstant

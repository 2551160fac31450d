"""OpFromGraph: encapsulate a subgraph as a single Op.

Counterpart of ``pytensor_tpu/compile/builders.py`` (PyTensor's
compile/builders.py OpFromGraph:116), cut to what ``FusedElemwise``
needs: the inner FunctionGraph, typed make_node, a numpy ``perform`` and
the inlining gradient.
"""

from __future__ import annotations

from typing import Sequence

from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable, clone
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.graph.op import HasInnerGraph, Op


class OpFromGraph(Op, HasInnerGraph):
    """An Op wrapping inputs->outputs of an inner graph."""

    def __init__(self, inputs: Sequence[Variable], outputs: Sequence[Variable],
                 name=None):
        if not isinstance(outputs, (list, tuple)):
            raise TypeError("outputs must be a list")
        for i in inputs:
            if isinstance(i, Constant):
                raise TypeError("OpFromGraph inputs cannot be constants")
        # clone to protect the inner graph from outer mutation
        new_inputs, new_outputs = clone(list(inputs), list(outputs))
        self.fgraph = FunctionGraph(new_inputs, new_outputs, clone=False)
        self.name = name
        self.input_types = [i.type for i in new_inputs]
        self.output_types = [o.type for o in new_outputs]

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    def make_node(self, *inputs):
        if len(inputs) != len(self.fgraph.inputs):
            raise ValueError(
                f"{self} expected {len(self.fgraph.inputs)} inputs, got {len(inputs)}"
            )
        inputs = [t.filter_variable(i) for t, i in zip(self.input_types, inputs)]
        return Apply(self, list(inputs), [t() for t in self.output_types])

    def perform(self, node, inputs, output_storage):
        storage = dict(zip(self.fgraph.inputs, inputs))
        for inner in self.fgraph.toposort():
            vals = [i.data if isinstance(i, Constant) else storage[i]
                    for i in inner.inputs]
            out = [[None] for _ in inner.outputs]
            inner.op.perform(inner, vals, out)
            storage.update((o, s[0]) for o, s in zip(inner.outputs, out))
        for s, o in zip(output_storage, self.fgraph.outputs):
            s[0] = o.data if isinstance(o, Constant) else storage[o]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import pullback
        from pytensor_tpu_torch.graph.basic import clone_get_equiv

        # inline the inner graph on the outer inputs, then pull back
        memo = dict(zip(self.fgraph.inputs, inputs))
        memo = clone_get_equiv(self.fgraph.inputs, self.fgraph.outputs,
                               copy_inputs=False, copy_orphans=False, memo=memo)
        inlined_outputs = [memo[o] for o in self.fgraph.outputs]
        return pullback(inlined_outputs, list(inputs), output_grads,
                        disconnected_inputs="ignore", return_disconnected="disconnected")

    def clone(self):
        import copy as _copy

        res = _copy.copy(self)
        res.fgraph = self.fgraph.clone()
        return res

    def __str__(self):
        return self.name or f"OpFromGraph{{{id(self):x}}}"

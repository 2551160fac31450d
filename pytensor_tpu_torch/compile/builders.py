"""OpFromGraph: encapsulate a subgraph as a single Op.

Counterpart of ``pytensor_tpu/compile/builders.py`` (PyTensor's
compile/builders.py OpFromGraph:116, construct_nominal_fgraph:67),
whole: the inner FunctionGraph, typed make_node, a numpy ``perform``, the
gradient by inlining or by ``lop_overrides`` (``grad_overrides``, its
older name), forward mode by ``pushforward`` or ``rop_overrides``, a
given ``connection_pattern``, ``inline`` (the ``inline_ofg_expansion``
rewrite replaces the node by its inner graph, at the JAX package's
position, -0.01, in ``fast_run`` and ``fast_compile``), and pickling of
the inner graph as its inputs and outputs.  It is the base of
``FusedElemwise`` (K1's node) and ``SymbolicOp`` (the softmax family).
The linker runs a node that stays by linking its inner graph for the
device (``link/torch/dispatch.py``).
"""

from __future__ import annotations

from typing import Sequence

from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable, clone, clone_get_equiv
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.graph.op import HasInnerGraph, Op


class OpFromGraph(Op, HasInnerGraph):
    """An Op wrapping inputs->outputs of an inner graph."""

    def __init__(self, inputs: Sequence[Variable], outputs: Sequence[Variable],
                 inline: bool = False, lop_overrides=None, grad_overrides=None,
                 rop_overrides=None, connection_pattern=None, name=None):
        if not isinstance(outputs, (list, tuple)):
            raise TypeError("outputs must be a list")
        for i in inputs:
            if isinstance(i, Constant):
                raise TypeError("OpFromGraph inputs cannot be constants")
        # clone to protect the inner graph from outer mutation
        new_inputs, new_outputs = clone(list(inputs), list(outputs))
        self.fgraph = FunctionGraph(new_inputs, new_outputs, clone=False)
        self.inline = inline
        self.name = name
        self.lop_overrides = lop_overrides if lop_overrides is not None else grad_overrides
        self.rop_overrides = rop_overrides
        self._connection_pattern = connection_pattern
        self.input_types = [i.type for i in new_inputs]
        self.output_types = [o.type for o in new_outputs]

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    def __getstate__(self):
        # the inner graph as its inputs and outputs: a graph is made anew
        # on load (its features' closures do not pickle)
        d = self.__dict__.copy()
        d["fgraph"] = (list(self.fgraph.inputs), list(self.fgraph.outputs))
        return d

    def __setstate__(self, d):
        ins, outs = d.pop("fgraph")
        self.__dict__.update(d)
        self.fgraph = FunctionGraph(ins, outs, clone=False)

    def with_fgraph(self, fgraph):
        """This op, its options kept, with ``fgraph`` (a rewritten clone of
        its inner graph) in place of its inner graph."""
        import copy as _copy

        new = _copy.copy(self)
        new.fgraph = fgraph
        new.input_types = [i.type for i in fgraph.inputs]
        new.output_types = [o.type for o in fgraph.outputs]
        return new

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

    def infer_shape(self, fgraph, node, input_shapes):
        raise NotImplementedError()

    def connection_pattern(self, node):
        if self._connection_pattern is not None:
            return self._connection_pattern
        return super().connection_pattern(node)

    def _inlined(self, inputs):
        """The inner graph's outputs computed from ``inputs``."""
        memo = clone_get_equiv(self.fgraph.inputs, self.fgraph.outputs, copy_inputs=False,
                               copy_orphans=False, memo=dict(zip(self.fgraph.inputs, inputs)))
        return [memo[o] for o in self.fgraph.outputs]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import pullback

        if self.lop_overrides is not None:
            return self.lop_overrides(inputs, output_grads)
        # inline the inner graph on the outer inputs, then pull back
        return pullback(self._inlined(inputs), list(inputs), output_grads,
                        disconnected_inputs="ignore", return_disconnected="disconnected")

    def R_op(self, inputs, eval_points):
        from pytensor_tpu_torch.gradient import Rop_via_pushforward

        if self.rop_overrides is not None:
            return self.rop_overrides(inputs, eval_points)
        return Rop_via_pushforward(self, inputs, eval_points)

    @property
    def inner_inputs(self):
        return self.fgraph.inputs

    @property
    def inner_outputs(self):
        return self.fgraph.outputs

    def clone(self):
        import copy as _copy

        res = _copy.copy(self)
        res.fgraph = self.fgraph.clone()
        return res

    def __str__(self):
        return self.name or f"OpFromGraph{{{id(self):x}}}"


class SymbolicOp(OpFromGraph):
    """An OpFromGraph built from its ``symbolic_call`` (counterpart of
    ``pytensor_tpu/compile/builders.py:151``): a named composite, such as
    ``Softmax``, that rewrites track as one op.  Its lowering runs the
    inner graph (``link/torch/dispatch.py``)."""

    def __init__(self, *inputs, **params):
        for k, v in params.items():
            setattr(self, k, v)
        outputs = self.symbolic_call(*inputs)
        if not isinstance(outputs, (list, tuple)):
            outputs = [outputs]
        super().__init__(list(inputs), list(outputs), name=type(self).__name__)

    def symbolic_call(self, *inputs):
        raise NotImplementedError


def construct_nominal_fgraph(inputs, outputs):
    """A FunctionGraph of a clone of the subgraph from ``inputs`` to
    ``outputs``."""
    new_inputs, new_outputs = clone(list(inputs), list(outputs))
    return FunctionGraph(new_inputs, new_outputs, clone=False)


def _register_inline_rewrite():
    from pytensor_tpu_torch.compile.mode import optdb
    from pytensor_tpu_torch.graph.rewriting.basic import WalkingGraphRewriter, node_rewriter

    @node_rewriter([OpFromGraph])
    def inline_ofg_expansion(fgraph, node):
        """An ``inline`` OpFromGraph replaced by its inner graph."""
        if not node.op.inline:
            return False
        return node.op._inlined(node.inputs)

    optdb.register("inline_ofg_expansion", WalkingGraphRewriter(inline_ofg_expansion),
                   "fast_run", "fast_compile", position=-0.01)


_register_inline_rewrite()

"""The Op protocol.

Parallels PyTensor's graph/op.py (Op:53, make_node:142,
__call__:184, L_op:410, perform:477, HasInnerGraph:687).  There is no
``c_code``: each Op gets a torch lowering registered with
``pytensor_tpu_torch.link.torch.dispatch.torch_funcify``, and ``perform``
(numpy) is what constant folding evaluates at rewrite time.
"""

from __future__ import annotations

from typing import Any, Sequence

from pytensor_tpu_torch.graph.basic import Apply, Variable
from pytensor_tpu_torch.utils import MetaObject


class Op(MetaObject):
    """An operation: type-level inference (``make_node``), a host
    reference implementation (``perform``), and gradient rules."""

    # optional declarative typing: lists of Types
    itypes: Sequence | None = None
    otypes: Sequence | None = None

    # index of the output returned by __call__ for multi-output ops
    default_output: int | None = None

    # alias metadata, {out_idx: [in_idx, ...]}: the merge pass never
    # merges an op with a destroy_map
    view_map: dict = {}
    destroy_map: dict = {}

    def make_node(self, *inputs: Variable) -> Apply:
        if self.itypes is None or self.otypes is None:
            raise NotImplementedError(
                f"{type(self).__name__} must define make_node or itypes/otypes"
            )
        if len(inputs) != len(self.itypes):
            raise ValueError(
                f"{self} expected {len(self.itypes)} inputs, got {len(inputs)}"
            )
        inputs = [it.filter_variable(i) for it, i in zip(self.itypes, inputs)]
        return Apply(self, inputs, [t() for t in self.otypes])

    def __call__(self, *inputs, name=None, return_list=False, **kwargs):
        node = self.make_node(*inputs, **kwargs)
        if self.default_output is not None:
            out = node.outputs[self.default_output]
            if name is not None:
                out.name = name
            return [out] if return_list else out
        if len(node.outputs) == 1:
            out = node.outputs[0]
            if name is not None:
                out.name = name
            return [out] if return_list else out
        return node.outputs


    # --- runtime ---
    def perform(self, node: Apply, inputs: Sequence[Any], output_storage: Sequence[list]):
        """numpy reference implementation; fills output_storage[i][0]."""
        raise NotImplementedError(f"{type(self).__name__}.perform")

    # --- gradients ---
    def grad(self, inputs: Sequence[Variable], output_grads: Sequence[Variable]):
        raise NotImplementedError(f"{type(self).__name__} has no gradient defined")

    def L_op(self, inputs, outputs, output_grads):
        """vJp rule. Default delegates to ``grad`` (which may not need outputs)."""
        return self.grad(inputs, output_grads)

    def R_op(self, inputs, eval_points):
        """Jvp rule: the outputs' tangents from the inputs' (None where an
        input has none).  ``gradient.pushforward`` needs none of them."""
        raise NotImplementedError(f"{type(self).__name__}.R_op")


    # --- static analysis ---

    def do_constant_folding(self, fgraph, node) -> bool:
        return True

    def connection_pattern(self, node):
        """[[bool for each output] for each input]: which inputs affect which outputs."""
        return [[True for _ in node.outputs] for _ in node.inputs]


class HasInnerGraph:
    """Mixin for ops holding an inner FunctionGraph (Scan, OpFromGraph)."""

    @property
    def inner_inputs(self):
        return self.fgraph.inputs

    @property
    def inner_outputs(self):
        return self.fgraph.outputs

    def clone(self):
        raise NotImplementedError

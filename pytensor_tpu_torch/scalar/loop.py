"""ScalarLoop: a scalar update iterated a fixed number of times, or until
a condition fails.

Counterpart of ``pytensor_tpu/scalar/loop.py`` (PyTensor's scalar/loop.py
ScalarLoop:10, which the reference uses for iterative special-function
gradients).  Applied to tensors the body maps elementwise.  The torch
lowering runs the inner graph's plan ``n_steps`` times, a host value (a
``host`` port, as the JAX package's ``_concrete`` requires it concrete):
the for form reads nothing back and captures; the while form reads its
``until`` on the host after each step (``reads_back``) and stops the first
time it is not all true, keeping that step's states, as the JAX package's
``perform`` and its ``lax.while_loop`` do.  ``perform`` (the oracle) runs
the inner graph's own ``perform`` the same way.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply, Constant
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.graph.op import HasInnerGraph, Op
from pytensor_tpu_torch.tensor.basic import as_tensor_variable
from pytensor_tpu_torch.tensor.type import TensorType


class ScalarLoop(Op, HasInnerGraph):
    """Iterate an elementwise update: state' = f(state, *constants).

    init/update are graphs over 0-d (or broadcastable) variables; applied
    to tensors the loop body maps elementwise.  Inputs at call time:
    (n_steps, *init, *constants); outputs: final states.
    """

    def __init__(self, init: list, update: list, constant: list | None = None,
                 until=None, name=None):
        constant = constant or []
        self.fgraph = FunctionGraph(
            list(init) + list(constant),
            list(update) + ([until] if until is not None else []),
            clone=True,
        )
        self.n_states = len(update)
        self.n_constants = len(constant)
        self.is_while = until is not None
        self.name = name

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

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

    def make_node(self, n_steps, *inputs):
        n_steps = as_tensor_variable(n_steps)
        inputs = [as_tensor_variable(i) for i in inputs]
        if len(inputs) != self.n_states + self.n_constants:
            raise ValueError(
                f"ScalarLoop expected {self.n_states + self.n_constants} inputs"
            )
        outs = [
            TensorType(self.fgraph.outputs[k].type.dtype, inputs[k].type.shape)()
            for k in range(self.n_states)
        ]
        return Apply(self, [n_steps, *inputs], outs)

    def _step(self, values):
        """One step of the inner graph on numpy values, by each inner
        node's ``perform``."""
        storage = dict(zip(self.fgraph.inputs, values))
        for inner in self.fgraph.toposort():
            vals = [i.data if isinstance(i, Constant) else storage[i] for i in inner.inputs]
            out = [[None] for _ in inner.outputs]
            inner.op.perform(inner, vals, out)
            storage.update((o, s[0]) for o, s in zip(inner.outputs, out))
        return [o.data if isinstance(o, Constant) else storage[o] for o in self.fgraph.outputs]

    def perform(self, node, inputs, output_storage):
        n_steps, *rest = inputs
        states = [np.asarray(r) for r in rest[: self.n_states]]
        constants = rest[self.n_states:]
        for _ in range(int(n_steps)):
            res = self._step([*states, *constants])
            states = [np.asarray(s) for s in res[: self.n_states]]
            if self.is_while and not np.all(res[-1]):
                break
        for s, out in zip(output_storage, states):
            s[0] = np.asarray(out)

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[1 + k] for k in range(self.n_states)]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import grad_not_implemented

        return [
            grad_not_implemented(self, i, inp,
                                 "ScalarLoop grads: differentiate the closed form")
            for i, inp in enumerate(inputs)
        ]

    def __str__(self):
        return f"ScalarLoop{{{self.name or self.n_states}}}"


def _register_torch():
    import torch

    from pytensor_tpu_torch.link.torch.dispatch import ports, torch_funcify
    from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch

    def _until_read(node):
        return "the while form reads its until on the host each step" if node.op.is_while else ""

    @torch_funcify.register(ScalarLoop)
    @ports(host=(0,), reads_back=_until_read)
    def _scalar_loop(op, node=None, device=None, checks=None, **kw):
        inner = fgraph_to_torch(op.fgraph, device, trust_input=True, checks=checks)
        n_states = op.n_states

        def scalar_loop(n_steps, *rest):
            states = list(rest[:n_states])
            constants = rest[n_states:]
            for _ in range(int(n_steps)):
                res = inner(*states, *constants)
                states = list(res[:n_states])
                if op.is_while and not bool(torch.all(res[-1])):
                    break
            return states if n_states > 1 else states[0]

        return scalar_loop


_register_torch()

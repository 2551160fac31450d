"""Conditional-breakpoint op.

Counterpart of ``pytensor_tpu/breakpoint.py`` (PyTensor's breakpoint.py:9
PdbBreakpoint): the identity over the monitored variables, with the side
effect of dropping into a debugger (pudb, ipdb, then pdb, the first
available) when a symbolic scalar condition is true.

``perform`` is the host's: a real debugger prompt, whose edits to the
``monitored`` list flow on.  The torch lowering (``link/torch/dispatch.py``)
reads the condition on the host (``reads_back``, so a plan holding one
runs eagerly) and, when it is true, calls the debugger with CPU numpy
copies of the monitored values; edits to them do not flow back, and the
outputs are the inputs themselves (views, as on the JAX package's XLA
path).  ``PdbBreakpoint.debugger`` is the hook a test replaces.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply, Variable
from pytensor_tpu_torch.graph.op import Op


def _enter_debugger(name, monitored):
    print("\n-------------------------------------------------")
    print(f"Conditional breakpoint '{name}' activated\n")
    print("The monitored variables are stored, in order,")
    print("in the list variable 'monitored' as NumPy arrays.")
    print("-------------------------------------------------")
    try:
        import pudb

        pudb.set_trace()
    except ImportError:
        try:
            import ipdb

            ipdb.set_trace()
        except ImportError:
            import pdb

            pdb.set_trace()
    return monitored


class PdbBreakpoint(Op):
    """Identity-with-breakpoint (reference breakpoint.py:9)."""

    __props__ = ("name",)

    def __init__(self, name):
        self.name = name

    def make_node(self, condition, *monitored_vars):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        if not isinstance(condition, Variable):
            condition = as_tensor_variable(condition)
        if condition.type.ndim != 0:
            raise ValueError("PdbBreakpoint condition must be a scalar")
        monitored_vars = [as_tensor_variable(v) for v in monitored_vars]
        # outputs view the corresponding monitored input (identity)
        new_op = PdbBreakpoint(name=self.name)
        new_op.view_map = {i: [i + 1] for i in range(len(monitored_vars))}
        return Apply(new_op, [condition, *monitored_vars],
                     [v.type() for v in monitored_vars])

    # test hook: replaced in unit tests to avoid a real prompt
    debugger = staticmethod(_enter_debugger)

    def perform(self, node, inputs, output_storage):
        condition, *monitored = inputs
        if condition:
            monitored = [np.asarray(m) for m in monitored]
            monitored = type(self).debugger(self.name, monitored) or monitored
        for s, m in zip(output_storage, monitored):
            s[0] = np.asarray(m)

    def infer_shape(self, fgraph, node, input_shapes):
        return list(input_shapes[1:])

    def connection_pattern(self, node):
        rows = [[False] * (len(node.inputs) - 1)]  # condition disconnected
        for i in range(len(node.inputs) - 1):
            rows.append([j == i for j in range(len(node.inputs) - 1)])
        return rows

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import DisconnectedType

        return [DisconnectedType()()] + list(output_grads)

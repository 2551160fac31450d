"""Runtime assertions as graph nodes.

Counterpart of ``pytensor_tpu/raise_op.py`` (PyTensor's raise_op.py
CheckAndRaise:26, Assert:148).  ``CheckAndRaise`` passes its input 0
through and raises ``exc_type(msg)`` where a condition is false; its
``perform`` checks the conditions in order, on the host.

The torch lowering (``link/torch/dispatch.py``) checks at the node on the
CPU, as ``perform`` does.  On a CUDA device it defers the check, as the JAX
package's XLA path defers it to an asynchronous ``jax.debug.callback``:
the node writes whether ``torch.all`` of a condition failed into its own
slot of a small device buffer of flags that the outermost plan owns
(``link/torch/linker.py Checks``; the step loop of a scan ORs each step's
result into the same slot), and after the call, eager or replayed from a
CUDA graph, the plan reads the buffer once and raises the first failed
node's ``exc_type(msg)`` in topological order, through
``link/basic.py raise_with_op``.  So a plan that holds a
``CheckAndRaise`` still captures.  The plan zeroes the buffer at the start
of every call (inside the capture, when it is captured).  A call that
raises returns no outputs and writes no update of a shared variable.
The order that deferral gives: the host-side error of a later node (an
index bounds check, say) can surface before a failed assert of an
earlier node does.  A condition that is a host value (computed from
shapes) is checked on the host at the node.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.null_type import DisconnectedType
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.tensor.basic import as_tensor_variable


class ExceptionType:
    pass


class CheckAndRaise(Op):
    """Pass through input 0; raise ``exc_type(msg)`` if any condition is false."""

    view_map = {0: [0]}

    def __init__(self, exc_type=AssertionError, msg=""):
        self.exc_type = exc_type
        self.msg = msg

    def __eq__(self, other):
        return (type(self) is type(other) and self.exc_type == other.exc_type
                and self.msg == other.msg)

    def __hash__(self):
        return hash((type(self), self.exc_type, self.msg))

    def make_node(self, value, *conds):
        value = as_tensor_variable(value)
        conds = [as_tensor_variable(c) for c in conds]
        return Apply(self, [value, *conds], [value.type()])

    def perform(self, node, inputs, output_storage):
        value, *conds = inputs
        for c in conds:
            if not np.all(c):
                raise self.exc_type(self.msg)
        output_storage[0][0] = value

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def connection_pattern(self, node):
        return [[True]] + [[False] for _ in node.inputs[1:]]

    def L_op(self, inputs, outputs, output_grads):
        return [output_grads[0]] + [
            DisconnectedType()() for _ in inputs[1:]
        ]

    def __str__(self):
        return f"CheckAndRaise{{{self.exc_type.__name__}({self.msg})}}"


class Assert(CheckAndRaise):
    def __init__(self, msg="PyTensorTPU Assert failed!"):
        super().__init__(AssertionError, msg)

    def __str__(self):
        return f"Assert{{msg={self.msg}}}"


assert_op = Assert()


def assert_(value, *conds):
    return assert_op(value, *conds)

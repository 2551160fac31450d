"""MonitorMode: user callbacks around every node.

Counterpart of ``pytensor_tpu/compile/debug/monitormode.py`` (PyTensor's
compile/debug/monitormode.py:9).  The JAX package calls them around each
thunk of its numpy oracle; the port around each node of the ``"py"``
plan on the caller's device (``link/torch/linker.py Plan.hook``), never
captured.  A callback gets the node and a ``NodeThunk``, whose
``inputs`` and ``outputs`` are one-element cells holding the node's
tensors (``outputs`` are empty cells before the node runs), as a thunk's
storage is in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from pytensor_tpu_torch.compile.mode import Mode


class NodeThunk:
    """A node's values around its run: ``inputs`` and ``outputs`` are
    lists of one-element cells."""

    def __init__(self, node, inputs):
        self.node = node
        self.inputs = [[v] for v in inputs]
        self.outputs = [[None] for _ in node.outputs]


class _Monitor:
    """The ``Plan.hook`` that calls ``pre_func`` and ``post_func``."""

    def __init__(self, pre_func, post_func):
        self.pre_func = pre_func
        self.post_func = post_func

    def before(self, node, inputs):
        thunk = NodeThunk(node, inputs)
        if self.pre_func is not None:
            self.pre_func(node, thunk)
        return thunk

    def after(self, node, thunk, inputs, outputs):
        for cell, value in zip(thunk.outputs, outputs):
            cell[0] = value
        if self.post_func is not None:
            self.post_func(node, thunk)


class MonitorLinker:
    """The ``"py"`` plan with ``pre_func(node, thunk)`` before each node and
    ``post_func(node, thunk)`` after it."""

    required_rewrites = ("torch",)

    def __init__(self, pre_func=None, post_func=None):
        self.pre_func = pre_func
        self.post_func = post_func

    def make_torch_fn(self, fgraph, device, trust_input=False):
        from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch

        plan = fgraph_to_torch(fgraph, device, trust_input)
        plan.hook = _Monitor(self.pre_func, self.post_func)
        return plan


class MonitorMode(Mode):
    def __init__(self, pre_func=None, post_func=None, optimizer="fast_run"):
        super().__init__(MonitorLinker(pre_func, post_func), optimizer)


def _has_nan(value) -> bool:
    if isinstance(value, torch.Tensor):
        return (value.is_floating_point() or value.is_complex()) and bool(value.isnan().any())
    return isinstance(value, np.ndarray) and value.dtype.kind in "fc" and bool(
        np.isnan(value).any())


def detect_nan(node, thunk):
    """Example post-callback (PyTensor's detect_nan:102): raise where an
    output holds a NaN."""
    for output in thunk.outputs:
        if _has_nan(output[0]):
            from pytensor_tpu_torch.printing import debugprint

            print("*** NaN detected ***")
            debugprint(node)
            raise AssertionError(f"NaN in output of {node}")

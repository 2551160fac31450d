"""NanGuardMode: check every node's inputs and outputs for NaN, inf and
huge values.

Counterpart of ``pytensor_tpu/compile/debug/nanguardmode.py`` (PyTensor's
compile/debug/nanguardmode.py:140).  The JAX package checks around each
thunk of its numpy oracle; the port runs the ``"py"`` plan on the
caller's device and checks each node's float and complex inputs before
it runs and its outputs after (``link/torch/linker.py Plan.hook``), in
the JAX package's order and with its messages, so an error names the
first node at fault.  Each check reads its answer back to the host.
"""

from __future__ import annotations

import torch

from pytensor_tpu_torch.compile.mode import Mode
from pytensor_tpu_torch.config import config

BIG = 1e10


def _check_value(value, what, node, nan_is_error, inf_is_error, big_is_error):
    if not isinstance(value, torch.Tensor) or not (value.is_floating_point()
                                                   or value.is_complex()):
        return
    if nan_is_error and bool(value.isnan().any()):
        raise AssertionError(f"NanGuardMode: NaN detected in {what} of {node}")
    if inf_is_error and bool(value.isinf().any()):
        raise AssertionError(f"NanGuardMode: Inf detected in {what} of {node}")
    if big_is_error:
        size = value.abs()
        size = size[torch.isfinite(size)]
        if size.numel() and float(size.max()) > BIG:
            raise AssertionError(f"NanGuardMode: big value detected in {what} of {node}")


class _Guard:
    """The ``Plan.hook`` that checks a node's inputs and outputs."""

    def __init__(self, flags):
        self.flags = flags

    def before(self, node, inputs):
        for value in inputs:
            _check_value(value, "an input", node, *self.flags)

    def after(self, node, mark, inputs, outputs):
        for value in outputs:
            _check_value(value, "an output", node, *self.flags)


class NanGuardLinker:
    """The ``"py"`` plan with each node's values checked."""

    required_rewrites = ("torch",)

    def __init__(self, nan_is_error, inf_is_error, big_is_error):
        self.flags = (nan_is_error, inf_is_error, big_is_error)

    def make_torch_fn(self, fgraph, device, trust_input=False):
        from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch

        plan = fgraph_to_torch(fgraph, device, trust_input)
        plan.hook = _Guard(self.flags)
        return plan


class NanGuardMode(Mode):
    def __init__(self, nan_is_error=None, inf_is_error=None, big_is_error=None,
                 optimizer="fast_run"):
        if nan_is_error is None:
            nan_is_error = config.nan_guard__nan_is_error
        if inf_is_error is None:
            inf_is_error = config.nan_guard__inf_is_error
        if big_is_error is None:
            big_is_error = config.nan_guard__big_is_error
        super().__init__(NanGuardLinker(nan_is_error, inf_is_error, big_is_error), optimizer)

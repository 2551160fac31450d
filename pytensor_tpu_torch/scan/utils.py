"""Scan helpers.

Counterpart of ``pytensor_tpu/scan/utils.py``, ported whole: ``until``
and ``ScanProfileStats``.  The port has no while-scans yet; ``scan``
raises when a step function returns ``until`` (ROADMAP.md Queue 1,
item 4).
"""

from __future__ import annotations

from pytensor_tpu_torch.tensor.basic import as_tensor_variable


class until:
    """While-loop marker: return ``until(cond)`` from a scan step fn."""

    def __init__(self, condition):
        self.condition = as_tensor_variable(condition)
        if self.condition.type.ndim != 0:
            raise TypeError("until condition must be a scalar")


class ScanProfileStats:
    """Per-Scan profiling record: the calls, the steps they ran and their
    total time."""

    def __init__(self, name=None):
        self.name = name
        self.callcount = 0
        self.nbsteps = 0
        self.call_time = 0.0

    def record(self, n_steps, dt):
        self.callcount += 1
        self.nbsteps += int(n_steps)
        self.call_time += dt

    def summary(self, file=None):
        import sys

        print(f"ScanProfileStats({self.name}): {self.callcount} calls, "
              f"{self.nbsteps} total steps, {self.call_time:.6f}s", file=file or sys.stdout)

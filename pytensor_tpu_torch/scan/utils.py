"""Scan helpers.

Counterpart of ``pytensor_tpu/scan/utils.py``: ``until``.  The port has
no while-scans yet; ``scan`` raises when a step function returns
``until`` (ROADMAP.md Queue 1, item 5).  Left out: ScanProfileStats.
"""

from __future__ import annotations

from pytensor_tpu_torch.tensor.basic import as_tensor_variable


class until:
    """While-loop marker: return ``until(cond)`` from a scan step fn."""

    def __init__(self, condition):
        self.condition = as_tensor_variable(condition)
        if self.condition.type.ndim != 0:
            raise TypeError("until condition must be a scalar")

"""OrderedUpdates: a dict of shared-variable updates.

Counterpart of ``pytensor_tpu/updates.py``; ``scan`` returns one.
"""

from __future__ import annotations

from pytensor_tpu_torch.compile.sharedvalue import SharedVariable


class OrderedUpdates(dict):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        for k in self:
            self._check(k)

    def _check(self, key):
        if not isinstance(key, SharedVariable):
            raise TypeError(f"OrderedUpdates keys must be SharedVariables, got {key}")

    def __setitem__(self, key, value):
        self._check(key)
        super().__setitem__(key, value)

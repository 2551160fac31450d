"""Scalar special functions.

Counterpart of ``pytensor_tpu/scalar/math.py``, cut to ``sigmoid``
(``:182``), which the ported scan tests use.
"""

from __future__ import annotations

import numpy as np
import torch

from pytensor_tpu_torch.scalar.basic import _op


def _np_sigmoid(x):
    with np.errstate(over="ignore"):
        return 1 / (1 + np.exp(-np.asarray(x)))


sigmoid = _op("sigmoid", 1, _np_sigmoid, torch.sigmoid,
              lambda i, o, gz: [gz[0] * o[0] * (1 - o[0])], dtype_rule="float")

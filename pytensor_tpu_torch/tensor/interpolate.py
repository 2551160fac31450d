"""1-d linear interpolation.

Counterpart of ``pytensor_tpu/tensor/interpolate.py`` (PyTensor's
tensor/interpolate.py): ``np.interp`` as a graph over ``searchsorted``,
gathers and elementwise ops.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.tensor.basic import as_tensor_variable, cast
from pytensor_tpu_torch.tensor.extra_ops import searchsorted
from pytensor_tpu_torch.tensor import math as tm


def interp(x, xp, fp, left=None, right=None):
    """np.interp as a graph: piecewise-linear interpolation."""
    x = as_tensor_variable(x)
    xp = as_tensor_variable(xp)
    fp = as_tensor_variable(fp)
    idx = searchsorted(xp, x, side="right")
    from pytensor_tpu_torch.tensor.shape import shape

    n = shape(xp)[0]
    idx_hi = tm.clip(idx, 1, n - 1)
    idx_lo = idx_hi - 1
    x0 = xp[idx_lo]
    x1 = xp[idx_hi]
    y0 = fp[idx_lo]
    y1 = fp[idx_hi]
    slope = (y1 - y0) / (x1 - x0)
    y = y0 + slope * (x - x0)
    lval = fp[0] if left is None else as_tensor_variable(left)
    rval = fp[-1] if right is None else as_tensor_variable(right)
    y = tm.switch(tm.lt(x, xp[0]), lval, y)
    y = tm.switch(tm.gt(x, xp[-1]), rval, y)
    return y


def interpolate1d(x_points, y_points, method="linear"):
    """Return a callable interpolator over fixed knots."""
    if method != "linear":
        raise NotImplementedError("only linear interpolation is implemented")

    def f(x):
        return interp(x, x_points, y_points)

    return f

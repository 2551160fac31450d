"""DFT-matrix helpers.

Counterpart of ``pytensor_tpu/tensor/fourier.py`` (PyTensor's
tensor/fourier.py): the real DFT as products with explicit cosine and sine
matrices, which run as cuBLAS products on a card.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.tensor.basic import arange, as_tensor_variable, cast, shape_padleft, shape_padright
from pytensor_tpu_torch.tensor import math as tm


def dft_matrices(n, dtype="float64"):
    """Return (cos, -sin) DFT basis matrices of size n x n (real form)."""
    k = shape_padright(cast(arange(n), dtype), 1)
    t = shape_padleft(cast(arange(n), dtype), 1)
    # keep the angle constant at the REQUESTED dtype: a bare python float
    # would autocast to floatX and silently degrade an f64 basis
    two_pi = np.asarray(2.0 * np.pi, dtype=dtype)
    ang = two_pi * k * t / cast(as_tensor_variable(n), dtype)
    return tm.cos(ang), -tm.sin(ang)


def fourier(x, n=None, axis=-1):
    """Real DFT via explicit basis matmul (one product each, for small n):
    returns (real_part, imag_part)."""
    x = as_tensor_variable(x)
    if axis not in (-1, x.type.ndim - 1):
        raise NotImplementedError("fourier over the last axis only")
    from pytensor_tpu_torch.tensor.shape import shape

    if n is None:
        n = shape(x)[-1]
    C, S = dft_matrices(n, dtype=x.type.dtype if x.type.dtype.startswith("float")
                        else "float64")
    return tm.dot(x, C), tm.dot(x, S)

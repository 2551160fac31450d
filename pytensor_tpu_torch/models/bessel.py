"""The bessel loop of ``benchsuite.py:1067 ours_bessel``.

``v`` is a shared vector of ``BESSEL_N`` float32 values, ``cos(arange(n) *
0.37) * 0.5 + 2.0``, so in [1.5, 2.5], across the Bessel code's
series/fraction split at x = 2.  One step is ``y = 0.999 v + 0.001
kve(1, v) ive(0.5, v)``, written back into ``v``; ``train_loop`` compiles
``n_steps`` of them into one call.  The loop's body fuses nothing, in
either package, so on a card ``kve`` and ``ive`` run as one-node K1
launches each step (``link/torch/dispatch.py``), or the whole loop as one
K2 launch under ``config.scan__pallas``.  ``make_bessel_functions`` gives
the function of ``y`` and of ``grad(sum(y), v)``, where K1 fuses the
expression.  ``bessel_reference`` is the float64 scipy loop.
"""

from __future__ import annotations

import numpy as np

BESSEL_N = 4096


def v_start(n=BESSEL_N):
    """``benchsuite.py``'s start, computed in float32."""
    return (np.cos(np.arange(n, dtype=np.float32) * np.float32(0.37)) * np.float32(0.5)
            + np.float32(2.0)).astype(np.float32)


def _step(pt, v):
    return 0.999 * v + 0.001 * pt.kve(1.0, v) * pt.ive(0.5, v)


def make_bessel_loop(n=BESSEL_N, n_steps=16, *, device="cuda"):
    """``(f, v)``: ``f()`` runs ``n_steps`` steps, returns ``y[0]`` of the
    last and leaves the state in the shared ``v``."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt

    v = ptt.shared(v_start(n), name="v", shape=(n,), device=device)
    y = _step(pt, v)
    return ptt.train_loop([], y[0], {v: y}, n_steps=n_steps, name="bessel_loop",
                          device=device), v


def make_bessel_functions(n=BESSEL_N, *, device="cuda"):
    """``(f, v)``: ``f()`` gives ``[y, grad(sum(y), v)]`` at the shared
    ``v``; the gradient brings in kve(0, v), kve(2, v), ive(-0.5, v) and
    ive(1.5, v)."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt

    v = ptt.shared(v_start(n), name="v", shape=(n,), device=device)
    y = _step(pt, v)
    return ptt.function([], [y, ptt.grad(pt.sum(y), v)], device=device), v


def bessel_reference(v0, n_steps):
    """The loop in float64 with scipy: the state after ``n_steps`` and the
    last step's ``y[0]``."""
    import scipy.special as sps

    v = np.asarray(v0, dtype="float64")
    y0 = None
    for _ in range(n_steps):
        y = 0.999 * v + 0.001 * sps.kve(1.0, v) * sps.ive(0.5, v)
        y0, v = y[0], y
    return v, y0


def bessel_grad_reference(v):
    """y and d sum(y) / dv at ``v`` in float64, by scipy's closed forms of
    the derivatives (``pytensor_tpu/scalar/math.py:262, :282``)."""
    import scipy.special as sps

    x = np.asarray(v, dtype="float64")
    k1, i5 = sps.kve(1, x), sps.ive(0.5, x)
    dk = k1 - 0.5 * (sps.kve(0, x) + sps.kve(2, x))
    di = 0.5 * (sps.ive(-0.5, x) + sps.ive(1.5, x)) - np.sign(x) * i5
    return 0.999 * x + 0.001 * k1 * i5, 0.999 + 0.001 * (dk * i5 + k1 * di)

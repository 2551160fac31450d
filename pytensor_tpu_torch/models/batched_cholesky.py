"""Batched (Blockwise) Cholesky with its gradient: the workload of
``benchsuite.py:978 ours_blockwise_chol``, BASELINE.md's "Blockwise
batched linalg".

The JAX package builds it inline in ``benchsuite.py``; the port keeps it
here so that its tests and ``chip_smoke.py`` build the same graph.  The
loss is ``sum(cholesky(A) ** 2)`` over a shared stack of symmetric
positive-definite matrices, and the update scales ``A`` by a scalar near
1 taken from the gradient, so that every step factorises again and
differentiates through the factorisation.  The data comes from numpy's
``default_rng(seed)``, as in ``benchsuite.py``.
"""

from __future__ import annotations

import numpy as np

import pytensor_tpu_torch as ptt
import pytensor_tpu_torch.tensor as pt
from pytensor_tpu_torch.tensor import linalg as ptl


def spd_stack(batch=128, n=64, seed=0):
    """``a a^T + n I`` of a standard normal ``a``, float32, as
    ``benchsuite.py:978``."""
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((batch, n, n)).astype("float32")
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n, dtype="float32")).astype("float32")


def make_batched_cholesky_step(batch=128, n=64, seed=0, n_steps_per_call=1, mode=None,
                               device="cuda"):
    """The step through ``function()`` or, with ``n_steps_per_call > 1``,
    one ``train_loop`` of that many steps.  Returns ``(f, A)``: ``f()``
    gives the loss before the step (of the last step, for a
    ``train_loop``) and scales the shared ``A`` in place."""
    A = ptt.shared(spd_stack(batch, n, seed), name="A", device=device)
    loss = pt.sum(ptl.cholesky(A) ** 2)
    g = ptt.grad(loss, A)
    scale = np.float32(1.0) + np.float32(1e-7) * pt.tanh(pt.mean(g))
    updates = [(A, A * scale)]
    if n_steps_per_call > 1:
        f = ptt.train_loop([], loss, updates, n_steps=n_steps_per_call, mode=mode,
                           name="blockwise_chol_loop", device=device)
    else:
        f = ptt.function([], loss, updates=updates, mode=mode, name="blockwise_chol_step",
                         device=device)
    return f, A

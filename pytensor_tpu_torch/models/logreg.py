"""Logistic regression: the elementwise-fusion and GEMV benchmark
configuration (sigmoid(X.w + b) cross-entropy and its gradient), and a
full SGD training step with shared-parameter updates.

Counterpart of ``pytensor_tpu/models/logreg.py``, without its ``mesh``
branch (ROADMAP Queue 1 item 16).  The step runs through ``function()``,
or with ``n_steps_per_call > 1`` as one ``train_loop`` of that many steps
(the form of ``benchsuite.py:64 ours_logreg``).  Data comes from numpy's
``default_rng(seed)``, as in the JAX package.
"""

from __future__ import annotations

import numpy as np

import pytensor_tpu_torch as ptt
import pytensor_tpu_torch.tensor as pt


def _xent(X, y, w, b, dtype):
    p = pt.sigmoid(pt.dot(X, w) + b)
    eps = np.asarray(1e-7, dtype)
    return -pt.mean(y * pt.log(p + eps) + (1 - y) * pt.log(1 - p + eps))


def make_logreg_graphs(n=8192, d=256, dtype="float32", seed=0):
    """Return ([X, y, w, b], [xent, gw, gb], numpy values) uncompiled."""
    rng = np.random.default_rng(seed)
    X = pt.tensor("X", dtype=dtype, shape=(None, d))
    y = pt.tensor("y", dtype=dtype, shape=(None,))
    w = pt.tensor("w", dtype=dtype, shape=(d,))
    b = pt.tensor("b", dtype=dtype, shape=())
    xent = _xent(X, y, w, b, dtype)
    gw, gb = ptt.grad(xent, [w, b])
    Xv = rng.random((n, d)).astype(dtype)
    yv = (rng.random(n) < 0.5).astype(dtype)
    wv = np.zeros(d, dtype)
    bv = np.zeros((), dtype)
    return [X, y, w, b], [xent, gw, gb], (Xv, yv, wv, bv)


def make_logreg_training_step(n=8192, d=256, dtype="float32", lr=0.1, seed=0,
                              n_steps_per_call=1, device="cuda"):
    """The compiled SGD step with shared parameters on ``device``.

    Returns ``(f, (X, y), (w, b))``: ``f(X, y)`` gives the cross-entropy
    before the step (of the last step, for a ``train_loop``) and updates
    ``w`` and ``b`` in place; ``X`` and ``y`` are numpy arrays."""
    rng = np.random.default_rng(seed)
    w = ptt.shared(np.zeros(d, dtype), name="w", device=device)
    b = ptt.shared(np.zeros((), dtype), name="b", device=device)
    X = pt.tensor("X", dtype=dtype, shape=(None, d))
    y = pt.tensor("y", dtype=dtype, shape=(None,))
    xent = _xent(X, y, w, b, dtype)
    gw, gb = ptt.grad(xent, [w, b])
    updates = {w: w - lr * gw, b: b - lr * gb}
    if n_steps_per_call > 1:
        # K steps in one call: one loop on the device
        f = ptt.train_loop([X, y], xent, updates, n_steps=n_steps_per_call,
                           name="logreg_loop", device=device)
    else:
        f = ptt.function([X, y], xent, updates=updates, name="logreg_step", device=device)
    Xv = rng.random((n, d)).astype(dtype)
    yv = (rng.random(n) < 0.5).astype(dtype)
    return f, (Xv, yv), (w, b)

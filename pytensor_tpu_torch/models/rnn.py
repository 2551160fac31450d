"""Elman RNN forward and BPTT through scan's gradient: the Scan-suite
training configuration.

Counterpart of ``pytensor_tpu/models/rnn.py``, ported whole: the step
``h_t = tanh(x_t Wx + h_{t-1} Wh)`` scanned over a ``(seq_len, batch,
n_in)`` sequence, a linear head on the last state, a mean squared error,
its gradient by backprop through time (``Scan.L_op``) and SGD updates of
the three shared weights.  The step runs through ``function()``, or with
``n_steps_per_call > 1`` as one ``train_loop`` of that many steps (the
form of ``benchsuite.py:121 ours_elman``), in which the RNN's scans sit
inside the loop's scan.  Weights and data come from numpy's
``default_rng(seed)`` in the JAX package's order, so both packages compute
the same thing.  ``rnn_reference`` is the same step in float64 NumPy,
written out by hand: the check the linked step is held to.
"""

from __future__ import annotations

import numpy as np

import pytensor_tpu_torch as ptt
import pytensor_tpu_torch.tensor as pt


def elman_graph(seq_len=64, n_in=32, n_hidden=128, dtype="float32", lr=0.01, seed=0,
                device="cuda"):
    """The graph of ``make_elman_rnn_bptt``.  Returns ``(X, y, (Wx, Wh,
    Wo), loss, grads, updates, (Xv, yv), rng)``: the symbolic data, the
    shared weights, the loss, its gradients, the SGD updates, the numpy
    data (batch 4, as the JAX package makes it) and the generator after
    it."""
    rng = np.random.default_rng(seed)

    def weight(shape, name):
        return ptt.shared((rng.standard_normal(shape) * 0.1).astype(dtype), name=name,
                          device=device)

    Wx = weight((n_in, n_hidden), "Wx")
    Wh = weight((n_hidden, n_hidden), "Wh")
    Wo = weight((n_hidden, 1), "Wo")
    X = pt.tensor("X", dtype=dtype, shape=(seq_len, None, n_in))
    y = pt.tensor("y", dtype=dtype, shape=(None,))
    h0 = pt.zeros((X.shape[1], n_hidden), dtype=dtype)

    def step(xt, hprev, Wx, Wh):
        return pt.tanh(pt.dot(xt, Wx) + pt.dot(hprev, Wh))

    H, _ = ptt.scan(step, sequences=[X], outputs_info=[h0], non_sequences=[Wx, Wh],
                    name="elman")
    pred = pt.dot(H[-1], Wo)[:, 0]
    loss = pt.mean((pred - y) ** 2)
    grads = ptt.grad(loss, [Wx, Wh, Wo])
    updates = {w: w - lr * g for w, g in zip((Wx, Wh, Wo), grads)}
    Xv = rng.standard_normal((seq_len, 4, n_in)).astype(dtype)
    yv = rng.standard_normal(4).astype(dtype)
    return X, y, (Wx, Wh, Wo), loss, grads, updates, (Xv, yv), rng


def make_elman_rnn_bptt(seq_len=64, n_in=32, n_hidden=128, dtype="float32",
                        n_steps_per_call=1, lr=0.01, seed=0, mode=None, device="cuda"):
    """The compiled training step of an Elman RNN on ``device``: scan
    forward, BPTT, SGD updates.

    Returns ``(f, (X, y), (Wx, Wh, Wo))``: ``f(X, y)`` gives the loss
    before the step (of the last step, for a ``train_loop``) and updates
    the weights in place; ``X`` (``(seq_len, 4, n_in)``) and ``y`` are
    numpy arrays."""
    X, y, weights, loss, _, updates, data, _ = elman_graph(seq_len, n_in, n_hidden, dtype, lr,
                                                           seed, device)
    if n_steps_per_call > 1:
        f = ptt.train_loop([X, y], loss, updates, n_steps=n_steps_per_call, mode=mode,
                           name="elman_loop", device=device)
    else:
        f = ptt.function([X, y], loss, updates=updates, mode=mode, name="elman_step",
                         device=device)
    return f, data, weights


def rnn_reference(X, y, Wx, Wh, Wo, lr, steps):
    """``steps`` SGD steps of the Elman model in float64 NumPy, with the
    gradients by backprop through time written out by hand.  Returns
    ``(losses, grads, weights)``: the loss of each step (before its
    update), the gradients ``(gWx, gWh, gWo)`` of the first step, and the
    weights after each step."""
    X, y = np.asarray(X, "float64"), np.asarray(y, "float64")
    W = [np.asarray(w, "float64") for w in (Wx, Wh, Wo)]
    losses, after, first = [], [], None
    for _ in range(steps):
        Wx, Wh, Wo = W
        hs = [np.zeros((X.shape[1], Wh.shape[0]))]
        for x in X:
            hs.append(np.tanh(x @ Wx + hs[-1] @ Wh))
        diff = (hs[-1] @ Wo)[:, 0] - y
        losses.append(float(np.mean(diff * diff)))
        g_pred = 2.0 * diff / diff.size
        gWo = hs[-1].T @ g_pred[:, None]
        gh = g_pred[:, None] @ Wo.T
        gWx, gWh = np.zeros_like(Wx), np.zeros_like(Wh)
        for t in range(len(X), 0, -1):
            ga = gh * (1.0 - hs[t] ** 2)  # through tanh
            gWx += X[t - 1].T @ ga
            gWh += hs[t - 1].T @ ga
            gh = ga @ Wh.T
        grads = (gWx, gWh, gWo)
        first = grads if first is None else first
        W = [w - lr * g for w, g in zip(W, grads)]
        after.append(W)
    return losses, first, after

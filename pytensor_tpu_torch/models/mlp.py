"""MLP training steps and a GEMM chain.

Counterpart of ``pytensor_tpu/models/mlp.py`` (``make_mlp_training_step``,
``make_mlp_mfu_step``, ``make_gemm_chain``), without the ``mesh`` branches
(ROADMAP Queue 1 item 16).  The JAX package makes the device data and
weights of the MFU step and the GEMM chain with ``jax.jit`` ramps of
``sin``; here torch makes the same ramps on the device, so both packages
compute the same values up to the last bits of a float32 ``sin`` of
arguments in the millions (XLA's and CUDA's differ there), then cast to
``dtype`` (bfloat16 by default for the MFU step and the GEMM chain, as in
the JAX package).  Data from ``rng`` stays numpy's; a bfloat16 array on the
host is an ``ml_dtypes.bfloat16`` array.
"""

from __future__ import annotations

import numpy as np
import torch

import pytensor_tpu_torch as ptt
import pytensor_tpu_torch.tensor as pt
from pytensor_tpu_torch.utils import np_dtype


def make_mlp_training_step(n=64, d=32, h=64, dtype="float32", lr=0.1, seed=0,
                           device="cuda"):
    """Compiled SGD step for a 2-layer MLP (tanh, sigmoid head).

    Returns ``(step_fn, (X, y), (W1, b1, W2, b2))``."""
    dtype = np_dtype(dtype)
    rng = np.random.default_rng(seed)
    W1 = ptt.shared((0.1 * rng.standard_normal((d, h))).astype(dtype), name="W1",
                    device=device)
    b1 = ptt.shared(np.zeros(h, dtype), name="b1", device=device)
    W2 = ptt.shared((0.1 * rng.standard_normal((h, 1))).astype(dtype), name="W2",
                    device=device)
    b2 = ptt.shared(np.zeros((), dtype), name="b2", device=device)

    X = pt.tensor("X", dtype=dtype, shape=(None, d))
    y = pt.tensor("y", dtype=dtype, shape=(None,))

    hid = pt.tanh(pt.dot(X, W1) + b1)
    logit = pt.dot(hid, W2)[:, 0] + b2
    p = pt.sigmoid(logit)
    eps = np.asarray(1e-7, dtype)
    loss = -pt.mean(y * pt.log(p + eps) + (1 - y) * pt.log(1 - p + eps))
    grads = ptt.grad(loss, [W1, b1, W2, b2])
    updates = {v: v - lr * g for v, g in zip((W1, b1, W2, b2), grads)}
    f = ptt.function([X, y], loss, updates=updates, name="mlp_step", device=device)
    Xv = rng.random((n, d)).astype(dtype)
    yv = (rng.random(n) < 0.5).astype(dtype)
    return f, (Xv, yv), (W1, b1, W2, b2)


def dev_ramp(n, c, scale=1.0, dtype="float32", device="cuda"):
    """``scale * sin(arange(n) * c)`` in float32 on ``device``, cast to
    ``dtype``: the JAX package's device ramp."""
    ramp = torch.arange(n, dtype=torch.float32, device=device) * c
    return (scale * torch.sin(ramp)).to(getattr(torch, dtype))


def mlp_mfu_graph(batch=4096, d=4096, depth=4, dtype="bfloat16", lr=1e-3, device="cuda"):
    """The graph of ``make_mlp_mfu_step``: ``depth`` square (d, d) GEMMs a
    forward pass, relu between them, an MSE head reduced in float32, and
    its SGD updates.  Returns ``(X, T, Ws, acts, loss, grads, updates,
    (Xd, Td))``: the symbolic data, the shared weights, the products before
    each relu, and the device data the ramps made."""
    Ws = [ptt.shared(dev_ramp(d * d, 0.7 + 0.13 * i, 0.02, dtype, device).reshape(d, d),
                     name=f"W{i}", device=device, borrow=True)
          for i in range(depth)]
    X = pt.tensor("X", dtype=dtype, shape=(batch, d))
    T = pt.tensor("T", dtype=dtype, shape=(batch, d))
    Xd = dev_ramp(batch * d, 0.31, 1.0, dtype, device).reshape(batch, d)
    Td = dev_ramp(batch * d, 0.17, 1.0, dtype, device).reshape(batch, d)

    h, acts = X, []
    for W in Ws:
        acts.append(pt.dot(h, W))
        h = pt.maximum(acts[-1], np.asarray(0, np_dtype(dtype)))
    diff = pt.cast(h - T, "float32")
    loss = pt.mean(diff * diff)
    grads = ptt.grad(loss, Ws)
    lr_c = np.asarray(lr, np_dtype(dtype))
    updates = {W: W - lr_c * pt.cast(g, dtype) for W, g in zip(Ws, grads)}
    return X, T, Ws, acts, loss, grads, updates, (Xd, Td)


def make_mlp_mfu_step(batch=4096, d=4096, depth=4, dtype="bfloat16", lr=1e-3, seed=0,
                      n_steps_per_call=1, device="cuda"):
    """A deep MLP SGD step of ``depth`` square (d, d) GEMMs a forward pass,
    relu between them, an MSE head; the backward pass adds twice the
    forward GEMM FLOPs.  The loss is reduced in float32.

    Returns ``(step_fn, flops_per_step, (X, T))``: ``step_fn(X, T)`` takes
    the device data the ramps made."""
    X, T, _, _, loss, _, updates, data = mlp_mfu_graph(batch, d, depth, dtype, lr, device)
    if n_steps_per_call > 1:
        f = ptt.train_loop([X, T], loss, updates, n_steps=n_steps_per_call,
                           name="mlp_mfu_loop", device=device, trust_input=True)
    else:
        f = ptt.function([X, T], loss, updates=updates, name="mlp_mfu_step", device=device,
                         trust_input=True)
    # forward: depth GEMMs; backward: dX and dW a layer, so 3x the forward
    flops_per_step = depth * 3 * 2 * batch * d * d
    return f, flops_per_step, data


def _f64(v):
    """A tensor or array (bfloat16 included) as a float64 numpy array."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().double().numpy()
    return np.asarray(v).astype("float64")


def _to_bf16(x):
    """float64 values rounded to bfloat16 (through float32, as torch
    converts), as float64."""
    import ml_dtypes

    return np.asarray(x).astype("float32").astype(ml_dtypes.bfloat16).astype("float64")


def mlp_mfu_reference(X, T, Ws, lr, steps, masks=None, bf16=False):
    """The MFU step's SGD steps in float64 NumPy, independent of the graph:
    the check the linked step is held to.  Returns the loss of each step
    (before its update), the weights after each step and the gradients of
    the first step.

    Relu's gradient is a step at 0, so where a product lies within rounding
    of 0 a float32 run and this one may take different sides, and one such
    product moves a whole row of every earlier layer's gradient.  ``masks``
    (a list of ``a >= 0``, one a layer, from the run under test) makes the
    first step's backward pass take the run's sides.

    With ``bf16``, each value the bfloat16 graph rounds is rounded to
    bfloat16 here too (the products, ``h - T``, the loss's gradient where
    it is cast back, the learning rate and the update), the sums still in
    float64.  A bfloat16 network's gradients differ from a float64
    network's by far more than bfloat16's rounding (a gradient is a sum
    over the batch that cancels, and the forward pass's rounding enters
    each term), so the bfloat16 step is held to this one."""
    r = _to_bf16 if bf16 else (lambda x: x)
    Ws, X, T = [_f64(W) for W in Ws], _f64(X), _f64(T)
    lr = float(r(lr))
    losses, after, first = [], [], None
    for step in range(steps):
        hs, acts = [X], []
        for W in Ws:
            acts.append(r(hs[-1] @ W))
            hs.append(np.maximum(acts[-1], 0.0))
        diff = r(hs[-1] - T)
        losses.append(float(np.mean(diff * diff)))
        g = r(2.0 * diff / diff.size)
        grads = [None] * len(Ws)
        for i in reversed(range(len(Ws))):
            # the gradient of maximum(a, 0) at a >= 0
            ga = g * (acts[i] >= 0 if masks is None or step else masks[i])
            grads[i] = r(hs[i].T @ ga)
            g = r(ga @ Ws[i].T)
        first = grads if first is None else first
        Ws = [r(W - r(lr * gW)) for W, gW in zip(Ws, grads)]
        after.append(Ws)
    return losses, after, first


def make_gemm_chain(batch=8192, d=8192, nmat=4, dtype="bfloat16", seed=0,
                    n_steps_per_call=1, device="cuda"):
    """A raw GEMM chain x -> x @ W1 @ ... @ Wn, renormalised so that the
    output can feed the next step; ``n_steps_per_call`` applications are
    one ``train_loop``.  Returns ``(f, flops_per_call)``."""

    def dev_w(i):
        ramp = torch.arange(d * d, dtype=torch.float32, device=device) * (0.7 + 0.13 * i)
        return (torch.sin(ramp) / float(np.sqrt(d))).to(getattr(torch, dtype)).reshape(d, d)

    Ws = [ptt.shared(dev_w(i), name=f"G{i}", device=device, borrow=True) for i in range(nmat)]
    x0 = dev_ramp(batch * d, 0.31, 1.0, dtype, device).reshape(batch, d)
    xs = ptt.shared(x0, name="gx", shape=(batch, d), device=device, borrow=True)
    y = xs
    for W in Ws:
        y = pt.dot(y, W)
    # renormalise in float32 so that repeated application stays finite
    scale = pt.sqrt(pt.mean(pt.cast(y, "float32") ** 2)) + np.float32(1e-6)
    out = pt.cast(pt.cast(y, "float32") / scale, dtype)
    f = ptt.train_loop([], pt.cast(scale, "float32"), {xs: out},
                       n_steps=n_steps_per_call, name="gemm_loop", device=device)
    flops_per_call = n_steps_per_call * nmat * 2 * batch * d * d
    return f, flops_per_call

"""GP marginal likelihood: Cholesky + solve_triangular + logdet + grads
(the linalg hot path of BASELINE.md's "GP marginal likelihood").

Counterpart of ``pytensor_tpu/models/gp.py``, ported whole: the compiled
negative log marginal likelihood with its gradients, and the SGD step on
the hyperparameters (``benchsuite.py:143 ours_gp``), through
``function()`` or, with ``n_steps_per_call > 1``, as one ``train_loop``.
Data comes from numpy's ``default_rng(seed)``, as in the JAX package; the
squared distances of the constant inputs fold into one constant.
"""

from __future__ import annotations

import numpy as np

import pytensor_tpu_torch as ptt
import pytensor_tpu_torch.tensor as pt
from pytensor_tpu_torch.tensor import linalg as ptl

LOG_2PI = float(np.log(2.0 * np.pi))


def gp_data(n=256, d=3, dtype="float64", seed=0):
    """The inputs ``X`` (n, d) and targets ``y`` (n,), numpy arrays."""
    rng = np.random.default_rng(seed)
    Xv = rng.random((n, d)).astype(dtype)
    yv = np.sin(Xv.sum(axis=1)).astype(dtype) + 0.1 * rng.standard_normal(n).astype(dtype)
    return Xv, yv


def _data(n, d, dtype, seed):
    return tuple(pt.as_tensor_variable(v) for v in gp_data(n, d, dtype, seed))


def _factor(X, y, log_ls, log_amp, log_noise, n, dtype):
    """The Cholesky factor of the kernel matrix, alpha = L^-1 y and the
    log determinant."""
    ls, amp, noise = pt.exp(log_ls), pt.exp(log_amp), pt.exp(log_noise)
    sq = ((X[:, None, :] - X[None, :, :]) ** 2).sum(axis=-1)
    K = amp ** 2 * pt.exp(-sq / (2 * ls ** 2)) + (noise ** 2 + 1e-8) * pt.eye(
        n, n, 0, dtype=dtype)
    L = ptl.cholesky(K)
    alpha = ptl.solve_triangular(L, y, lower=True)
    logdet = 2.0 * pt.sum(pt.log(pt.diagonal(L)))
    return alpha, logdet


def make_gp_marginal_likelihood(n=256, d=3, dtype="float64", seed=0, mode=None,
                                device="cuda"):
    """Compiled (log_ls, log_amp, log_noise) -> (nmll, grads) on
    ``device``; returns ``(f, theta0)``, zeros of ``dtype``."""
    X, y = _data(n, d, dtype, seed)
    log_ls = pt.tensor("log_ls", dtype=dtype, shape=())
    log_amp = pt.tensor("log_amp", dtype=dtype, shape=())
    log_noise = pt.tensor("log_noise", dtype=dtype, shape=())
    alpha, logdet = _factor(X, y, log_ls, log_amp, log_noise, n, dtype)
    mll = -0.5 * pt.sum(alpha ** 2) - 0.5 * logdet - 0.5 * n * LOG_2PI
    nmll = -mll
    grads = ptt.grad(nmll, [log_ls, log_amp, log_noise])
    f = ptt.function([log_ls, log_amp, log_noise], [nmll, *grads], mode=mode,
                     name="gp_mll", device=device)
    theta0 = tuple(np.zeros((), dtype) for _ in range(3))
    return f, theta0


def make_gp_sgd_step(n=256, d=3, dtype="float64", seed=0, lr=1e-3, mode=None,
                     n_steps_per_call=1, device="cuda"):
    """One compiled SGD step on the GP hyperparameters, the update inside
    the function; returns ``(f, params)``, the shared ``log_ls``,
    ``log_amp`` and ``log_noise`` (zeros) on ``device``.  ``f()`` gives the
    nmll before the step (of the last step, for a ``train_loop``)."""
    X, y = _data(n, d, dtype, seed)
    params = [ptt.shared(np.zeros((), dtype), name=nm, device=device)
              for nm in ("log_ls", "log_amp", "log_noise")]
    alpha, logdet = _factor(X, y, *params, n, dtype)
    nmll = 0.5 * pt.sum(alpha ** 2) + 0.5 * logdet + 0.5 * n * LOG_2PI
    grads = ptt.grad(nmll, params)
    updates = [(p, p - np.asarray(lr, dtype) * g) for p, g in zip(params, grads)]
    if n_steps_per_call > 1:
        f = ptt.train_loop([], nmll, updates, n_steps=n_steps_per_call, mode=mode,
                           name="gp_sgd_loop", device=device)
    else:
        f = ptt.function([], nmll, updates=updates, mode=mode, name="gp_sgd", device=device)
    return f, params


def gp_reference(X, y, theta, lr=1e-3, steps=1):
    """``steps`` SGD steps of the GP hyperparameters ``theta`` (log length
    scale, log amplitude, log noise) in float64 NumPy, from the closed-form
    gradient ``0.5 tr((K^-1 - b b^T) dK/dtheta)`` with ``b = K^-1 y``.
    Returns ``(nmlls, grads, thetas)``: the nmll and the gradient of each
    step (before its update), and theta after each step."""
    X, y = np.asarray(X, "float64"), np.asarray(y, "float64")
    n = len(y)
    sq = ((X[:, None, :] - X[None, :, :]) ** 2).sum(axis=-1)
    theta = np.asarray(theta, "float64")
    nmlls, grads, thetas = [], [], []
    for _ in range(steps):
        ls, amp, noise = np.exp(theta)
        E = np.exp(-sq / (2 * ls ** 2))
        K = amp ** 2 * E + (noise ** 2 + 1e-8) * np.eye(n)
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L, y)
        nmlls.append(0.5 * alpha @ alpha + np.log(np.diag(L)).sum() + 0.5 * n * LOG_2PI)
        Kinv = np.linalg.inv(K)
        beta = Kinv @ y
        W = Kinv - np.outer(beta, beta)
        dK = (amp ** 2 * E * sq / ls ** 2, 2 * amp ** 2 * E, 2 * noise ** 2 * np.eye(n))
        g = np.array([0.5 * np.sum(W * d) for d in dK])  # tr(W dK), both symmetric
        grads.append(g)
        theta = theta - lr * g
        thetas.append(theta)
    return nmlls, grads, thetas


"""Linear-Gaussian state-space model: Kalman-filter log-likelihood and
its gradient, built as a Scan over (predict, update) steps with
Cholesky-based innovations solves inside the loop body.

Counterpart of ``pytensor_tpu/models/kalman.py``, ported whole, with
``numpy_kalman_loglike``, plus ``make_kalman_sgd_step``: the SGD loop on
the transition matrix of ``benchsuite.py:1129 ours_kalman`` (a shared
``T``, the data of ``benchsuite.py:1052 _kalman_sim`` from seed 0).  The
PyMC statespace shape: a scan whose body mixes matmuls, a Cholesky,
triangular solves and a log determinant, differentiated through the
linalg pullbacks by backprop through time.  The rewrites push the
gradient's factorisations and solves out of the reverse scan as
``Blockwise`` nodes over the 64 steps.

Model:
    x_t = T x_{t-1} + w_t,   w_t ~ N(0, Q)
    y_t = Z x_t    + v_t,    v_t ~ N(0, H)
with log-likelihood sum_t log N(y_t; Z x_t|t-1, F_t) via the innovations
decomposition.  The log-likelihood is float64 on float32 data, as in the
JAX package: ``kalman_loglike`` multiplies by a float64 constant.
"""

from __future__ import annotations

import numpy as np

import pytensor_tpu_torch as ptt
import pytensor_tpu_torch.tensor as pt
from pytensor_tpu_torch.tensor import linalg as ptl

LOG_2PI = float(np.log(2.0 * np.pi))


def kalman_loglike(ys, T, Z, Q, H, x0, P0):
    """Symbolic Kalman-filter log-likelihood of ``ys`` (n_steps, p).

    All operands are symbolic matrices/vectors; returns a scalar.
    """
    # observation dim: static when known, else the symbolic shape —
    # a fallback constant would silently skew -0.5*p*log(2pi)
    p_static = Z.type.shape[0]

    def step(y_t, x_pred, P_pred, T_, Z_, Q_, H_):
        # innovations
        v = y_t - pt.dot(Z_, x_pred)
        F = pt.dot(Z_, pt.dot(P_pred, Z_.T)) + H_
        L = ptl.cholesky(F)
        alpha = ptl.solve_triangular(L, v, lower=True)
        p_f = (np.float64(p_static) if p_static is not None
               else pt.cast(y_t.shape[0], "float64"))
        ll_t = -0.5 * (pt.sum(alpha ** 2)
                       + 2.0 * pt.sum(pt.log(pt.diagonal(L)))
                       + p_f * LOG_2PI)
        # Kalman gain via two triangular solves: K = P Z^T F^-1
        PZt = pt.dot(P_pred, Z_.T)
        W = ptl.solve_triangular(L, PZt.T, lower=True)
        K = ptl.solve_triangular(L.T, W, lower=False).T
        x_filt = x_pred + pt.dot(K, v)
        P_filt = P_pred - pt.dot(K, pt.dot(Z_, P_pred))
        # predict
        x_next = pt.dot(T_, x_filt)
        P_next = pt.dot(T_, pt.dot(P_filt, T_.T)) + Q_
        return x_next, P_next, ll_t

    (xs, Ps, lls), _ = ptt.scan(
        step,
        sequences=[ys],
        outputs_info=[x0, P0, None],
        non_sequences=[T, Z, Q, H],
    )
    return pt.sum(lls)


def make_kalman_loglike_and_grad(n_steps=64, k=4, p=2, dtype="float64",
                                 seed=0, mode=None, device="cuda"):
    """Compiled (T, log_q, log_h) -> (loglike, grads) on simulated data."""
    rng = np.random.default_rng(seed)
    T_true = np.eye(k) * 0.9 + 0.05 * rng.standard_normal((k, k))
    Z_np = rng.standard_normal((p, k)).astype(dtype)
    x = np.zeros(k)
    ys = np.empty((n_steps, p), dtype=dtype)
    for t in range(n_steps):
        x = T_true @ x + 0.3 * rng.standard_normal(k)
        ys[t] = Z_np @ x + 0.2 * rng.standard_normal(p)

    ys_c = pt.as_tensor_variable(ys.astype(dtype))
    Z = pt.as_tensor_variable(Z_np.astype(dtype))
    T = pt.tensor("T", dtype=dtype, shape=(k, k))
    log_q = pt.tensor("log_q", dtype=dtype, shape=())
    log_h = pt.tensor("log_h", dtype=dtype, shape=())
    Q = pt.exp(log_q) * pt.eye(k, k, 0, dtype=dtype)
    H = pt.exp(log_h) * pt.eye(p, p, 0, dtype=dtype)
    x0 = pt.as_tensor_variable(np.zeros(k, dtype=dtype))
    P0 = pt.as_tensor_variable(np.eye(k, dtype=dtype))

    ll = kalman_loglike(ys_c, T, Z, Q, H, x0, P0)
    grads = ptt.grad(ll, [T, log_q, log_h])
    f = ptt.function([T, log_q, log_h], [ll, *grads], mode=mode,
                     name="kalman_loglike", device=device)
    theta0 = (T_true.astype(dtype), np.asarray(np.log(0.09), dtype),
              np.asarray(np.log(0.04), dtype))
    return f, theta0, (ys, Z_np)


def kalman_sim(n_steps=64, k=4, p=2, dtype="float32", seed=0):
    """The data of ``benchsuite.py:1052 _kalman_sim``: ``(ys, T_true, Z)``."""
    rng = np.random.default_rng(seed)
    T_true = (np.eye(k) * 0.9 + 0.05 * rng.standard_normal((k, k))).astype(dtype)
    Z_np = rng.standard_normal((p, k)).astype(dtype)
    x = np.zeros(k)
    ys = np.empty((n_steps, p), dtype=dtype)
    for t in range(n_steps):
        x = T_true @ x + 0.3 * rng.standard_normal(k)
        ys[t] = Z_np @ x + 0.2 * rng.standard_normal(p)
    return ys, T_true, Z_np


def make_kalman_sgd_step(n_steps=64, k=4, p=2, lr=1e-5, n_steps_per_call=1, seed=0,
                         mode=None, device="cuda"):
    """The loop of ``benchsuite.py:1129 ours_kalman``: ``T += lr * dll/dT``
    on a shared ``T`` (float32), through ``function()`` or, with
    ``n_steps_per_call > 1``, as one ``train_loop``.  Returns
    ``(f, T, (ys, T_true, Z))``; ``f()`` gives the log-likelihood before
    the step (of the last step, for a ``train_loop``)."""
    ys, T_true, Z_np = kalman_sim(n_steps, k, p, seed=seed)
    T = ptt.shared(T_true.copy(), name="T", device=device)
    Q = pt.as_tensor_variable((0.09 * np.eye(k)).astype("float32"))
    H = pt.as_tensor_variable((0.04 * np.eye(p)).astype("float32"))
    x0 = pt.as_tensor_variable(np.zeros(k, dtype="float32"))
    P0 = pt.as_tensor_variable(np.eye(k, dtype="float32"))
    ll = kalman_loglike(pt.as_tensor_variable(ys), T, pt.as_tensor_variable(Z_np), Q, H,
                        x0, P0)
    g = ptt.grad(ll, T)
    updates = [(T, T + np.float32(lr) * g)]
    if n_steps_per_call > 1:
        f = ptt.train_loop([], ll, updates, n_steps=n_steps_per_call, mode=mode,
                           name="kalman_loop", device=device)
    else:
        f = ptt.function([], ll, updates=updates, mode=mode, name="kalman_step", device=device)
    return f, T, (ys, T_true, Z_np)


def numpy_kalman_loglike(ys, T, Z, q, h, x0=None, P0=None):
    """Plain-numpy filter for testing."""
    n, p = ys.shape
    k = T.shape[0]
    x = np.zeros(k) if x0 is None else x0.copy()
    P = np.eye(k) if P0 is None else P0.copy()
    Q = q * np.eye(k)
    H = h * np.eye(p)
    ll = 0.0
    for t in range(n):
        v = ys[t] - Z @ x
        F = Z @ P @ Z.T + H
        Fi = np.linalg.inv(F)
        ll += -0.5 * (v @ Fi @ v + np.linalg.slogdet(F)[1] + p * LOG_2PI)
        K = P @ Z.T @ Fi
        x = x + K @ v
        P = P - K @ Z @ P
        x = T @ x
        P = T @ P @ T.T + Q
    return ll


def numpy_kalman_grad(ys, T, Z, log_q, log_h, eps=1e-6):
    """The gradient of ``numpy_kalman_loglike`` with respect to ``T``,
    ``log_q`` and ``log_h`` by central differences in float64."""
    ys, T, Z = (np.asarray(v, "float64") for v in (ys, T, Z))
    theta = np.concatenate([T.ravel(), [float(log_q), float(log_h)]])

    def ll(th):
        return numpy_kalman_loglike(ys, th[:-2].reshape(T.shape), Z, np.exp(th[-2]),
                                    np.exp(th[-1]))

    g = np.empty_like(theta)
    for i in range(len(theta)):
        d = np.zeros_like(theta)
        d[i] = eps
        g[i] = (ll(theta + d) - ll(theta - d)) / (2 * eps)
    return g[:-2].reshape(T.shape), g[-2], g[-1]


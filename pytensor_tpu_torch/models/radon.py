"""Hierarchical radon model logp + dlogp: the NUTS inner-loop workload.

Counterpart of ``pytensor_tpu/models/radon.py``.  A PyMC-style
varying-intercept model with non-centered parameterization,

    a_raw ~ N(0, 1)            [n_counties]
    mu_a ~ N(0, 10); log_sigma_a, log_sigma_y ~ N(0, 2); b ~ N(0, 10)
    a = mu_a + sigma_a * a_raw
    y ~ N(a[county] + b * floor, sigma_y)

The graphs map the flat free-parameter vector to (logp, dlogp), which is
what a NUTS leapfrog step evaluates; ``leapfrog`` drives a linked
function the way a sampler does.  ``make_radon_trajectory`` is a
sampler's trajectory as a while-scan: leapfrog steps that stop where the
energy diverges.  ``guarded_graphs`` is the model with a sampler's guards:
an ``IfElse`` on a finite proposal and two asserts.
"""

from __future__ import annotations

import numpy as np

import pytensor_tpu_torch as ptt
import pytensor_tpu_torch.tensor as pt

LOG_2PI = float(np.log(2.0 * np.pi))


def radon_synthetic_data(n_obs=919, n_counties=85, seed=0, dtype="float64"):
    """Synthetic data with the dimensions of the classic radon dataset."""
    rng = np.random.default_rng(seed)
    county = rng.integers(0, n_counties, size=n_obs).astype("int64")
    floor = (rng.random(n_obs) < 0.35).astype(dtype)
    true_a = rng.normal(1.5, 0.35, size=n_counties)
    log_radon = (true_a[county] - 0.65 * floor
                 + rng.normal(0.0, 0.75, size=n_obs)).astype(dtype)
    return county, floor, log_radon


def _normal_logp(x, mu, sigma):
    return -0.5 * ((x - mu) / sigma) ** 2 - pt.log(sigma) - 0.5 * LOG_2PI


def make_radon_graphs(n_obs=919, n_counties=85, dtype="float64", seed=0):
    """Return (inputs, [logp, dlogp], n_params) uncompiled, for linking."""
    county_v, floor_v, y_v = radon_synthetic_data(n_obs, n_counties, seed, dtype)
    n_params = n_counties + 4
    theta = pt.tensor("theta", dtype=dtype, shape=(n_params,))
    county = pt.as_tensor_variable(county_v)
    floor = pt.as_tensor_variable(floor_v)
    y = pt.as_tensor_variable(y_v)
    a_raw = theta[:n_counties]
    mu_a = theta[n_counties]
    log_sigma_a = theta[n_counties + 1]
    b = theta[n_counties + 2]
    log_sigma_y = theta[n_counties + 3]
    sigma_a = pt.exp(log_sigma_a)
    sigma_y = pt.exp(log_sigma_y)
    a = mu_a + sigma_a * a_raw
    mu_y = a[county] + b * floor
    logp = (
        pt.sum(_normal_logp(y, mu_y, sigma_y))
        + pt.sum(_normal_logp(a_raw, 0.0, 1.0))
        + pt.sum(_normal_logp(mu_a, 0.0, 10.0))
        + pt.sum(_normal_logp(b, 0.0, 10.0))
        + pt.sum(_normal_logp(log_sigma_a, 0.0, 2.0))
        + pt.sum(_normal_logp(log_sigma_y, 0.0, 2.0))
        + log_sigma_a + log_sigma_y
    )
    dlogp = ptt.grad(logp, theta)
    return [theta], [logp, dlogp], n_params


def make_radon_logp_batched(n_obs=919, n_counties=85, dtype="float64", seed=0):
    """Multi-chain variant: theta has shape (chains, n_params), logp is
    per-chain (chains,).  NUTS-style samplers run many chains in parallel."""
    county_v, floor_v, y_v = radon_synthetic_data(n_obs, n_counties, seed, dtype)
    n_params = n_counties + 4
    theta = pt.tensor("theta", dtype=dtype, shape=(None, n_params))
    county = pt.as_tensor_variable(county_v)
    floor = pt.as_tensor_variable(floor_v)
    y = pt.as_tensor_variable(y_v)

    a_raw = theta[:, :n_counties]                       # (chains, n_c)
    mu_a = theta[:, n_counties]                         # (chains,)
    log_sigma_a = theta[:, n_counties + 1]
    b = theta[:, n_counties + 2]
    log_sigma_y = theta[:, n_counties + 3]
    sigma_a = pt.exp(log_sigma_a)
    sigma_y = pt.exp(log_sigma_y)
    a = mu_a[:, None] + sigma_a[:, None] * a_raw        # (chains, n_c)
    mu_y = a[:, county] + b[:, None] * floor[None, :]   # (chains, n_obs)

    logp = (
        pt.sum(_normal_logp(y[None, :], mu_y, sigma_y[:, None]), axis=1)
        + pt.sum(_normal_logp(a_raw, 0.0, 1.0), axis=1)
        + _normal_logp(mu_a, 0.0, 10.0)
        + _normal_logp(b, 0.0, 10.0)
        + _normal_logp(log_sigma_a, 0.0, 2.0)
        + _normal_logp(log_sigma_y, 0.0, 2.0)
        + log_sigma_a + log_sigma_y
    )
    dlogp = ptt.grad(logp.sum(), theta)  # chains decouple: per-chain grads
    return theta, logp, dlogp, n_params


def theta_start(n_params, dtype="float64"):
    """The starting point both packages use: zeros, log-scales at -0.3."""
    theta0 = np.zeros(n_params, dtype=dtype)
    theta0[n_params - 3] = -0.3
    theta0[n_params - 1] = -0.3
    return theta0


def leapfrog(fn, theta, m, n_steps, eps):
    """``n_steps`` leapfrog steps over a linked ``fn(theta) -> (logp,
    dlogp)``, as a sampler's host loop drives it; returns
    ``(theta, m, logp)`` at the end of the trajectory.

    Each step is a half kick, a drift and a half kick.  The gradient at
    the end of one step is the one the next step starts with, so the loop
    evaluates ``fn`` ``n_steps + 1`` times.  Works for one chain
    (``theta`` of shape (n_params,)) and for the batched graph.
    """
    half = eps / 2
    logp, g = fn(theta)
    for _ in range(n_steps):
        m = m + half * g
        theta = theta + eps * m
        logp, g = fn(theta)
        m = m + half * g
    return theta, m, logp


def make_leapfrog_chain(dtype="float32", n_chains=None, n_steps=8192, n_obs=919,
                        n_counties=85, device="cuda", eps=1e-3):
    """The leapfrog chain of ``bench.py:40 build_ours``, through ``scan``
    and ``function``: ``f(theta0, m0) -> [theta, m, logp]`` after
    ``n_steps`` steps, each a half kick, a drift and a half kick with two
    ``dlogp`` evaluations.  ``n_chains=None`` is one chain of shape
    ``(n_params,)``; else ``theta0`` is ``(n_chains, n_params)`` and
    ``logp`` the sum over chains.

    One float32 chain is compiled with ``config.scan__pallas`` and
    ``mode.including("onehot_gather")``, so that on a CUDA device the
    whole chain is one launch of K2; the other chains take the step loop.
    Inputs are trusted: pass tensors of the right dtype and shape on
    ``device``.
    """
    from pytensor_tpu_torch.compile.mode import get_mode
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.graph.replace import graph_replace

    mode = None
    if n_chains is None:
        inputs, (logp, dlogp), n_params = make_radon_graphs(n_obs, n_counties, dtype)
        theta_in = inputs[0]
        shape = (n_params,)
        final_red = lambda lp: lp  # noqa: E731
        if dtype == "float32":
            mode = get_mode(None).including("onehot_gather")
    else:
        theta_in, logp, dlogp, n_params = make_radon_logp_batched(n_obs, n_counties, dtype)
        shape = (n_chains, n_params)
        final_red = lambda lp: lp.sum()  # noqa: E731

    theta0 = pt.tensor("theta0", dtype=dtype, shape=shape)
    m0 = pt.tensor("m0", dtype=dtype, shape=shape)

    def step(theta, m):
        g = graph_replace(dlogp, {theta_in: theta})
        m_half = m + (eps / 2) * g
        theta_new = theta + eps * m_half
        g_new = graph_replace(dlogp, {theta_in: theta_new})
        return theta_new, m_half + (eps / 2) * g_new

    with config.change_flags(scan__pallas=n_chains is None and dtype == "float32"):
        (thetas, ms), _ = ptt.scan(step, outputs_info=[theta0, m0], n_steps=n_steps,
                                   name="leapfrog")
        final_logp = final_red(graph_replace(logp, {theta_in: thetas[-1]}))
        return ptt.function([theta0, m0], [thetas[-1], ms[-1], final_logp],
                            name="leapfrog_chain", mode=mode, trust_input=True,
                            device=device)


MAX_DH = 1000.0  # a sampler's divergence test: |H - H0| > 1000


def trajectory_graphs(ptt, pt, graphs, n_steps, eps, stop=True):
    """``(theta0, m0, traces)`` of a package's namespaces (``ptt`` the
    package, ``pt`` its tensor module) over its radon ``graphs``
    (``make_radon_graphs``' result): a leapfrog trajectory of ``n_steps``
    steps of ``eps`` (numbers or scalar variables) from ``(theta0, m0)``,
    ``traces`` its ``[thetas, ms, hs]`` with the energy ``H = -logp +
    |m|^2 / 2`` after each step.  With ``stop``, a while-scan that stops
    after the first step at which ``|H - H0| > MAX_DH`` (the traces are
    then the executed prefix); else a for-scan that computes the same
    test a step and traces it as a fourth output."""
    import importlib

    until = importlib.import_module(ptt.__name__ + ".scan").until
    graph_replace = importlib.import_module(ptt.__name__ + ".graph.replace").graph_replace
    (theta_in,), (logp, dlogp), n_params = graphs
    dtype = theta_in.type.dtype
    theta0 = pt.tensor("theta0", dtype=dtype, shape=(n_params,))
    m0 = pt.tensor("m0", dtype=dtype, shape=(n_params,))

    def energy(theta, m):
        return -graph_replace(logp, {theta_in: theta}) + 0.5 * pt.sum(m * m)

    def step(theta, m, h0, eps):
        m_half = m + (eps / 2) * graph_replace(dlogp, {theta_in: theta})
        theta_new = theta + eps * m_half
        m_new = m_half + (eps / 2) * graph_replace(dlogp, {theta_in: theta_new})
        h = energy(theta_new, m_new)
        diverged = pt.gt(pt.abs(h - h0), MAX_DH)
        if stop:
            return (theta_new, m_new, h), until(diverged)
        return theta_new, m_new, h, diverged

    traces, _ = ptt.scan(step, outputs_info=[theta0, m0, None] + ([] if stop else [None]),
                         non_sequences=[energy(theta0, m0), eps], n_steps=n_steps,
                         name="trajectory")
    return theta0, m0, list(traces)


def make_radon_trajectory(stop=True, n_obs=919, n_counties=85, mode=None, *, device="cuda"):
    """``f(theta0, m0, eps, n_steps) -> traces``: ``trajectory_graphs`` of
    the radon model in float64 with the step size and the step count as
    inputs, linked (in ``mode``).  With ``stop`` (a while-scan) the
    traces' length is the exit step; the function runs eagerly, as the
    step loop reads its condition on the host after each step (and the
    step count is read on the host)."""
    graphs = make_radon_graphs(n_obs, n_counties, "float64")
    eps, n_steps = pt.scalar("eps", dtype="float64"), pt.scalar("n_steps", dtype="int64")
    theta0, m0, traces = trajectory_graphs(ptt, pt, graphs, n_steps, eps, stop)
    return ptt.function([theta0, m0, eps, n_steps], traces, name="radon_trajectory", mode=mode,
                        device=device)


DATA_MESSAGE = "radon: the observations must be finite"
SCALE_MESSAGE = "radon: sigma_y must be positive"


def guarded_graphs(ptt, pt, n_obs=919, n_counties=85, dtype="float64", seed=0, asserts=True,
                   conditional=True):
    """``([theta, y], [logp, dlogp], n_params, y_value)`` of a package's
    namespaces (``ptt`` the package, ``pt`` its tensor module): the radon
    model with its observations ``y`` an input (``y_value`` the synthetic
    data) and a sampler's guards.  With ``conditional``, ``logp`` and
    ``dlogp`` are ``ifelse(all(isfinite(theta)), [logp, dlogp], [-inf,
    zeros_like(theta)])`` (dlogp's shape and dtype), so that a proposal
    holding a NaN or an infinity computes nothing of the model.  With ``asserts`` the graph carries two
    asserts: one on ``sigma_y = exp(log_sigma_y)``, which the assumptions
    prove (``local_remove_proven_assert`` drops it), and one that the
    observations are finite, which they cannot prove."""
    import importlib

    Assert = importlib.import_module(ptt.__name__ + ".raise_op").Assert
    county_v, floor_v, y_v = radon_synthetic_data(n_obs, n_counties, seed, dtype)
    n_params = n_counties + 4
    theta = pt.tensor("theta", dtype=dtype, shape=(n_params,))
    y_in = pt.tensor("y", dtype=dtype, shape=(n_obs,))
    y = Assert(DATA_MESSAGE)(y_in, pt.all(pt.isfinite(y_in))) if asserts else y_in
    county = pt.as_tensor_variable(county_v)
    floor = pt.as_tensor_variable(floor_v)

    def normal_logp(x, mu, sigma):
        return -0.5 * ((x - mu) / sigma) ** 2 - pt.log(sigma) - 0.5 * LOG_2PI

    a_raw = theta[:n_counties]
    mu_a = theta[n_counties]
    log_sigma_a = theta[n_counties + 1]
    b = theta[n_counties + 2]
    log_sigma_y = theta[n_counties + 3]
    sigma_a = pt.exp(log_sigma_a)
    sigma_y = pt.exp(log_sigma_y)
    if asserts:
        sigma_y = Assert(SCALE_MESSAGE)(sigma_y, sigma_y)
    a = mu_a + sigma_a * a_raw
    mu_y = a[county] + b * floor
    logp = (
        pt.sum(normal_logp(y, mu_y, sigma_y))
        + pt.sum(normal_logp(a_raw, 0.0, 1.0))
        + pt.sum(normal_logp(mu_a, 0.0, 10.0))
        + pt.sum(normal_logp(b, 0.0, 10.0))
        + pt.sum(normal_logp(log_sigma_a, 0.0, 2.0))
        + pt.sum(normal_logp(log_sigma_y, 0.0, 2.0))
        + log_sigma_a + log_sigma_y
    )
    dlogp = ptt.grad(logp, theta)
    if conditional:
        ok = pt.all(pt.isfinite(theta))
        # zeros_like(theta), not zeros_like(dlogp): that is second(dlogp, 0),
        # which reads dlogp, so the other branch would compute the gradient
        logp, dlogp = ptt.ifelse(ok, [logp, dlogp],
                                 [pt.as_tensor_variable(np.asarray(-np.inf, dtype=dtype)),
                                  pt.zeros_like(theta)])
    return [theta, y_in], [logp, dlogp], n_params, y_v


def radon_logp_dlogp_reference(theta, n_obs=919, n_counties=85, seed=0):
    """Closed-form logp and analytic dlogp in float64 NumPy, independent of
    the graph: the check the linked functions are held to.  ``theta`` is
    (n_params,) or (chains, n_params)."""
    county, floor, y = radon_synthetic_data(n_obs, n_counties, seed, "float64")
    th = np.atleast_2d(np.asarray(theta, dtype="float64"))
    a_raw = th[:, :n_counties]
    mu, lsa, b, lsy = (th[:, n_counties + k] for k in range(4))
    sig_a, sig_y = np.exp(lsa), np.exp(lsy)
    a = mu[:, None] + sig_a[:, None] * a_raw
    r = (y[None, :] - a[:, county] - b[:, None] * floor[None, :]) / sig_y[:, None]
    c = 0.5 * LOG_2PI
    logp = (-0.5 * (r ** 2).sum(1) - n_obs * (lsy + c)
            - 0.5 * (a_raw ** 2).sum(1) - n_counties * c
            - 0.5 * (mu / 10) ** 2 - np.log(10.0) - c
            - 0.5 * (b / 10) ** 2 - np.log(10.0) - c
            - 0.5 * (lsa / 2) ** 2 - np.log(2.0) - c
            - 0.5 * (lsy / 2) ** 2 - np.log(2.0) - c
            + lsa + lsy)
    rs = r / sig_y[:, None]
    seg = np.zeros_like(a_raw)
    for k in range(th.shape[0]):
        np.add.at(seg[k], county, rs[k])
    grad = np.empty_like(th)
    grad[:, :n_counties] = sig_a[:, None] * seg - a_raw
    grad[:, n_counties] = seg.sum(1) - mu / 100
    grad[:, n_counties + 1] = sig_a * (a_raw * seg).sum(1) - lsa / 4 + 1
    grad[:, n_counties + 2] = (rs * floor[None, :]).sum(1) - b / 100
    grad[:, n_counties + 3] = (r ** 2).sum(1) - n_obs - lsy / 4 + 1
    if np.ndim(theta) == 1:
        return logp[0], grad[0]
    return logp, grad

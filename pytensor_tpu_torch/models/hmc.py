"""A whole HMC transition as one linked function.

Counterpart of ``pytensor_tpu/models/hmc.py``: leapfrog integration
through ``scan``, momentum and Metropolis draws on the device (threefry,
``tensor/random/``), and the RNG keys and the position carried across
calls as shared variables.  Each entry point returns a ``function`` of no
inputs; on a card a call is one replay of one captured CUDA graph
(``link/torch/linker.py``), the keys and the position stay on the card and
nothing is read back on the host.  With ``config.scan__pallas`` on when a
function is linked, a leapfrog scan that K2 takes is one K2 launch
(``link/cuda/scan_kernel.py``).  Every entry point takes ``device``, the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

import numpy as np

import pytensor_tpu_torch as ptt
import pytensor_tpu_torch.tensor as pt
from pytensor_tpu_torch.graph.replace import graph_replace
from pytensor_tpu_torch.tensor.random import RandomStream


def _leapfrog(dlogp, theta_in, step_size):
    def leapfrog(theta, m):
        g = graph_replace(dlogp, {theta_in: theta})
        m_half = m + (step_size / 2) * g
        theta_new = theta + step_size * m_half
        g_new = graph_replace(dlogp, {theta_in: theta_new})
        m_new = m_half + (step_size / 2) * g_new
        return theta_new, m_new

    return leapfrog


def make_hmc_step(make_logp_graph, n_params, n_leapfrog=16, step_size=0.02,
                  dtype="float32", seed=0, mode=None, device="cuda"):
    """A compiled HMC transition.

    ``make_logp_graph() -> (theta_input_var, logp_var)``.  Returns
    ``(step_fn, position_shared)``: each call advances the chain one
    transition and returns ``(logp, accepted)``.
    """
    theta_in, logp = make_logp_graph()
    dlogp = ptt.grad(logp, theta_in)

    srng = RandomStream(seed=seed, device=device)
    position = ptt.shared(np.zeros(n_params, dtype), name="hmc_position", device=device)

    m0 = pt.cast(srng.normal(0.0, 1.0, size=(n_params,)), dtype)
    (thetas, ms), lf_updates = ptt.scan(
        _leapfrog(dlogp, theta_in, step_size), outputs_info=[position, m0],
        n_steps=n_leapfrog, name="hmc_leapfrog")
    theta_prop = thetas[-1]
    m_prop = ms[-1]

    logp0 = graph_replace(logp, {theta_in: position})
    logp1 = graph_replace(logp, {theta_in: theta_prop})
    h0 = logp0 - 0.5 * pt.sum(m0 ** 2)
    h1 = logp1 - 0.5 * pt.sum(m_prop ** 2)
    log_accept_ratio = h1 - h0

    u = srng.uniform(0.0, 1.0)
    accept = pt.lt(pt.log(u), log_accept_ratio)
    new_position = pt.switch(accept, theta_prop, position)
    new_logp = pt.switch(accept, logp1, logp0)

    updates = dict(lf_updates)
    updates[position] = pt.cast(new_position, dtype)
    step = ptt.function([], [new_logp, accept], updates=updates, mode=mode, name="hmc_step",
                        device=device)
    return step, position


def make_radon_hmc(n_obs=919, n_counties=85, dtype="float32", device="cuda", **kwargs):
    """``make_hmc_step`` on the radon model's logp (``models/radon.py``)."""
    from pytensor_tpu_torch.models.radon import make_radon_graphs

    def build():
        inputs, (logp, _dlogp), _ = make_radon_graphs(n_obs=n_obs, n_counties=n_counties,
                                                      dtype=dtype)
        return inputs[0], logp

    return make_hmc_step(build, n_counties + 4, dtype=dtype, device=device, **kwargs)


def make_radon_hmc_chains(n_chains=256, n_obs=919, n_counties=85, n_leapfrog=16,
                          step_size=0.02, dtype="float32", seed=0, mesh=None,
                          device="cuda"):
    """Many chains, each advancing one full transition a call.

    Returns ``(step_fn, position_shared, n_params)``; ``step_fn() -> (logp
    per chain, accept per chain)``.  Chains sharded over a mesh wait for
    the port's distributed layer (ROADMAP.md Queue 1, item 16).
    """
    from pytensor_tpu_torch.models.radon import make_radon_logp_batched

    if mesh is not None:
        raise NotImplementedError(
            "chains sharded over a mesh come with the port's parallel layer "
            "(ROADMAP.md Queue 1, item 16)")
    theta_in, logp, dlogp, n_params = make_radon_logp_batched(
        n_obs=n_obs, n_counties=n_counties, dtype=dtype, seed=seed)

    srng = RandomStream(seed=seed, device=device)
    position = ptt.shared(np.zeros((n_chains, n_params), dtype), name="hmc_chains_position",
                          device=device)
    m0 = pt.cast(srng.normal(0.0, 1.0, size=(n_chains, n_params)), dtype)
    (thetas, ms), lf_updates = ptt.scan(
        _leapfrog(dlogp, theta_in, step_size), outputs_info=[position, m0],
        n_steps=n_leapfrog, name="hmc_chains_leapfrog")
    theta_prop = thetas[-1]
    m_prop = ms[-1]

    logp0 = graph_replace(logp, {theta_in: position})
    logp1 = graph_replace(logp, {theta_in: theta_prop})
    h0 = logp0 - 0.5 * pt.sum(m0 ** 2, axis=1)
    h1 = logp1 - 0.5 * pt.sum(m_prop ** 2, axis=1)
    log_accept_ratio = h1 - h0

    u = srng.uniform(0.0, 1.0, size=(n_chains,))
    accept = pt.lt(pt.log(pt.cast(u, dtype)), log_accept_ratio)
    new_position = pt.switch(accept[:, None], theta_prop, position)
    new_logp = pt.switch(accept, logp1, logp0)

    updates = dict(lf_updates)
    updates[position] = new_position
    f = ptt.function([], [new_logp, accept], updates=updates, name="hmc_chains_step",
                     device=device)
    return f, position, n_params


def make_multinomial_hmc_step(make_logp_graph, n_params, n_leapfrog=16, step_size=0.02,
                              dtype="float32", seed=0, device="cuda"):
    """Multinomial HMC: the next state is drawn from the whole trajectory
    with weights softmax(H_t), by a Gumbel-max pick (Betancourt 2017, "A
    conceptual introduction to HMC", app. A.3); a second scan computes
    the energies along the trajectory.  ``step_fn() -> (logp, index)``.
    """
    theta_in, logp = make_logp_graph()
    dlogp = ptt.grad(logp, theta_in)

    srng = RandomStream(seed=seed, device=device)
    position = ptt.shared(np.zeros(n_params, dtype), name="mhmc_position", device=device)
    m0 = pt.cast(srng.normal(0.0, 1.0, size=(n_params,)), dtype)
    (thetas, ms), lf_updates = ptt.scan(
        _leapfrog(dlogp, theta_in, step_size), outputs_info=[position, m0],
        n_steps=n_leapfrog, name="mhmc_leapfrog")

    # H_t along the trajectory (the start point included)
    def H(theta, m):
        return graph_replace(logp, {theta_in: theta}) - 0.5 * pt.sum(m ** 2)

    Hs, _ = ptt.scan(lambda th, mm: H(th, mm), sequences=[thetas, ms],
                     name="mhmc_energies")
    H0 = H(position, m0)
    all_H = pt.concatenate([H0[None], Hs], axis=0)     # (T+1,)
    all_theta = pt.concatenate([position[None, :], thetas], axis=0)

    # Gumbel-max: idx = argmax(H_t + G_t) draws t with weight exp(H_t)
    u = srng.uniform(0.0, 1.0, size=(n_leapfrog + 1,))
    gumbel = -pt.log(-pt.log(pt.cast(u, dtype) + 1e-12) + 1e-12)
    idx = pt.argmax(all_H + gumbel)
    new_position = all_theta[idx]
    new_logp = graph_replace(logp, {theta_in: new_position})

    updates = dict(lf_updates)
    updates[position] = new_position
    f = ptt.function([], [new_logp, idx], updates=updates, name="multinomial_hmc_step",
                     device=device)
    return f, position


def make_radon_multinomial_hmc(n_obs=919, n_counties=85, dtype="float32", device="cuda",
                               **kwargs):
    """``make_multinomial_hmc_step`` on the radon model's logp; returns
    ``(step_fn, position_shared, n_params)``."""
    from pytensor_tpu_torch.models.radon import make_radon_graphs

    inputs, (logp, _), n_params = make_radon_graphs(n_obs=n_obs, n_counties=n_counties,
                                                    dtype=dtype)

    def build():
        return inputs[0], logp

    # the step keeps its own dtype (float32 unless given), as the JAX
    # package's does: ``dtype`` is the model's
    return (*make_multinomial_hmc_step(build, n_params, device=device, **kwargs), n_params)

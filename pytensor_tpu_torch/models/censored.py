"""A censored-likelihood gradient: the shape-parameter gradients at work.

``logp = sum(log(gammaincc(k, t / theta))) + sum(log(betainc(a, b, y)))``,
PyMC's right-censored Gamma term (the log survival function of
Gamma(k, scale theta) at the censored times ``t``) and a Beta(a, b)
log-CDF term at the proportions ``y``, and its gradient in the four float64
parameters.  The gradient in ``k`` is ``gammaincc_ddk``, those in ``a`` and
``b`` ``betainc_dda`` and ``betainc_ddb``: on a card K1 emits each inside
the fused nodes of the gradient.  ``censored_graph`` builds the graph
from either package's public API (the tests build it in both);
``censored_reference`` is scipy's ``logp`` and its central differences.
"""

from __future__ import annotations

import numpy as np

CENSORED_N = 2 ** 20
# the data: survival times from Gamma(2.5, scale 3), proportions from Beta(2, 5)
DATA_GAMMA, DATA_BETA = (2.5, 3.0), (2.0, 5.0)
# the parameters the function is evaluated at: k, theta, a, b
PARAMS = (2.2, 2.8, 1.8, 4.6)


def censored_data(n=CENSORED_N, seed=0):
    """``(t, y)``, float64, made with numpy from ``seed``."""
    rng = np.random.default_rng(seed)
    return rng.gamma(*DATA_GAMMA, size=n), rng.beta(*DATA_BETA, size=n)


def censored_graph(ptt, pt):
    """``(inputs, outputs)``: inputs ``[t, y, k, theta, a, b]``, outputs
    ``[logp, dk, dtheta, da, db]``, through the public API of the package
    whose ``function`` module and ``tensor`` module are ``ptt`` and ``pt``."""
    t, y = pt.dvector("t"), pt.dvector("y")
    k, theta, a, b = (pt.dscalar(name) for name in ("k", "theta", "a", "b"))
    logp = pt.sum(pt.log(pt.gammaincc(k, t / theta))) + pt.sum(pt.log(pt.betainc(a, b, y)))
    return [t, y, k, theta, a, b], [logp, *ptt.grad(logp, [k, theta, a, b])]


def make_censored_logp(*, device="cuda"):
    """The port's function of ``(t, y, k, theta, a, b)``: ``[logp, dk,
    dtheta, da, db]``."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt

    ins, outs = censored_graph(ptt, pt)
    return ptt.function(ins, outs, device=device)


def censored_logp_np(t, y, k, theta, a, b):
    import scipy.special as sps

    return float(np.sum(np.log(sps.gammaincc(k, t / theta)))
                 + np.sum(np.log(sps.betainc(a, b, y))))


def censored_reference(t, y, params=PARAMS):
    """scipy's ``logp`` and its gradient in each parameter by the
    4th-order central difference (step 1e-5 of the parameter)."""
    params = [float(p) for p in params]
    grads = []
    for i, p in enumerate(params):
        h = 1e-5 * max(1.0, abs(p))

        def at(step):
            moved = list(params)
            moved[i] = p + step
            return censored_logp_np(t, y, *moved)

        grads.append((8 * (at(h) - at(-h)) - (at(2 * h) - at(-2 * h))) / (12 * h))
    return censored_logp_np(t, y, *params), grads

"""The RBM Gibbs chain: a restricted Boltzmann machine's sampler as one
linked function.

The graph is the JAX package's Gibbs chain (``tests/test_ref_scan2.py:764
test_gibbs_chain``): a step draws the hidden units as ``binomial(1,
sigmoid(v W + bhid))`` and the visible ones as ``binomial(1, sigmoid(h Wᵀ
+ bvis))``, cast to float32, under ``scan`` with a ``RandomStream``; the
function returns the chain's last visible sample.  Its width is the
sampling step of the DeepLearningTutorials RBM (LISA lab, ``code/rbm.py``,
``test_rbm``): 784 visible and 500 hidden units, 20 chains, 1,000 Gibbs
steps between samples (``plot_every``), float32, W uniform in
``±4 sqrt(6 / (n_hidden + n_visible))`` and the biases 0, as its
``RBM.__init__`` draws them (here from a numpy seed; no MNIST is needed).

Every binomial draw has ``count * q <= 1``, so it takes jax's inversion
loop; the BTRS loop still runs on jax's dummy parameters (the binomial
kernel's pass 1 finds no element needs more, and its pass 2 returns at
once).  On a card a call is one replay of one captured CUDA graph: per
step two products, the fused elementwise work, a split of each stream's
key (threefry) and two binomial launches a draw, with nothing read back
on the host.  K2 refuses the scan (no RandomVariable is on its white
list, ``link/cuda/scan_kernel.py``), so it runs as the step loop.  Every
entry point takes ``device``, the card unless the caller asks for the
CPU.
"""

from __future__ import annotations

import numpy as np

import pytensor_tpu_torch as ptt
import pytensor_tpu_torch.tensor as pt
from pytensor_tpu_torch.tensor.math import dot, sigmoid
from pytensor_tpu_torch.tensor.random import RandomStream

# DeepLearningTutorials code/rbm.py test_rbm's sampling step
N_VISIBLE, N_HIDDEN, N_CHAINS, PLOT_EVERY = 784, 500, 20, 1000


def rbm_weights(n_visible=N_VISIBLE, n_hidden=N_HIDDEN, n_chains=N_CHAINS, seed=0):
    """``(W, hbias, vbias, v0)`` in float32 from ``np.random.default_rng(seed)``:
    W uniform in ``±4 sqrt(6 / (n_hidden + n_visible))`` and the biases 0,
    as ``rbm.py`` initialises them, and the chains' start a
    ``binomial(1, 0.5)`` of ``(n_chains, n_visible)``, as the JAX
    package's test makes it."""
    rng = np.random.default_rng(seed)
    bound = 4 * np.sqrt(6.0 / (n_hidden + n_visible))
    W = rng.uniform(-bound, bound, size=(n_visible, n_hidden)).astype("float32")
    v0 = rng.binomial(1, 0.5, size=(n_chains, n_visible)).astype("float32")
    return W, np.zeros(n_hidden, "float32"), np.zeros(n_visible, "float32"), v0


def gibbs_step(W, bhid, bvis, trng):
    """The JAX package's step: visible sample -> visible sample."""

    def fstep(vsample_tm1):
        hmean_t = sigmoid(dot(vsample_tm1, W) + bhid)
        hsample_t = pt.cast(trng.binomial(1, hmean_t, size=hmean_t.shape), dtype="float32")
        vmean_t = sigmoid(dot(hsample_t, W.T) + bvis)
        return pt.cast(trng.binomial(1, vmean_t, size=vmean_t.shape), dtype="float32")

    return fstep


def make_gibbs_chain(W, bhid, bvis, n_steps=PLOT_EVERY, stream_seed=99, device="cuda"):
    """The Gibbs chain over ``n_steps`` steps on the weights ``W``,
    ``bhid`` and ``bvis`` (float32 arrays, held as shared variables on
    ``device``).  Returns ``(f, shared)``: ``f(v)`` runs the chain from the
    visible sample ``v`` (chains x n_visible, float32) and returns its last
    sample, each call advancing the stream's keys; ``shared`` is
    ``(W, bhid, bvis)``."""
    Ws = ptt.shared(W, "vW", device=device)
    bhid_s = ptt.shared(bhid, "vbhid", device=device)
    bvis_s = ptt.shared(bvis, "vbvis", device=device)
    vsample = pt.matrix(dtype="float32")
    trng = RandomStream(stream_seed, device=device)
    samples, updates = ptt.scan(gibbs_step(Ws, bhid_s, bvis_s, trng), [], vsample, [],
                                n_steps=n_steps)
    f = ptt.function([vsample], samples[-1], updates=updates, name="rbm_gibbs",
                     device=device)
    return f, (Ws, bhid_s, bvis_s)


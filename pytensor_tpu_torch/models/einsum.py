"""The einsum loop of ``benchsuite.py:197 ours_einsum``.

A shared float32 ``a`` (``m`` x ``n``, 32 x 4,096 there) and constants
``b`` (``n`` x ``m``), ``c`` (``m`` x ``n``) and ``d`` (``n`` x ``m``), drawn
in that order from ``np.random.default_rng(seed)``, as ``benchsuite.py``
draws them.  One application is ``out = einsum("ij,jk,kl,lm->im", a, b,
c, d)`` and the update ``a[:m, :m] = out / (sum(|out|) + 1)``.  The order
of the contractions decides the cost: ``(a b)``, then ``(c d)``, then
their ``m`` x ``m`` product, is ``4 m^2 n + 2 m^3`` FLOPs (1.684e7 at
benchsuite's size), the path the port's ``Einsum`` lowering plans;
``b c`` first would cost ``2 n^2 m`` more.  ``make_einsum_loop`` runs
``n_steps`` applications as one ``train_loop`` call; ``make_einsum_step``
one, through ``function()``, where K1 fuses the update's scaling.
``einsum_reference`` is the same loop in float64 NumPy.
"""

from __future__ import annotations

import numpy as np

EINSUM_M, EINSUM_N = 32, 4096
SPEC = "ij,jk,kl,lm->im"


def einsum_data(m=EINSUM_M, n=EINSUM_N, seed=0):
    """``(a0, b, c, d)`` as float32 arrays, in ``benchsuite.py``'s order."""
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal(s).astype("float32")
                 for s in ((m, n), (n, m), (m, n), (n, m)))


def einsum_flops(m=EINSUM_M, n=EINSUM_N):
    """FLOPs of one application's contractions on the optimal path, as
    ``np.einsum_path`` counts them (two a multiply-add)."""
    return 4 * m * m * n + 2 * m ** 3


def _graph(m, n, seed, device):
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt

    a0, b, c, d = einsum_data(m, n, seed)
    a = ptt.shared(a0, name="a", device=device)
    out = pt.einsum(SPEC, a, pt.constant(b), pt.constant(c), pt.constant(d))
    upd = pt.set_subtensor(a[:m, :m], out / (pt.sum(pt.abs(out)) + 1.0))
    return a, out, upd


def make_einsum_loop(n_steps=64, *, m=EINSUM_M, n=EINSUM_N, seed=0, device="cuda"):
    """``(f, a)``: ``f()`` runs ``n_steps`` applications, returns the last
    one's ``sum(out)`` and leaves the state in the shared ``a``."""
    import pytensor_tpu_torch as ptt

    a, out, upd = _graph(m, n, seed, device)
    return ptt.train_loop([], out.sum(), {a: upd}, n_steps=n_steps, name="einsum_loop",
                          device=device), a


def make_einsum_step(*, m=EINSUM_M, n=EINSUM_N, seed=0, device="cuda"):
    """``(f, a)``: ``f()`` runs one application with the same update and
    returns its ``sum(out)``."""
    import pytensor_tpu_torch as ptt

    a, out, upd = _graph(m, n, seed, device)
    return ptt.function([], out.sum(), updates={a: upd}, name="einsum_step", device=device), a


def einsum_reference(a0, b, c, d, n_steps):
    """The loop in float64: ``a`` after ``n_steps`` applications and the
    last one's ``sum(out)``."""
    a = np.asarray(a0, dtype="float64").copy()
    b, c, d = (np.asarray(x, dtype="float64") for x in (b, c, d))
    m = a.shape[0]
    total = None
    for _ in range(n_steps):
        out = (a @ b) @ (c @ d)
        total = out.sum()
        a[:m, :m] = out / (np.abs(out).sum() + 1.0)
    return a, total

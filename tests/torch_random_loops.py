"""The harness of the loop-sampler tests (``tests/test_torch_random_loops.py``
and ``tests/test_torch_random_loops_cont.py``): each sampler's parameter
grid, one function of its draws at three shapes in each package, and the
rules its draws are held to against the JAX package's.

The grids (``link/cuda/cases.py loop_grid``, which the card shares) span
each branch of jax's samplers: ``lam`` 0, 1e-3, 3, 9.999,
10, 50, 1e4 and NaN (Knuth, PTRS, the edges); ``n`` 0, 1, 10, 100, 1e4,
-3 and inf against ``p`` 0, 1e-3, 0.3, 0.5, 0.7, 1 and NaN (inversion,
BTRS, jax's edges; jax's loop never ends for an infinite ``n`` with ``p``
0 or 1, so those two pairs are left out); gamma's alpha 1e-3, 0.5, 1, 2.5,
100, 0 and NaN; dirichlet's alpha 1e-2 to 10.  A grid is tiled over the
draw's shape, so a draw mixes the branches as one whole-array loop.

The rules, and why:

- integer draws equal on every element, but for the elements of
  ``NEAR_THRESHOLD``: there an accept test of PTRS falls within rounding of
  its threshold (XLA on the CPU fuses multiplies and adds and rounds its
  own float32 ``lgamma``, which at lam 1e4 moves ``t`` by hundredths);
  ``ptrs_near_threshold`` shows it for each, pass by pass;
- float32 draws within 8 ulps; float64 draws within 1e-12 relative, and for
  beta and dirichlet, which exponentiate differences of loggammas, within
  1e-12 plus 6e-14 times the loggammas' magnitudes (``log_scale``): XLA's
  float64 ``log1p`` on the CPU is off by up to 2.7e-14 relative on
  (-1, -0.2) (over 2**20 uniforms, against numpy's, which is within an
  ulp), and loggamma multiplies it by 1 / alpha;
- XLA on the CPU flushes subnormal results to zero; the port keeps IEEE
  subnormals, so a port value below the dtype's smallest normal is held as
  0.
"""

import numpy as np
import torch

from pytensor_tpu_torch.link.cuda.cases import (
    LOOP_GAMMA_ALPHA as GAMMA_ALPHA,
    LOOP_LAM as LAM,
    LOOP_NP as NP,
    loop_grid,
)
from pytensor_tpu_torch.tensor.random import samplers as S
from pytensor_tpu_torch.tensor.random import threefry as tf
from tests.torch_random import PKGS, kw

SHAPES = [(7,), (3, 5), (4096,)]
SEED = 17

# (sampler, shape) -> {flat index: (the port's draw, the JAX package's)}:
# PTRS accept tests within float32 rounding of their threshold at these
# seeds (Poisson draws in float32 whatever floatX)
NEAR_THRESHOLD = {
    ("poisson", (4096,)): {190: (9800, 9952), 2414: (10032, 10239), 2630: (9946, 10054),
                           4046: (10010, 9743)},
}


def _rv(ptr, name, params, rng):
    if name == "gamma":
        # the second parameter by keyword: positionally it is the rate
        return ptr.gamma(params[0], scale=params[1], rng=rng)
    return getattr(ptr, name)(*params, rng=rng)


def draw_grid(name, floatx):
    """``name``'s draws at ``SHAPES`` in both packages, the grids as
    function inputs in ``floatx``: ``{"jax": [...], "torch": [...],
    "perform": [...]}`` (the last from each of the port's RV nodes'
    ``perform`` on the same key), the port's sample key of each shape and
    the grid's parameters at each shape."""
    out, keys, grids = {}, [], []
    for pkg, (ptt, pt, ptr, config) in PKGS.items():
        with config.change_flags(floatX=floatx):
            ins, xs, vals = [], [], []
            for j, shape in enumerate(SHAPES):
                arrs = [a.astype(floatx) for a in loop_grid(name, shape)]
                vs = [pt.tensor(dtype=floatx, shape=(None,) * a.ndim) for a in arrs]
                xs.append(_rv(ptr, name, vs, ptr.rng(SEED + j, **kw(pkg))))
                ins += vs
                vals += arrs
            f = ptt.function(ins, xs, **kw(pkg))
            out[pkg] = [np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v)
                        for v in f(*vals)]
            if pkg == "torch":
                out["perform"] = []
                k = 0
                for x in xs:
                    node = x.owner
                    params = vals[k: k + len(node.inputs) - 2]
                    k += len(params)
                    grids.append(params)
                    key = node.inputs[0].get_value()
                    keys.append(tf.split(torch.as_tensor(key.numpy().astype(np.int64)))[1])
                    storage = [[None], [None]]
                    node.op.perform(node, [key.numpy(), None, *params], storage)
                    out["perform"].append(storage[1][0])
    return out, keys, grids


def _flush(a):
    if a.dtype.kind != "f":
        return a
    return np.where(np.abs(a) < np.finfo(a.dtype).tiny, np.zeros_like(a), a)


def log_scale(name, key, params, shape):
    """For beta and dirichlet, the magnitude of the loggammas whose
    difference each draw exponentiates (the port's, at the sample key
    ``key``): |log G_a| + |log G_b|, or a component's |log G| plus its
    row's largest; else None."""
    if name == "beta":
        keys = tf.split(key)
        a, b = (torch.as_tensor(p, dtype=torch.float64) for p in params)
        return (S.loggamma(keys[0], a, shape).abs() + S.loggamma(keys[1], b, shape).abs()).numpy()
    if name == "dirichlet":
        x = S.loggamma(key, torch.as_tensor(params[0], dtype=torch.float64),
                       tuple(params[0].shape)).abs()
        return (x + x.amax(-1, keepdim=True)).numpy()
    return None


def float_bound(want, scale=None):
    """The tolerance of each float draw against the JAX package's ``want``,
    ``scale`` the ``log_scale`` of its draws."""
    w = want.astype("float64")
    if want.dtype == np.float32:
        return 8 * np.spacing(np.abs(want)).astype("float64")
    bound = 1e-12 * np.abs(w)
    if scale is not None:
        bound = bound + 6e-14 * np.where(np.isfinite(scale), scale, 0.0) * np.abs(w)
    return bound


def mismatches(got, want, scale=None):
    """The flat indices where ``got`` is not held to ``want``."""
    assert got.shape == want.shape and got.dtype == want.dtype, (
        name, got.shape, want.shape, got.dtype, want.dtype)
    if want.dtype.kind in "iub":
        return np.nonzero((got != want).reshape(-1))[0]
    g, w = _flush(got).astype("float64"), want.astype("float64")
    same = (g == w) | (np.isnan(g) & np.isnan(w))
    with np.errstate(invalid="ignore"):
        ok = same | (np.abs(g - w) <= float_bound(want, scale))
    return np.nonzero(~ok.reshape(-1))[0]


def ptrs_passes(key, lam):
    """The passes of jax's whole-array PTRS loop over ``lam`` (float32,
    Knuth's elements on the dummy 1e5) under ``key``, in the plain
    version's arithmetic: for each pass ``(k, s, t, accept1, reject,
    scale)``, ``scale`` the sum of t's terms' magnitudes."""
    lam = torch.as_tensor(lam, dtype=torch.float32)
    n = lam.numel()
    lr = torch.where(torch.isnan(lam) | (lam < 10), 1e5, lam)
    log_lam = torch.log(lr)
    b = 0.931 + 2.53 * torch.sqrt(lr)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + S.true_div(1.1328, b - 3.4)
    v_r = 0.9277 - S.true_div(3.6224, b - 2)
    accepted = torch.zeros(n, dtype=torch.bool)
    while not bool(accepted.all()):
        keys = S._split(key, 3)
        key = keys[0]
        u = S._uniform(keys[1], n, torch.float32) - 0.5
        v = S._uniform(keys[2], n, torch.float32)
        us = 0.5 - torch.abs(u)
        k = torch.floor((2 * a / us + b) * u + lr + 0.43)
        s = torch.log(v * inv_alpha / (a / (us * us) + b))
        t = -lr + k * log_lam - torch.lgamma(k + 1)
        accept1 = (us >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((us < 0.013) & (v > us))
        scale = lr.abs() + (k * log_lam).abs() + torch.lgamma(k + 1).abs()
        yield k, s, t, accept1, reject, scale
        accepted |= accept1 | (~reject & (s <= t))


def ptrs_near_threshold(key, lam, i, draws):
    """Whether element ``i`` of a PTRS draw of ``lam`` (float32) under
    ``key`` has a pass whose accept test ``s <= t`` falls within 8 float32
    ulps of the sum of t's terms' magnitudes, and that pass's k is one of
    ``draws`` (the port's and the JAX package's)."""
    for k, s, t, accept1, reject, scale in ptrs_passes(key, lam):
        near = abs(float(s[i] - t[i])) <= 8 * 2.0 ** -23 * float(scale[i])
        if not accept1[i] and not reject[i] and near and int(k[i]) in draws:
            return True
    return False

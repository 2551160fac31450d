"""The harness of the Random tests (``tests/test_torch_random.py``,
``tests/test_torch_random_dists.py``): both packages by name, the
tolerances the port's draws are held to, and one function of many draws
in each package.

Tolerances: integer and bool draws and keys exactly; float32 draws within
one float32 ulp; float64 draws within 1e-11 relative.
"""

import numpy as np
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
import pytensor_tpu.tensor.random as jrand
from pytensor_tpu.config import config as jconfig
import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
import pytensor_tpu_torch.tensor.random as trand
from pytensor_tpu_torch.config import config as tconfig

PKGS = {"jax": (jptt, jpt, jrand, jconfig), "torch": (tptt, tpt, trand, tconfig)}
CPU = {"device": "cpu"}


def kw(name):
    return CPU if name == "torch" else {}


def as_np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    return np.asarray(v)


def held(got, want, what=""):
    """The port's draws against the JAX package's at the stated tolerance."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what)
    ok = ~np.isnan(want)
    g, w = got[ok], want[ok]
    if want.dtype == np.float32:
        bound = np.spacing(np.abs(w))
    else:
        bound = 1e-11 * np.abs(w)
    assert np.all(np.abs(g.astype("float64") - w.astype("float64")) <= bound), (
        what, np.max(np.abs(g.astype("float64") - w.astype("float64")) - bound))


def rv_pair(ptr, srng, rng, name, params, size):
    """A draw of ``name`` from the stream and one from the key ``rng``."""
    if name == "choice":
        a, how = params
        return (srng.choice(a, size=size, **how), ptr.choice(a, size=size, rng=rng, **how))
    if name == "permutation":
        return srng.permutation(params[0]), ptr.permutation(params[0], rng=rng)
    return (getattr(srng, name)(*params, size=size),
            getattr(ptr, name)(*params, size=size, rng=rng))


def draw_all(pkg, cases, floatx):
    """One function of every case's stream draw, next explicit key and
    explicit draw; returns it and the stream draws.  The JAX side is its
    numpy oracle (``mode="FAST_COMPILE"``: ``RandomVariable.perform``, the
    same split and ``jax.random`` sampler, run op by op), since XLA takes
    ~25 s to compile the batch (14 s for vonmises' 24 unrolled rounds);
    the other tests hold the port to the JAX package's XLA path."""
    ptt, pt, ptr, config = PKGS[pkg]
    outs, streams = [], []
    with config.change_flags(floatX=floatx):
        for k, (name, params, size) in enumerate(cases):
            srng = ptr.RandomStream(23 + k, **kw(pkg))
            xs, xe = rv_pair(ptr, srng, ptr.rng(99 + k, **kw(pkg)), name, params, size)
            outs += [xs, xe.owner.outputs[0], xe]
            streams.append(xs)
        return ptt.function([], outs, **(kw(pkg) or {"mode": "FAST_COMPILE"})), streams


def check_cases(cases, floatx):
    """Each case of ``cases`` in both packages, two calls."""
    fns = {pkg: draw_all(pkg, cases, floatx) for pkg in PKGS}
    res = {}
    for call in range(2):
        want, got = fns["jax"][0](), fns["torch"][0]()
        for k, (name, _, _) in enumerate(cases):
            res.setdefault(name, []).append((got[3 * k: 3 * k + 3], want[3 * k: 3 * k + 3]))
    for k, (name, _, _) in enumerate(cases):
        res[name].append(([fns["torch"][1][k].rng.get_value()],
                          [fns["jax"][1][k].rng.get_value()]))
    return res


def check(res, name):
    for got, want in res[name]:
        for g, w, what in zip(got, want, ("stream draw", "next key", "draw")):
            held(g, w, f"{name} {what}")

"""jax's loop samplers in the port (ROADMAP Queue 1, item 7b), against the
JAX package on the CPU: the discrete ones.

- poisson, binomial, negative_binomial, betabinom and multinomial, in
  float32 and float64, at the shapes (7,), (3, 5) and (4096,), on grids
  spanning each branch (``tests/torch_random_loops.py``), through
  ``function(..., device="cpu")`` and through each RV's ``perform``:
  every element equal, but for the named PTRS accept tests within float32
  rounding of their threshold, each shown pass by pass;
- jax's size dependence: PTRS and BTRS keep the k of an element's last
  accept before the whole array's loop ends, so element 0 of a (4096,)
  draw is not element 0 of a (1,) draw.  At 40 keys, element 0 of both
  equals the JAX package's, and the two differ at the same keys as in the
  JAX package;
- the kernels' plain versions on whole arrays: the Poisson draw of a
  (4096,) grid equals the same lam drawn alone where the loop is Knuth's
  (monotone), and the binomial's inversion elements likewise.
"""

import numpy as np
import pytest
import torch

from tests.torch_random import PKGS, kw
from tests.torch_random_loops import (
    LAM,
    NEAR_THRESHOLD,
    SHAPES,
    draw_grid,
    loop_grid,
    mismatches,
    ptrs_near_threshold,
)
from pytensor_tpu_torch.tensor.random import samplers as S

DISCRETE = ["poisson", "binomial", "negative_binomial", "betabinom", "multinomial"]


@pytest.mark.parametrize("floatx", ["float32", "float64"])
@pytest.mark.parametrize("name", DISCRETE)
def test_discrete_sampler_against_jax(name, floatx):
    out, keys, _ = draw_grid(name, floatx)
    for j, shape in enumerate(SHAPES):
        want = out["jax"][j]
        named = NEAR_THRESHOLD.get((name, shape), {})
        for path in ("torch", "perform"):
            got = out[path][j]
            bad = mismatches(got, want)
            seen = {int(i): (int(got.reshape(-1)[i]), int(want.reshape(-1)[i])) for i in bad}
            assert seen == named, (name, floatx, shape, path, seen)
        lam = loop_grid(name, shape)[0].reshape(-1).astype("float32")
        for i, draws in named.items():
            assert ptrs_near_threshold(keys[j], lam, i, draws), (name, shape, i, draws)


def _size_pairs(pkg, name, params, n_keys):
    ptt, pt, ptr, config = PKGS[pkg]
    outs = []
    for k in range(n_keys):
        for size in ((4096,), (1,)):
            outs.append(getattr(ptr, name)(*params, size=size, rng=ptr.rng(1000 + k, **kw(pkg))))
    f = ptt.function([], outs, **(kw(pkg) or {"mode": "FAST_COMPILE"}))
    r = [np.asarray(v.numpy() if isinstance(v, torch.Tensor) else v) for v in f()]
    return np.array([x[0] for x in r[0::2]]), np.array([x[0] for x in r[1::2]])


@pytest.mark.parametrize("name,params", [("poisson", (50.0,)), ("binomial", (100, 0.4))])
def test_jax_size_dependence_pinned(name, params):
    got_big, got_one = _size_pairs("torch", name, params, 40)
    want_big, want_one = _size_pairs("jax", name, params, 40)
    np.testing.assert_array_equal(got_big, want_big)
    np.testing.assert_array_equal(got_one, want_one)
    differ = got_big != got_one
    np.testing.assert_array_equal(differ, want_big != want_one)
    assert differ.sum() >= 30, differ.sum()


def test_monotone_loops_do_not_depend_on_the_array():
    key = torch.tensor([7, 11], dtype=torch.int64)
    lam = torch.tensor(np.resize(LAM, 4096), dtype=torch.float32)
    whole = S.poisson_loops(key, lam)
    knuth = (torch.isnan(lam) | (lam < 10)).nonzero()[:, 0][:40]
    for i in knuth.tolist():
        alone = S.poisson_loops(key, torch.full((i + 1,), float(lam[i])))[i]
        assert int(alone) == int(whole[i]), i
    count = torch.tensor(np.resize([0.0, 1, 10, 100], 4096))
    prob = torch.tensor(np.resize([0.3, 1e-3, 0.05, 0.02], 4096))
    whole = S.binomial_loops(key, count, prob)
    for i in range(0, 4096, 257):
        alone = S.binomial_loops(key, count[: i + 1].clone(), prob[: i + 1].clone())[i]
        assert float(alone) == float(whole[i]), i

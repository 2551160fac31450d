"""Tier A of the port's Random against the JAX package's, on the CPU.

Each distribution whose jax sampler is a closed form of threefry bits,
at two parameter sets (float32 under ``floatX=float32``, float64 under
``floatX=float64``) and two sizes (none, and an explicit one), drawn
through a ``RandomStream`` (two calls: the key advanced by the default
update) and through an explicit shared key with its next key, and
``choice`` and ``permutation`` in each of their modes.  The JAX side runs
the same ``jax.random`` samplers through its numpy oracle (see
``torch_random.py draw_all``).  Integer draws and keys exactly, float32
draws within one float32 ulp, float64 draws within 1e-11 relative.
"""

import functools

import numpy as np
import pytest

from tests.torch_random import PKGS, check, check_cases, draw_all

f32, f64 = np.float32, np.float64


def _arr(dtype, *vals):
    return np.asarray(vals if len(vals) > 1 else vals[0], dtype=dtype)


SPD = np.array([[2.0, 0.3, 0.1], [0.3, 1.5, -0.2], [0.1, -0.2, 1.0]])

# name -> (float32 parameters, float64 parameters, the explicit size)
TIER_A = {
    "uniform": ((f32(-1.5), f32(2.0)), (_arr(f64, 0.0, 1.0, 2.0), f64(3.5)), (4, 3)),
    "normal": ((f32(0.5), f32(2.0)), (_arr(f64, -1.0, 0.0, 4.0), f64(0.25)), (2, 3)),
    "standard_normal": ((), (), (5,)),
    "halfnormal": ((f32(0.0), f32(1.5)), (_arr(f64, 1.0, 2.0), f64(0.5)), (3, 2)),
    "lognormal": ((f32(0.1), f32(0.7)), (_arr(f64, 0.0, 1.0), f64(0.3)), (4, 2)),
    "exponential": ((f32(2.0),), (_arr(f64, 0.5, 1.0, 3.0),), (2, 3)),
    "weibull": ((f32(1.7),), (_arr(f64, 0.8, 2.5),), (3, 2)),
    "logistic": ((f32(0.0), f32(2.0)), (_arr(f64, -1.0, 1.0), f64(0.5)), (3, 2)),
    "cauchy": ((f32(1.0), f32(0.5)), (_arr(f64, 0.0, 2.0), f64(1.5)), (2, 2)),
    "halfcauchy": ((f32(0.0), f32(1.0)), (_arr(f64, 0.5, 1.0), f64(2.0)), (3, 2)),
    "pareto": ((f32(2.5), f32(1.5)), (_arr(f64, 1.0, 3.0), f64(2.0)), (3, 2)),
    "gumbel": ((f32(0.5), f32(2.0)), (_arr(f64, 0.0, -1.0), f64(1.0)), (3, 2)),
    "laplace": ((f32(0.0), f32(1.0)), (_arr(f64, 1.0, -2.0), f64(0.5)), (2, 2)),
    "rayleigh": ((f32(1.5),), (_arr(f64, 0.5, 2.0),), (3, 2)),
    "triangular": ((f32(-1.0), f32(0.5), f32(2.0)), (f64(0.0), _arr(f64, 0.2, 0.8), f64(1.0)),
                   (4, 2)),
    "truncated_normal": ((f32(0.0), f32(1.0), f32(-0.5), f32(1.5)),
                         (_arr(f64, 0.0, 1.0), f64(2.0), f64(-1.0), f64(2.5)), (3, 2)),
    "wald": ((f32(1.0), f32(2.0)), (_arr(f64, 0.5, 2.0), f64(1.5)), (3, 2)),
    "vonmises": ((f32(0.5), f32(2.0)), (_arr(f64, 0.0, 1.0), f64(4.0)), (3, 2)),
    "truncexpon": ((f32(2.0), f32(0.0), f32(1.0)), (_arr(f64, 1.0, 3.0), f64(0.5), f64(2.0)),
                   (3, 2)),
    "bernoulli": ((f32(0.3),), (_arr(f64, 0.1, 0.5, 0.9),), (2, 3)),
    "categorical": ((_arr(f32, 0.2, 0.3, 0.5),),
                    (np.array([[0.1, 0.6, 0.3], [0.5, 0.25, 0.25]]),), (4, 2)),
    "integers": ((np.int64(-3), np.int64(10)), (np.array([0, 5, 1000]), np.int64(2 ** 40)),
                 (2, 3)),
    "geometric": ((f32(0.3),), (_arr(f64, 0.05, 0.5),), (3, 2)),
    "multivariate_normal": ((_arr(f32, 0.0, 1.0, -1.0), SPD.astype(f32)),
                            (_arr(f64, 1.0, 2.0, 3.0), SPD), (4,)),
    "hypergeometric": ((np.int64(10), np.int64(7), np.int64(5)),
                       (np.array([4, 20]), np.int64(9), np.int64(6)), (3, 2)),
}


@functools.lru_cache(maxsize=None)
def _tier_a(floatx, sized):
    cases = []
    for name, (p32, p64, size) in TIER_A.items():
        params = p32 if floatx == "float32" else p64
        if name == "multivariate_normal":
            # a float32 draw goes through jax's float32 erfinv and Cholesky:
            # held in float64 parameters and float32 draws instead
            params = p64
        cases.append((name, params, size if sized else None))
    return check_cases(cases, floatx)


@pytest.mark.parametrize("sized", [False, True], ids=["no_size", "size"])
@pytest.mark.parametrize("floatx", ["float32", "float64"])
@pytest.mark.parametrize("name", list(TIER_A))
def test_tier_a(name, floatx, sized):
    check(_tier_a(floatx, sized), name)


CHOICES = ["replace", "no_replace", "p_replace", "p_no_replace", "permutation",
           "permutation_matrix"]


@functools.lru_cache(maxsize=None)
def _choices():
    a = np.arange(10, dtype="int64") * 3
    p = np.linspace(1.0, 2.0, 10)
    p = p / p.sum()
    cases = []
    for case in CHOICES:
        if case.startswith("permutation"):
            x = np.arange(12.0).reshape(4, 3) if case.endswith("matrix") else a
            cases.append(("permutation", (x,), None))
            continue
        kw = {"replace": "no_replace" not in case}
        if case.startswith("p_"):
            kw["p"] = p
        cases.append(("choice", (a, kw), (4,)))
    fns = {pkg: draw_all(pkg, cases, "float64") for pkg in PKGS}
    res = {}
    for call in range(2):
        want, got = fns["jax"][0](), fns["torch"][0]()
        for k, case in enumerate(CHOICES):
            res.setdefault(case, []).append((got[3 * k: 3 * k + 3], want[3 * k: 3 * k + 3]))
    return res


@pytest.mark.parametrize("case", CHOICES)
def test_choice_and_permutation(case):
    check(_choices(), case)

"""The special-function rewrites of ``tensor/rewriting/math.py``, op for op.

``local_one_pm_erf``, ``local_log_erfc`` (with ``_erfc_thresholds``),
``local_grad_log_erfc_neg``, ``local_grad_log_erfc_neg_mul``,
``local_reciprocal_1_plus_exp``, ``local_sigm_times_exp``,
``local_odds_sigmoid``, ``local_sigmoid_of_logit``,
``local_logit_of_sigmoid``, ``local_logdiffexp``, ``local_log_kv_iv`` and
``local_polygamma_specialize``: the graphs of the JAX package's
``tests/test_ref_rewriting_math.py`` (its ``TestLocalErf``,
``TestLocalErfc``, ``TestSigmoidRewrites``, ``TestLogExpStabilize``)
built in both packages and compiled with the default ``FAST_RUN``.  The
rewritten graphs hold the same ops in the same order (a FusedElemwise
with the same inner ops), each rewrite fires as often in both (counted by
wrapping ``FromFunctionNodeRewriter.transform``, the ``fired`` fixture),
and the values are the JAX package's at rtol 1e-12 and its test's own
expectations, in the tails too, where the rewrites change the value.
"""

import numpy as np
import pytest
import scipy.special as sps

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt

from test_torch_special_rewrites import fired  # noqa: F401 (the fixture)

RNG = np.random.default_rng(42)
N8 = RNG.standard_normal(8)
U8 = RNG.uniform(0.05, 0.95, 8)
G6 = RNG.uniform(0.5, 5.0, 6)

REWRITES = ("local_one_pm_erf", "local_log_erfc", "local_grad_log_erfc_neg",
            "local_grad_log_erfc_neg_mul", "local_reciprocal_1_plus_exp",
            "local_sigm_times_exp", "local_odds_sigmoid", "local_sigmoid_of_logit",
            "local_logit_of_sigmoid", "local_logdiffexp", "local_log_kv_iv",
            "local_polygamma_specialize")


def _ops(f):
    """Each node's op, a FusedElemwise with its inner scalar ops."""
    fg = f.maker.fgraph if hasattr(f, "maker") else f.fgraph
    out = []
    for n in fg.toposort():
        name = type(n.op).__name__
        if hasattr(n.op, "scalar_op"):
            name += "{" + n.op.scalar_op.name + "}"
        elif name == "FusedElemwise":
            name += str([m.op.scalar_op.name for m in n.op.fgraph.toposort()])
        out.append(name)
    return out


# name, graph of the inputs, input values, the JAX package's test's expectation
CASES = [
    ("1 + erf(x)", lambda p, t, x: 1 + t.erf(x), [N8], lambda v: 1 + sps.erf(v)),
    ("1 - erf(x)", lambda p, t, x: 1 - t.erf(x), [N8], lambda v: sps.erfc(v)),
    ("erf(x) - 1", lambda p, t, x: t.erf(x) - 1, [N8], lambda v: -sps.erfc(v)),
    ("1 + (-erf(x))", lambda p, t, x: 1 + (-t.erf(x)), [N8], lambda v: sps.erfc(v)),
    ("erf(x) + (-1)", lambda p, t, x: t.erf(x) + (-1.0), [N8], lambda v: -sps.erfc(v)),
    ("1 - erfc(x)", lambda p, t, x: 1 - t.erfc(x), [N8], lambda v: sps.erf(v)),
    ("erfc(x) - 1", lambda p, t, x: t.erfc(x) - 1, [N8], lambda v: -sps.erf(v)),
    ("log(erfc(x))", lambda p, t, x: t.log(t.erfc(x)),
     [np.array([-5.0, 0.0, 3.0, 26.0, 27.0, 50.0, 110.0])],
     lambda v: -v ** 2 + np.log(sps.erfcx(v))),
    ("grad log(erfc(x))", lambda p, t, x: p.grad(t.log(t.erfc(x)).sum(), x),
     [np.array([-3.0, 0.0, 10.0, 27.0, 100.0])],
     lambda v: -2 / np.sqrt(np.pi) / sps.erfcx(v)),
    ("1 / (1 + exp(x))", lambda p, t, x: 1 / (1 + t.exp(x)), [N8 * 3],
     lambda v: 1 / (1 + np.exp(v))),
    ("sigmoid(-x) * exp(x)", lambda p, t, x: t.sigmoid(-x) * t.exp(x), [N8],
     lambda v: 1 / (1 + np.exp(-v))),
    ("exp(x) / (1 + exp(x))", lambda p, t, x: t.exp(x) / (1 + t.exp(x)), [N8],
     lambda v: 1 / (1 + np.exp(-v))),
    ("sigmoid(x) / sigmoid(-x)", lambda p, t, x: t.sigmoid(x) / t.sigmoid(-x),
     [np.array([-2.0, 0.0, 2.0, 45.0])], np.exp),
    ("sigmoid(log(x / (1 - x)))", lambda p, t, x: t.sigmoid(t.log(x / (1 - x))), [U8],
     lambda v: v),
    ("logit(sigmoid(x))", lambda p, t, x: t.logit(t.sigmoid(x)), [N8], lambda v: v),
    ("log(exp(x) - exp(y))", lambda p, t, x, y: t.log(t.exp(x) - t.exp(y)),
     [np.array([800.0, 3.0]), np.array([799.0, 1.0])],
     lambda x, y: x + np.log1p(-np.exp(y - x))),
    ("log(kv(2.5, x))", lambda p, t, x: t.log(t.kv(2.5, x)), [np.array([3.0, 7.0, 800.0])],
     lambda v: np.log(sps.kve(2.5, v)) - v),
    ("log(iv(2.5, x))", lambda p, t, x: t.log(t.iv(2.5, x)), [np.array([3.0, 7.0, 800.0])],
     lambda v: np.log(sps.ive(2.5, v)) + v),
    ("polygamma(0, x)", lambda p, t, x: t.polygamma(0, x), [G6],
     lambda v: sps.polygamma(0, v)),
    ("polygamma(1, x)", lambda p, t, x: t.polygamma(1, x), [G6],
     lambda v: sps.polygamma(1, v)),
]
# the graphs that an earlier rewrite takes first, in both packages, so none
# of the twelve fires there
BY_OTHERS = {"1 / (1 + exp(x))": "local_exp_over_1_plus_exp",
             "exp(x) / (1 + exp(x))": "local_exp_over_1_plus_exp"}
# the port against the JAX package: 1e-12 but where the two compute a
# special function differently (trigamma: 5e-9, the float64 tolerance of
# tests/test_torch_special.py)
JAX_RTOL = {"polygamma(1, x)": 5e-9}
# the value the JAX package's test holds, and its tolerance where it is not 1e-12
EXPECT_RTOL = {"log(erfc(x))": 1e-7, "grad log(erfc(x))": 1e-6, "polygamma(0, x)": 1e-8,
               "polygamma(1, x)": 1e-8, "log(kv(2.5, x))": 1e-9, "log(iv(2.5, x))": 1e-9}


@pytest.mark.parametrize("expr,build,values,expect", CASES, ids=[c[0] for c in CASES])
def test_special_rewrite_op_for_op(fired, expr, build, values, expect):  # noqa: F811
    res = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        ins = [pt.dvector(f"x{k}") for k in range(len(values))]
        f = ptt.function(ins, build(ptt, pt, *ins), **kw)
        res.append((_ops(f), np.asarray(f(*values))))
    (jops, jout), (tops, tout) = res
    assert tops == jops
    counts = {r: (fired["jax"][r], fired["torch"][r]) for r in REWRITES}
    assert all(j == t for j, t in counts.values()), counts
    if expr in BY_OTHERS:
        assert fired["torch"][BY_OTHERS[expr]] == fired["jax"][BY_OTHERS[expr]] > 0
    else:
        assert sum(j for j, _ in counts.values()) > 0, counts
    np.testing.assert_allclose(tout, jout, rtol=JAX_RTOL.get(expr, 1e-12))
    assert np.isfinite(tout).all()
    with np.errstate(all="ignore"):
        want = expect(*values)
    np.testing.assert_allclose(tout, want, rtol=EXPECT_RTOL.get(expr, 1e-12))


def test_erfc_thresholds_are_the_jax_packages():
    from pytensor_tpu.tensor.rewriting import math as jrm

    from pytensor_tpu_torch.tensor.rewriting import math as trm

    for dtype in ("float16", "bfloat16", "float32", "float64"):
        assert trm._erfc_thresholds(dtype) == jrm._erfc_thresholds(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_log_erfc_switches_at_the_dtypes_threshold(dtype):
    """Past 9 (float32) or 26 (float64) the asymptotic branch: finite where
    erfc underflows, in both packages alike."""
    v = np.array([1.0, 8.9, 9.1, 25.9, 26.1, 40.0], dtype=dtype)
    out = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        x = pt.tensor("x", dtype=dtype, shape=(None,))
        out.append(np.asarray(ptt.function([x], pt.log(pt.erfc(x)), **kw)(v)))
    assert np.isfinite(out[1]).all()
    np.testing.assert_allclose(out[1], out[0], rtol=1e-12 if dtype == "float64" else 1e-6)

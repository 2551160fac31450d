"""The softmax-family rewrites and the value-changing math rewrites, op for op.

``tensor/rewriting/special.py`` (``local_logsoftmax``,
``local_exp_logsoftmax``, ``local_subtensor_of_softmax``) and the rewrites
of ``tensor/rewriting/math.py`` that change a value at NaN, inf or in the
tails (ROADMAP Queue 3 item 1): each graph is built in both packages and
compiled with the default ``FAST_RUN``; the rewritten graphs hold the
same ops in the same order, each rewrite fires as often in both (counted
by wrapping ``FromFunctionNodeRewriter.transform``), and the values are
the JAX package's, which Queue 3's tables give.  The one pinned
difference: an op the JAX package runs on the host (``gammaincinv``,
...) fuses into its ``FusedElemwise`` there, while the port's fusion pass
leaves it out, because K1 cannot emit it.
"""

import collections

import numpy as np
import pytest

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
from pytensor_tpu.graph.rewriting import basic as jbasic

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.graph.rewriting import basic as tbasic


@pytest.fixture
def fired():
    """Counts of the node rewrites that changed a graph, by package."""
    counts = {"jax": collections.Counter(), "torch": collections.Counter()}
    saved = []
    for key, mod in (("jax", jbasic), ("torch", tbasic)):
        orig = mod.FromFunctionNodeRewriter.transform

        def transform(self, fgraph, node, _orig=orig, _key=key):
            res = _orig(self, fgraph, node)
            if res:
                counts[_key][str(self)] += 1
            return res

        saved.append((mod, orig))
        mod.FromFunctionNodeRewriter.transform = transform
    yield counts
    for mod, orig in saved:
        mod.FromFunctionNodeRewriter.transform = orig


def _ops(f):
    fg = f.maker.fgraph if hasattr(f, "maker") else f.fgraph
    return [type(n.op).__name__ + ("{" + n.op.scalar_op.name + "}"
                                   if hasattr(n.op, "scalar_op") else "")
            for n in fg.toposort()]


def _both(build, values, dtype="float64"):
    """Each package's function of ``build(ptt, pt, *inputs)`` on ``values``:
    (ops, outputs) of the JAX package's, then of the port's."""
    res = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        ins = [pt.tensor(f"x{k}", dtype=dtype, shape=(None,) * np.ndim(v))
               for k, v in enumerate(values)]
        f = ptt.function(ins, build(ptt, pt, *ins), **kw)
        out = f(*[np.asarray(v, dtype=dtype) for v in values])
        res.append((_ops(f), [np.asarray(o) for o in (out if isinstance(out, list) else [out])]))
    return res


# expression, inputs, the reference's value (ROADMAP Queue 3 item 1), the
# rewrite that gives it
EDGE = [np.nan, 0.0, 2.0, np.inf]
CASES = [
    ("x == x", lambda p, t, x: t.eq(x, x), [EDGE], [True] * 4, "local_useless_eq_neq"),
    ("x != x", lambda p, t, x: t.neq(x, x), [EDGE], [False] * 4, "local_useless_eq_neq"),
    ("x <= x", lambda p, t, x: t.le(x, x), [EDGE], [True] * 4, "local_comparison_self"),
    ("x < x", lambda p, t, x: t.lt(x, x), [EDGE], [False] * 4, "local_comparison_self"),
    ("x % x", lambda p, t, x: x % x, [EDGE], [0.0] * 4, "local_mod_self"),
    ("0 / x", lambda p, t, x: 0 / x, [EDGE], [0.0] * 4, "local_zero_div"),
    ("log(1 + x)", lambda p, t, x: t.log(1 + x), [[1e-20]], [1e-20], "local_log1p"),
    ("log(1 - x)", lambda p, t, x: t.log(1 - x), [[1e-20]], [-1e-20], "local_log1p"),
    ("exp(x) - 1", lambda p, t, x: t.exp(x) - 1, [[1e-20]], [1e-20], "local_expm1"),
    ("log(sum(exp(x)))", lambda p, t, x: t.log(t.sum(t.exp(x))), [[800.0]], 800.0,
     "local_log_sum_exp"),
    ("exp(x) * exp(-x)", lambda p, t, x: t.exp(x) * t.exp(-x), [[800.0]], [1.0],
     "local_mul_exp_to_exp_add"),
    ("exp(x) / exp(y)", lambda p, t, x, y: t.exp(x) / t.exp(y), [[800.0, -800.0]] * 2,
     [1.0, 1.0], "local_mul_exp_to_exp_add"),
    ("log(1 + exp(x))", lambda p, t, x: t.log(1 + t.exp(x)), [[800.0]], [800.0],
     "local_log1p_exp_to_softplus"),
    ("grad log(1 + exp(x))", lambda p, t, x: p.grad(t.sum(t.log(1 + t.exp(x))), x),
     [[800.0]], [1.0], "local_exp_over_1_plus_exp"),
    ("log(sigmoid(x))", lambda p, t, x: t.log(t.sigmoid(x)), [[-800.0]], [-800.0],
     "local_log_sigmoid"),
    ("log(1 - sigmoid(x))", lambda p, t, x: t.log(1 - t.sigmoid(x)), [[800.0]], [-800.0],
     "local_log_sigmoid"),
    ("log1p(-sigmoid(x))", lambda p, t, x: t.log1p(-t.sigmoid(x)), [[800.0]], [-800.0],
     "local_log1msigm"),
    ("log1p(-exp(x))", lambda p, t, x: t.log1p(-t.exp(x)), [[-1e-20]], [np.log(1e-20)],
     "local_log1mexp"),
    ("log(1 - exp(x))", lambda p, t, x: t.log(1 - t.exp(x)), [[-1e-20]],
     [np.log(1e-20)], "local_log1mexp"),
]


@pytest.mark.parametrize("expr,build,values,want,rewrite", CASES, ids=[c[0] for c in CASES])
def test_value_changing_rewrites_match_the_reference(fired, expr, build, values, want,
                                                     rewrite):
    (jops, jout), (tops, tout) = _both(build, values)
    assert tops == jops
    assert fired["torch"][rewrite] == fired["jax"][rewrite] > 0
    np.testing.assert_allclose(tout[0], jout[0], rtol=1e-12)
    np.testing.assert_allclose(tout[0], np.asarray(want), rtol=1e-12)


X = np.array([[0.5, -1.0, 3.0], [800.0, 0.0, -800.0]])


@pytest.mark.parametrize("expr,build,rewrite", [
    ("log(softmax)", lambda p, t, x: t.log(t.special.softmax(x, axis=1)), "local_logsoftmax"),
    ("exp(log_softmax)", lambda p, t, x: t.exp(t.special.log_softmax(x, axis=1)),
     "local_exp_logsoftmax"),
    ("softmax[0]", lambda p, t, x: t.special.softmax(x, axis=1)[0],
     "local_subtensor_of_softmax"),
    ("log_softmax[1:]", lambda p, t, x: t.special.log_softmax(x, axis=1)[1:],
     "local_subtensor_of_softmax"),
])
def test_softmax_rewrites(fired, expr, build, rewrite):
    (jops, jout), (tops, tout) = _both(build, [X])
    assert tops == jops
    assert fired["torch"][rewrite] == fired["jax"][rewrite] == 1
    np.testing.assert_allclose(tout[0], jout[0], rtol=1e-12)


def test_softmax_family_values_and_gradients():
    """softmax, log_softmax and logsumexp, and the gradient through the
    composite (its inner graph inlined), on logits of +-800."""
    def build(p, t, x):
        s = t.special
        return [s.softmax(x, axis=1), s.log_softmax(x, axis=0), s.logsumexp(x, axis=1),
                p.grad(t.sum(s.softmax(x, axis=1)[:, 0] * 2.0), x)]

    (jops, jout), (tops, tout) = _both(build, [X])
    assert tops == jops and "Softmax" in tops
    for t_, j_ in zip(tout, jout):
        np.testing.assert_allclose(t_, j_, rtol=1e-12, atol=1e-300)


def test_host_ops_stay_out_of_the_fused_group():
    """The pinned difference: the JAX package fuses gammaincinv with its
    neighbours; the port's fusion pass leaves it out, as K1 cannot emit it,
    and the rest of the group fuses as in the JAX package."""
    def build(p, t, x):
        return t.exp(t.gammaincinv(x * 2.0, 0.3)) * 3.0

    (jops, jout), (tops, tout) = _both(build, [[0.5, 1.0, 2.0]])
    assert jops == ["FusedElemwise"]
    assert tops == ["Elemwise{mul}", "Elemwise{gammaincinv}", "FusedElemwise"]
    np.testing.assert_allclose(tout[0], jout[0], rtol=1e-12)


def test_special_ops_fuse_as_in_the_jax_package():
    """Every device-side special function joins a FusedElemwise as in the
    JAX package (K1 emits it)."""
    def build(p, t, x):
        return (t.erf(x) + t.gammaln(x + 1.0) * t.softplus(-x) + t.kve(1.0, x) * t.ive(0.5, x)
                + t.psi(x + 2.0) + t.gammainc(2.0, x + 0.1) + t.betainc(2.0, 3.0, x / 10.0)
                + t.log1mexp(-x - 0.1) + t.ndtr(x) + t.i0(x) + t.jv(1.5, x))

    (jops, jout), (tops, tout) = _both(build, [[0.5, 1.0, 2.0, 3.5]])
    assert tops == jops == ["FusedElemwise"]
    np.testing.assert_allclose(tout[0], jout[0], rtol=1e-9)

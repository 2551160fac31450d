"""The special functions (``scalar/math.py``) against the JAX package and scipy.

Each op is built in both packages on the same grid, made with numpy, in
float64 and float32, and run through ``function()``: the JAX package on
its XLA path on the CPU, as its own tests run these ops
(``tests/test_op_grids_special.py``), the port with its plain torch
versions (the ``torch.special`` call, or the JAX package's algorithm in
torch ops).  Tolerances, against float64 scipy:

- float64: ``rtol 5e-9, atol 1e-12``, the JAX package's own
  (``tests/test_op_grids_special.py``);
- float32: ``rtol 2e-5`` of ``max(1, |scipy|)``; where the JAX package's
  own float32 error at a point is larger, the port is held to twice that
  error there, and the failure message prints both.

At numpy's edges (NaN, +-inf, +-0, poles) the port gives scipy's value
or the JAX package's.  Gradients are held against the JAX package's
gradient graphs at ``rtol 1e-7``.
"""

import numpy as np
import pytest
import scipy.special as sps

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt

RTOL64, ATOL64, RTOL32 = 5e-9, 1e-12, 2e-5
EDGES = np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, -1.0, -2.0, 1.0])


def _grid(lo, hi, n=41):
    return np.linspace(lo, hi, n)


# name, scipy's function, one grid for each operand (broadcast together)
UNARY = [
    ("erf", sps.erf, (-3.0, 3.0)),
    ("erfc", sps.erfc, (-2.0, 6.0)),
    ("erfinv", sps.erfinv, (-0.95, 0.95)),
    ("erfcinv", sps.erfcinv, (0.05, 1.95)),
    ("erfcx", sps.erfcx, (-3.0, 10.0)),
    ("gamma", sps.gamma, (0.1, 6.0)),
    ("gammaln", sps.gammaln, (0.1, 10.0)),
    ("psi", sps.psi, (0.2, 8.0)),
    ("tri_gamma", lambda v: sps.polygamma(1, v), (0.2, 8.0)),
    ("softplus", lambda v: np.logaddexp(0, v), (-8.0, 8.0)),
    ("log1mexp", lambda v: np.log(-np.expm1(v)), (-6.0, -0.01)),
    ("logit", sps.logit, (0.02, 0.98)),
    ("i0", sps.i0, (-4.0, 4.0)),
    ("i1", sps.i1, (-4.0, 4.0)),
    ("j0", sps.j0, (0.1, 8.0)),
    ("j1", sps.j1, (0.1, 8.0)),
    ("ndtr", sps.ndtr, (-5.0, 5.0)),
    ("ndtri", sps.ndtri, (0.01, 0.99)),
    ("ndtri_exp", lambda v: sps.ndtri(np.exp(v)), (-10.0, -0.01)),
]
# a second grid of negative arguments, off the poles
NEGATIVE = {"gamma": (-3.7, -0.3), "psi": (-3.7, -0.3), "gammaln": (-3.7, -0.3)}

BINARY = [
    ("gammainc", sps.gammainc, (0.5, 5.0), (0.1, 8.0)),
    ("gammaincc", sps.gammaincc, (0.5, 5.0), (0.1, 8.0)),
    ("gammau", lambda a, x: sps.gammaincc(a, x) * sps.gamma(a), (0.5, 5.0), (0.1, 8.0)),
    ("gammal", lambda a, x: sps.gammainc(a, x) * sps.gamma(a), (0.5, 5.0), (0.1, 8.0)),
    ("betaln", sps.betaln, (0.5, 5.0), (0.5, 5.0)),
    ("xlogy", sps.xlogy, (0.0, 2.0), (0.1, 4.0)),
    ("xlog1py", sps.xlog1py, (0.0, 2.0), (-0.9, 4.0)),
    ("chi2sf", lambda x, k: sps.chdtrc(k, x), (0.1, 10.0), (1.0, 6.0)),
]
HOST = [
    ("gammaincinv", (0.5, 5.0), (0.05, 0.95)),
    ("gammainccinv", (0.5, 5.0), (0.05, 0.95)),
    ("owens_t", (-2.0, 2.0), (0.1, 3.0)),
]


def _op(pt, name):
    return getattr(pt.special, name) if name in ("xlogy", "xlog1py") else getattr(pt, name)


def _run(name, args, dtype):
    """The op on ``args`` (numpy, cast to ``dtype``) in both packages:
    (jax, torch) numpy results."""
    out = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        ins = [pt.tensor(f"a{k}", dtype=dtype, shape=(None,)) for k in range(len(args))]
        f = ptt.function(ins, _op(pt, name)(*ins), **kw)
        out.append(np.asarray(f(*[np.asarray(a, dtype=dtype) for a in args])))
    return out


def _hold(name, dtype, got, jax, want):
    """The stated tolerances against scipy's float64 ``want``."""
    assert got.dtype == np.dtype(dtype) == jax.dtype, (name, got.dtype, jax.dtype)
    g, j = got.astype("float64"), jax.astype("float64")
    if dtype == "float64":
        np.testing.assert_allclose(g, want, rtol=RTOL64, atol=ATOL64, err_msg=name)
        return
    err = np.abs(g - want)
    # where the JAX package gives NaN, its error raises no bound
    bound = np.maximum(RTOL32 * np.maximum(1.0, np.abs(want)),
                       np.nan_to_num(2 * np.abs(j - want), nan=0.0))
    bad = ~(err <= bound)
    assert not bad.any(), (name, "port", g[bad][:4], "jax", j[bad][:4], "scipy", want[bad][:4])


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name,fn,dom", UNARY, ids=[u[0] for u in UNARY])
def test_unary_against_jax_and_scipy(name, fn, dom, dtype):
    x = _grid(*dom)
    if name in NEGATIVE:
        x = np.concatenate([x, _grid(*NEGATIVE[name], n=8)])
    x = x.astype(dtype)
    jax, got = _run(name, [x], dtype)
    _hold(name, dtype, got, jax, fn(x.astype("float64")))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name,fn,da,dx", BINARY, ids=[b[0] for b in BINARY])
def test_binary_against_jax_and_scipy(name, fn, da, dx, dtype):
    A, X = np.meshgrid(_grid(*da, n=9), _grid(*dx, n=11), indexing="ij")
    a, x = A.ravel().astype(dtype), X.ravel().astype(dtype)
    jax, got = _run(name, [a, x], dtype)
    _hold(name, dtype, got, jax, fn(a.astype("float64"), x.astype("float64")))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("n", [0, 1, 2, 3])
def test_polygamma_against_jax_and_scipy(n, dtype):
    x = _grid(0.2, 8.0).astype(dtype)
    out = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        v = pt.tensor("v", dtype=dtype, shape=(None,))
        out.append(np.asarray(ptt.function([v], pt.polygamma(n, v), **kw)(x)))
    _hold(f"polygamma({n})", dtype, out[1], out[0], sps.polygamma(n, x.astype("float64")))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_betainc_against_jax_and_scipy(dtype):
    A, B, X = np.meshgrid(_grid(0.5, 5.0, 6), _grid(0.5, 5.0, 5), _grid(0.0, 1.0, 11),
                          indexing="ij")
    a, b, x = (v.ravel().astype(dtype) for v in (A, B, X))
    jax, got = _run("betainc", [a, b, x], dtype)
    _hold("betainc", dtype, got, jax, sps.betainc(*(v.astype("float64") for v in (a, b, x))))


@pytest.mark.parametrize("name,da,dx", HOST, ids=[h[0] for h in HOST])
def test_host_ops_run_scipy_and_declare_the_read(name, da, dx):
    """The ops the JAX package runs through ``jax.pure_callback`` run scipy
    on the host in the port; their lowering declares ``reads_back``, so a
    plan that holds one is never captured."""
    from pytensor_tpu_torch.link.torch.dispatch import ports_of

    A, X = np.meshgrid(_grid(*da, n=5), _grid(*dx, n=7), indexing="ij")
    a, x = A.ravel(), X.ravel()
    jax, got = _run(name, [a, x], "float64")
    want = getattr(sps, name)(a, x)
    np.testing.assert_allclose(got, want, rtol=1e-12)
    np.testing.assert_allclose(jax, want, rtol=1e-12)
    v = tpt.dvector("v")
    node = _op(tpt, name)(v, v).owner
    assert "host" in ports_of(node, "reads_back")
    f = tptt.function([v], _op(tpt, name)(v, v), device="cpu")
    assert f.linked.host_reads and "scipy" in f.linked.host_reads[0]


def test_betaincinv_and_hyp2f1_on_the_host():
    a, b = np.array([0.5, 2.0, 3.0]), np.array([1.5, 2.5, 0.7])
    x = np.array([0.1, 0.5, 0.9])
    jax, got = _run("betaincinv", [a, b, x], "float64")
    np.testing.assert_allclose(got, sps.betaincinv(a, b, x), rtol=1e-12)
    np.testing.assert_allclose(got, jax, rtol=1e-12)
    z = np.array([-0.5, 0.2, 0.6])
    jax, got = _run("hyp2f1", [a, b, x + 1.0, z], "float64")
    np.testing.assert_allclose(got, sps.hyp2f1(a, b, x + 1.0, z), rtol=1e-12)
    np.testing.assert_allclose(got, jax, rtol=1e-12)


EDGE_OPS = ["erf", "erfc", "erfinv", "erfcinv", "erfcx", "gamma", "gammaln", "psi",
            "tri_gamma", "softplus", "log1mexp", "logit", "i0", "i1", "j0", "j1", "ndtr",
            "ndtri", "ndtri_exp"]


@pytest.mark.parametrize("name", EDGE_OPS)
def test_edges_give_scipys_or_the_jax_packages_value(name):
    fn = dict((u[0], u[1]) for u in UNARY)[name]
    with np.errstate(all="ignore"):
        want = fn(EDGES)
    jax, got = _run(name, [EDGES], "float64")

    def same(a, b):
        return (np.isnan(a) & np.isnan(b)) | (a == b) | np.isclose(a, b, rtol=RTOL64, atol=0)

    bad = ~(same(got, want) | same(got, jax))
    assert not bad.any(), (name, EDGES[bad], got[bad], want[bad], jax[bad])


def test_binary_edges():
    """The regularized gamma and beta functions at scipy's edges."""
    k = np.array([0.0, 0.0, 1.0, 1.0, -1.0, 1.0, np.inf, np.nan])
    x = np.array([0.0, 1.0, 0.0, np.inf, 1.0, -1.0, 1.0, 1.0])
    for name in ("gammainc", "gammaincc"):
        _, got = _run(name, [k, x], "float64")
        np.testing.assert_array_equal(got, getattr(sps, name)(k, x))
    a = np.array([1.0, 1.0, 0.0, 1.0, -1.0, 1.0, 2.0])
    b = np.array([1.0, 1.0, 1.0, 0.0, 1.0, 1.0, 3.0])
    x = np.array([0.0, 1.0, 0.5, 0.5, 0.5, 1.5, np.nan])
    _, got = _run("betainc", [a, b, x], "float64")
    np.testing.assert_array_equal(got, sps.betainc(a, b, x))


GRADS = [
    ("erf", (-2.0, 2.0)), ("erfc", (-2.0, 2.0)), ("erfinv", (-0.9, 0.9)),
    ("erfcinv", (0.1, 1.9)), ("erfcx", (-1.0, 4.0)), ("gamma", (0.3, 5.0)),
    ("gammaln", (0.3, 8.0)), ("psi", (0.3, 6.0)), ("tri_gamma", (0.3, 6.0)),
    ("softplus", (-6.0, 6.0)), ("log1mexp", (-5.0, -0.1)), ("logit", (0.05, 0.95)),
    ("i0", (-3.0, 3.0)), ("i1", (-3.0, 3.0)), ("ndtr", (-3.0, 3.0)), ("ndtri", (0.05, 0.95)),
    ("ndtri_exp", (-6.0, -0.1)),
]


@pytest.mark.parametrize("name,dom", GRADS, ids=[g[0] for g in GRADS])
def test_gradient_against_the_jax_package(name, dom):
    x = _grid(*dom, n=13)
    out = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        v = pt.dvector("v")
        g = ptt.grad(pt.sum(_op(pt, name)(v)), v)
        out.append(np.asarray(ptt.function([v], g, **kw)(x)))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-7, atol=1e-12)


BINARY_GRADS = [("gammainc", 1), ("gammaincc", 1), ("betaln", 0), ("betaln", 1), ("xlogy", 0),
                ("xlogy", 1), ("xlog1py", 0), ("xlog1py", 1), ("chi2sf", 0),
                ("polygamma", 1)]


@pytest.mark.parametrize("name,wrt", BINARY_GRADS)
def test_binary_gradient_against_the_jax_package(name, wrt):
    a = np.array([0.7, 1.5, 2.0, 3.5]) if name != "polygamma" else np.array([0, 1, 2, 1])
    x = np.array([0.4, 1.1, 2.5, 4.0])
    out = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        av = pt.lvector("a") if name == "polygamma" else pt.dvector("a")
        xv = pt.dvector("x")
        g = ptt.grad(pt.sum(_op(pt, name)(av, xv)), [av, xv][wrt])
        out.append(np.asarray(ptt.function([av, xv], g, **kw)(a, x)))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-7, atol=1e-12)


def test_betainc_x_gradient_and_deferred_parameter_gradients():
    """The gradient with respect to x is the JAX package's; so are those
    with respect to the shape parameters, which waited for ROADMAP item
    10b (they raised NullTypeGradError) and now build."""
    a, b, x = np.array([0.7, 2.0]), np.array([1.5, 3.0]), np.array([0.3, 0.6])
    for wrt in (2, 0, 1):
        out = []
        for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
            av, bv, xv = pt.dvector("a"), pt.dvector("b"), pt.dvector("x")
            g = ptt.grad(pt.sum(pt.betainc(av, bv, xv)), [av, bv, xv][wrt])
            out.append(np.asarray(ptt.function([av, bv, xv], g, **kw)(a, b, x)))
        np.testing.assert_allclose(out[1], out[0], rtol=1e-7)


# the seven shape-parameter gradient ops, and the gradient of gammaincc in k
SHAPE_GRADS = [("betainc_dda", 3), ("betainc_ddb", 3), ("gammainc_ddk", 2),
               ("gammaincc_ddk", 2), ("hyp2f1_dda", 4), ("hyp2f1_ddb", 4), ("hyp2f1_ddc", 4),
               ("grad_gammaincc", 2)]


@pytest.mark.parametrize("name,nin", SHAPE_GRADS)
def test_shape_parameter_gradient_values(name, nin):
    """Each of the seven ops (they raised NotImplementedError until item
    10b) against the JAX package's XLA path and float64 scipy's central
    differences, the ops' oracle (rtol 1e-6: the differences' own error)."""
    vals = [np.array([0.8, 1.5, 3.0]), np.array([1.2, 2.5, 0.9]),
            np.array([2.3, 1.7, 3.1]), np.array([0.3, 0.6, 0.8])][-nin:]
    if nin == 4:
        vals[0], vals[1] = np.array([0.8, 1.5, 3.0]), np.array([1.2, 2.5, 0.9])
    out = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        vs = [pt.dvector(f"a{k}") for k in range(nin)]
        if name == "grad_gammaincc":
            y = ptt.grad(pt.sum(pt.gammaincc(*vs)), vs[0])
        else:
            y = getattr(pt, name)(*vs)
        out.append(np.asarray(ptt.function(vs, y, **kw)(*vals)))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-10, atol=1e-14)
    oracle = ("gammaincc_ddk" if name == "grad_gammaincc" else name)
    from pytensor_tpu_torch.scalar import math as tpsm

    np.testing.assert_allclose(out[1], getattr(tpsm, oracle).np_fn(*vals), rtol=1e-6)


def test_special_composites_of_tensor_special():
    """poch, factorial, beta, log_beta and logaddexp against the JAX package."""
    x = np.array([0.5, 1.5, 3.0, 4.2])
    y = np.array([1.0, 2.5, 0.3, 2.0])
    builds = [lambda s, a, b: s.poch(a, b), lambda s, a, b: s.factorial(a) + b,
              lambda s, a, b: s.beta(a, b), lambda s, a, b: s.log_beta(a, b),
              lambda s, a, b: s.logaddexp(a, b), lambda s, a, b: s.logsumexp(a) + b]
    for build in builds:
        out = []
        for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
            a, b = pt.dvector("a"), pt.dvector("b")
            out.append(np.asarray(ptt.function([a, b], build(pt.special, a, b), **kw)(x, y)))
        np.testing.assert_allclose(out[1], out[0], rtol=1e-12)

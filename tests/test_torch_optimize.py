"""``tensor/optimize.py`` in the port against the JAX package, on the CPU.

Each of ``MinimizeOp``, ``MinimizeScalarOp``, ``RootOp`` and
``RootScalarOp`` runs in both packages two ways: the lowering (the port's
``function(..., device="cpu")``, its BFGS and Newton loops of
``link/torch/optimize.py``, against the JAX package's XLA path) and the
oracle (the port's ``perform``, scipy on the port's inner graph, against
the JAX package's ``mode="FAST_COMPILE"``).  Inputs come from numpy seeds.
Tolerances, each stated where it is used: the loops copy jax's algorithm,
so float64 fits agree to ``1e-8``; a float32 fit that stops at the limit
of its precision takes another path at the last steps (torch's and XLA's
sums round differently), so its ``x*`` is held to ``2e-3``.

The cases: ``tests/test_more.py:44-112``; the logistic-regression MAP of
``models/logreg.py`` at n 512, d 16 (``x*`` and the IFT gradients
``d sum(w*) / d lam`` and ``d sum(w*) / d X``, ``success`` equal in
float64); ``MinimizeScalarOp``'s lowering being BFGS; ``RootOp``'s 25
steps and its ``1e-8`` test in float32; ``optimizer_kwargs`` ignored when
linked; the radon MAP from 0 (pinned: BFGS fails in both packages);
``Plan.host_reads`` naming ``MinimizeOp`` and ``RootOp``'s plan
capturable.
"""

import warnings

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
import pytensor_tpu.models.logreg as jlogreg
import pytensor_tpu.models.radon as jradon
import pytensor_tpu.tensor.optimize as jopt

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
import pytensor_tpu_torch.models.logreg as tlogreg
import pytensor_tpu_torch.models.radon as tradon
import pytensor_tpu_torch.tensor.optimize as topt

PKGS = {"jax": (jptt, jpt, jopt), "torch": (tptt, tpt, topt)}


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _function(name, inputs, outputs, oracle=False):
    ptt = PKGS[name][0]
    if name == "jax":
        return ptt.function(inputs, outputs, mode="FAST_COMPILE" if oracle else None)
    return ptt.function(inputs, outputs, device="cpu")


def _values(f, *args):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        return [_np(v) for v in f(*args)]


def _perform(node, values):
    """The port's oracle: the op's ``perform`` on numpy values."""
    storage = [[None] for _ in node.outputs]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        node.op.perform(node, [np.asarray(v) for v in values], storage)
    return [s[0] for s in storage]


def _linked_steps(f):
    return [fn for fn, _, _, _ in f.linked.steps]


# --- tests/test_more.py:44-112 ---------------------------------------------------------

def _scalar_case(case):
    """(build, x0, a, x*, d x*/d a) of each scalar case of test_more.py."""
    if case == "minimize":
        return (lambda pt, opt, x, a: opt.minimize((x - a) ** 2, x), 0.0, 3.0, 3.0, 1.0)
    if case == "minimize_scalar":
        return (lambda pt, opt, x, a: opt.minimize_scalar((x - a) ** 2 + 1.0, x),
                0.0, 3.0, 3.0, 1.0)
    if case == "root_scalar":
        return (lambda pt, opt, x, a: opt.root_scalar(x ** 3 - a, x), 1.5, 8.0, 2.0, 1 / 12)
    return (lambda pt, opt, x, a: opt.root(x ** 2 - a, x), 1.0, 4.0, 2.0, 0.25)


@pytest.mark.parametrize("case", ["minimize", "minimize_scalar", "root_scalar", "root"])
def test_scalar_cases_of_test_more(case):
    """Each scalar case of ``tests/test_more.py``: ``x*`` and the IFT
    gradient in the port's lowering and oracle against the JAX package's
    XLA path and oracle, and against the closed form (``1e-5``: BFGS stops
    at |g| < 1e-5; the Newton cases ``1e-8``)."""
    build, x0, a0, want, dwant = _scalar_case(case)
    tol = 1e-5 if case.startswith("minimize") else 1e-8
    got = {}
    for name, (ptt, pt, opt) in PKGS.items():
        x, a = pt.dscalar("x"), pt.dscalar("a")
        (xs, ok), op = build(pt, opt, x, a)
        g = ptt.grad(xs, a)
        got[name, "lowered"] = _values(_function(name, [x, a], [xs, ok, g]), x0, a0)
        if name == "jax":
            got[name, "oracle"] = _values(_function(name, [x, a], [xs, ok, g], oracle=True),
                                          x0, a0)
        else:
            got[name, "oracle"] = _perform(xs.owner, [x0, a0])
    for key, vals in got.items():
        np.testing.assert_allclose(float(vals[0]), want, rtol=tol, atol=tol, err_msg=str(key))
        assert bool(vals[1]), key
        if len(vals) > 2:
            np.testing.assert_allclose(float(vals[2]), dwant, rtol=1e-5, err_msg=str(key))
    np.testing.assert_allclose(float(got["torch", "lowered"][0]),
                               float(got["jax", "lowered"][0]), rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(float(got["torch", "oracle"][0]),
                               float(got["jax", "oracle"][0]), rtol=1e-10, atol=1e-12)


def test_minimize_scalar_rejects_vector():
    for name, (ptt, pt, opt) in PKGS.items():
        v = pt.dvector("v")
        with pytest.raises(ValueError, match="scalar"):
            opt.minimize_scalar((v ** 2).sum(), v)
        with pytest.raises(ValueError, match="scalar"):
            opt.root_scalar((v ** 2).sum(), v)


def test_ops_keep_the_jax_package_interface():
    """Inputs ``(x0, *args)``, outputs ``(x*, success)``, the parameters
    every non-constant root input but ``x``, an identity ``__eq__``."""
    for name, (ptt, pt, opt) in PKGS.items():
        x, a, b = pt.dvector("x"), pt.dscalar("a"), pt.dvector("b")
        (xs, ok), op = opt.minimize(((x - a) ** 2 * b).sum() + 2.0, x)
        assert xs.owner.inputs == [x, a, b] or xs.owner.inputs == [x, b, a]
        assert ok.type.dtype == "bool" and ok.type.ndim == 0
        assert xs.type == x.type
        (xs2, _), op2 = opt.minimize(((x - a) ** 2 * b).sum() + 2.0, x)
        assert op != op2 and op == op and hash(op) != hash(op2)
        assert str(op) == "MinimizeOp{BFGS}"


# --- the logistic-regression MAP ------------------------------------------------------

N_OBS, D = 512, 16
LAM = 1e-3


def _logreg_map(name, dtype):
    """The MAP of ``make_logreg_graphs``' cross-entropy plus ``0.5 lam |w|^2``
    over ``w``, from ``w = 0``: ``x*``, success, the IFT gradients of
    ``sum(w*)`` by ``lam`` and by ``X``, Newton's root of the gradient and
    its success; and the function's linked plan."""
    ptt, pt, opt = PKGS[name]
    mod = jlogreg if name == "jax" else tlogreg
    (X, y, w, b), _, (Xv, yv, wv, bv) = mod.make_logreg_graphs(N_OBS, D, dtype)
    lam = pt.tensor("lam", dtype=dtype, shape=())
    obj = mod._xent(X, y, w, b, dtype) if name == "torch" else _jax_xent(X, y, w, b, dtype)
    obj = obj + 0.5 * lam * pt.sum(w ** 2)
    (ws, ok), _ = opt.minimize(obj, w)
    glam, gX = ptt.grad(pt.sum(ws), [lam, X])
    (wr, okr), _ = opt.root(ptt.grad(obj, w), w)
    f = _function(name, [w, X, y, b, lam], [ws, ok, glam, gX, wr, okr])
    return _values(f, wv, Xv, yv, bv, np.asarray(LAM, dtype)), f, (Xv, yv, bv)


def _jax_xent(X, y, w, b, dtype):
    p = jpt.sigmoid(jpt.dot(X, w) + b)
    eps = np.asarray(1e-7, dtype)
    return -jpt.mean(y * jpt.log(p + eps) + (1 - y) * jpt.log(1 - p + eps))


def _logreg_reference(Xv, yv, w):
    """The closed form of the IFT gradient: ``d sum(w*)/d lam = -1^T H^-1
    w*``, with ``H = X^T diag(p(1-p)) X / n + lam I``, in float64."""
    X = Xv.astype(np.float64)
    p = 1 / (1 + np.exp(-(X @ w)))
    H = X.T @ (X * (p * (1 - p))[:, None]) / len(X) + LAM * np.eye(X.shape[1])
    return -np.ones(len(w)) @ np.linalg.solve(H, w)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_logreg_map_and_its_ift_gradients(dtype):
    """The port's BFGS and Newton fits and the IFT gradients against the JAX
    package's XLA path.  float64: ``x*`` and both gradients to ``1e-8``
    (the same algorithm in the same precision), ``success`` True in both,
    and ``d sum(w*)/d lam`` within ``1e-5`` of the closed form (BFGS stops
    at |g|_inf < 1e-5, Newton's root is exact).  float32: ``x*`` to
    ``2e-3`` and the gradients to ``1e-2`` of their size (the line search
    meets the precision limit; torch's and XLA's sums round differently),
    Newton's ``x*`` to ``1e-5``, ``success`` as each package reports it."""
    jv, _, _ = _logreg_map("jax", dtype)
    tv, f, (Xv, yv, bv) = _logreg_map("torch", dtype)
    tol = 1e-8 if dtype == "float64" else 2e-3
    np.testing.assert_allclose(tv[0], jv[0], atol=tol)
    np.testing.assert_allclose(tv[4], jv[4], atol=1e-8 if dtype == "float64" else 1e-5)
    gtol = 1e-8 if dtype == "float64" else 1e-2
    np.testing.assert_allclose(tv[2], jv[2], rtol=gtol, atol=gtol * 1e-3)
    np.testing.assert_allclose(tv[3], jv[3], atol=gtol * np.abs(jv[3]).max())
    assert bool(tv[5]) and bool(jv[5])  # Newton's residual below 1e-8 in both
    if dtype == "float64":
        assert bool(tv[1]) and bool(jv[1])
        # the closed form at BFGS's own x* (to 1e-5: the graph's logs carry
        # an eps of 1e-7 that the closed form leaves out); at Newton's
        # exact root it differs by the 2.7e-4 that BFGS stops short of it
        np.testing.assert_allclose(float(tv[2]), _logreg_reference(Xv, yv, tv[0]), rtol=1e-5)
        np.testing.assert_allclose(float(tv[2]), _logreg_reference(Xv, yv, tv[4]), rtol=2e-3)
    (bfgs,) = [fn.bfgs for fn in _linked_steps(f) if hasattr(fn, "bfgs")][:1]
    last = bfgs.last
    assert last["iterations"] >= 1 and last["evaluations"] >= last["iterations"] + 1
    assert last["status"] == (0 if bool(tv[1]) else last["status"])
    # each evaluation one read of its four numbers, each iteration one more
    assert last["reads"] == last["evaluations"] + last["iterations"]


def test_logreg_map_oracle_float64():
    """The oracles (scipy's BFGS on each package's inner graph, with its
    finite differences) agree to ``1e-6``, and with the lowering to
    ``1e-4`` (two stopping rules)."""
    got = {}
    for name in PKGS:
        ptt, pt, opt = PKGS[name]
        mod = jlogreg if name == "jax" else tlogreg
        (X, y, w, b), _, (Xv, yv, wv, bv) = mod.make_logreg_graphs(N_OBS, D, "float64")
        lam = pt.tensor("lam", dtype="float64", shape=())
        xent = mod._xent(X, y, w, b, "float64") if name == "torch" else _jax_xent(
            X, y, w, b, "float64")
        (ws, ok), _ = opt.minimize(xent + 0.5 * lam * pt.sum(w ** 2), w)
        args = [wv, Xv, yv, bv, np.asarray(LAM)]
        if name == "jax":
            got[name] = _values(_function(name, [w, X, y, b, lam], [ws, ok], oracle=True), *args)
        else:
            order = [w, *ws.owner.inputs[1:]]
            by_var = dict(zip([w, X, y, b, lam], args))
            got[name] = _perform(ws.owner, [by_var[v] for v in order])
            lowered = _values(_function(name, [w, X, y, b, lam], [ws]), *args)[0]
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], atol=1e-6)
    assert bool(got["torch"][1]) == bool(got["jax"][1])
    np.testing.assert_allclose(got["torch"][0], lowered, atol=1e-4)


# --- the lowerings' own rules ------------------------------------------------------------

def test_minimize_scalar_lowers_to_bfgs():
    """``MinimizeScalarOp``'s lowering is BFGS on the one-element ``x``
    (the JAX package's too: its ``is_root`` is false), not brent: the
    lowered ``x*`` equals the JAX package's XLA path's to ``1e-12`` and the
    plan's step holds the BFGS loop; the oracle runs brent."""
    got = {}
    for name, (ptt, pt, opt) in PKGS.items():
        x, a = pt.dscalar("x"), pt.dscalar("a")
        (xs, ok), op = opt.minimize_scalar(pt.cosh(x - a) + 0.1 * x ** 4, x)
        assert isinstance(op, opt.MinimizeScalarOp) and op.method == "brent"
        f = _function(name, [x, a], [xs, ok])
        got[name] = _values(f, 0.3, 0.7)
        if name == "torch":
            bfgs = [fn.bfgs for fn in _linked_steps(f) if hasattr(fn, "bfgs")]
            assert len(bfgs) == 1 and bfgs[0].last["iterations"] >= 2
            brent = _perform(xs.owner, [0.3, 0.7])
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=1e-12, atol=1e-12)
    assert bool(got["torch"][1]) and bool(got["jax"][1])
    np.testing.assert_allclose(float(brent[0]), float(got["torch"][0]), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_root_runs_25_newton_steps_and_tests_1e8(dtype):
    """``RootOp``'s lowering: 25 Newton steps from ``x0`` and ``success =
    all(|f(x*)| < 1e-8)``.  For ``x**2 - 2`` the float32 residual at the
    root is about 2e-7, above 1e-8, so ``success`` is False in float32 in
    both packages and True in float64; from ``x0 = 1e9`` the 25 steps, each
    about halving x, stop short of the root in both dtypes and ``x*`` equals
    the JAX package's."""
    got = {}
    for name, (ptt, pt, opt) in PKGS.items():
        x = pt.tensor("x", dtype=dtype, shape=(2,))
        a = pt.tensor("a", dtype=dtype, shape=(2,))
        (xs, ok), _ = opt.root(x ** 2 - a, x)
        f = _function(name, [x, a], [xs, ok])
        got[name] = [_values(f, np.asarray(x0, dtype), np.asarray([2.0, 9.0], dtype))
                     for x0 in ([1.0, 1.0], [1e9, 1e9])]
    for k in range(2):
        np.testing.assert_allclose(got["torch"][k][0], got["jax"][k][0],
                                   rtol=1e-6 if dtype == "float32" else 1e-14)
        assert bool(got["torch"][k][1]) == bool(got["jax"][k][1])
    assert bool(got["torch"][0][1]) == (dtype == "float64")
    assert not bool(got["torch"][1][1])
    np.testing.assert_allclose(got["torch"][0][0], [np.sqrt(2), 3.0], rtol=1e-6)


def test_optimizer_kwargs_are_ignored_when_linked():
    """``optimizer_kwargs={"options": {"maxiter": 1}}``: the lowering runs
    jax's defaults in both packages (the minimum), the oracle passes the
    option to scipy (one iteration, short of it)."""
    got = {}
    for name, (ptt, pt, opt) in PKGS.items():
        x, a = pt.dvector("x"), pt.dvector("a")
        (xs, ok), _ = opt.minimize(((x - a) ** 4).sum() + ((x - 2 * a) ** 2).sum(), x,
                                   optimizer_kwargs={"options": {"maxiter": 1}})
        got[name] = _values(_function(name, [x, a], [xs, ok]), np.zeros(3), np.ones(3))
        if name == "torch":
            oracle = _perform(xs.owner, [np.zeros(3), np.ones(3)])
    np.testing.assert_allclose(got["torch"][0], got["jax"][0], rtol=1e-10)
    assert bool(got["torch"][1]) and bool(got["jax"][1])
    assert not bool(oracle[1]) and np.abs(oracle[0] - got["torch"][0]).max() > 1e-3


def test_radon_map_fails_in_both_packages():
    """A reference behaviour, not a fault: the MAP of the radon model from 0
    (``-logp + 0.5 lam |theta|^2``, ``lam = 1e-3``, float64) does not
    converge in the JAX package: jax's BFGS stops when its line search's
    zoom fails, far from a stationary point (|g|_inf 17-81), and the port's
    BFGS, the same algorithm, stops so too.  ``success`` is False in both
    and ``x*`` is not compared (the last steps depend on rounding)."""
    ok = {}
    for name, (ptt, pt, opt) in PKGS.items():
        mod = jradon if name == "jax" else tradon
        (theta,), (logp, _), n_params = mod.make_radon_graphs(dtype="float64")
        lam = pt.dscalar("lam")
        (ts, success), _ = opt.minimize(-logp + 0.5 * lam * pt.sum(theta ** 2), theta)
        f = _function(name, [theta, lam], [ts, success])
        ok[name] = bool(_values(f, np.zeros(n_params), np.asarray(LAM))[1])
        if name == "torch":
            (bfgs,) = [fn.bfgs for fn in _linked_steps(f) if hasattr(fn, "bfgs")]
            assert bfgs.last["status"] >= 2 and bfgs.last["gmax"] > 1.0
    assert ok == {"jax": False, "torch": False}


def test_host_reads_name_minimize_and_root_is_capturable():
    """A plan holding ``MinimizeOp`` reads the device back (its BFGS loop
    ends on read values: ``Plan.host_reads`` names it), so it runs
    eagerly on a card; ``RootOp``'s 25 steps read nothing back, so a plan
    of it and its IFT gradient may be captured."""
    x, a = tpt.dvector("x"), tpt.dvector("a")
    (xs, _), _ = topt.minimize(((x - a) ** 2).sum(), x)
    f = tptt.function([x, a], xs, device="cpu")
    assert len(f.linked.host_reads) == 1 and "MinimizeOp" in f.linked.host_reads[0]
    (xr, okr), _ = topt.root(x ** 3 - a, x)
    g = tptt.function([x, a], [xr, okr, tptt.grad(xr.sum(), a)], device="cpu")
    assert g.linked.host_reads == []
    vals = _values(g, np.ones(3), np.asarray([8.0, 27.0, 1.0]))
    np.testing.assert_allclose(vals[0], [2.0, 3.0, 1.0], rtol=1e-12)
    np.testing.assert_allclose(vals[2], 1 / (3 * np.asarray([2.0, 3.0, 1.0]) ** 2), rtol=1e-10)

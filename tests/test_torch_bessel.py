"""The Bessel functions and the bessel loop against the JAX package.

``iv``, ``ive``, ``jv``, ``yv``, ``kv`` and ``kve`` on
``tests/test_bessel_native.py``'s grid (``V_GRID`` x ``X_GRID``, kept in
``link/cuda/cases.py`` as ``BESSEL_V`` x ``BESSEL_X``), in
float64 and float32, in both packages (the JAX package on its XLA path on
the CPU, as its own tests run them; the port with its plain version,
``scalar/bessel.py``), against scipy: float64 within ``1e-9`` absolute
or ``5e-8`` relative (the JAX package's own bound); float32 within
``2e-5`` of ``max(1, |scipy|)``, or twice the JAX package's float32 error
where that is larger.  Then the bessel loop of ``benchsuite.py:1067
ours_bessel`` at 3 steps on a 64-vector, ``y = 0.999 v + 0.001 kve(1, v)
ive(0.5, v)`` as a ``train_loop``, built in both packages: its ops, its
values against a float64 scipy loop, and ``host_reads == []``; and the
function of ``y`` and of ``grad(sum(y), v)`` op for op.
"""

import numpy as np
import pytest
import scipy.special as sps

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.link.cuda import cases
from pytensor_tpu_torch.models.bessel import (
    bessel_grad_reference,
    bessel_reference,
    make_bessel_functions,
    make_bessel_loop,
    v_start,
)

NAMES = ["iv", "ive", "kv", "kve", "jv", "yv"]


def _grid(name):
    V, X = np.meshgrid(cases.BESSEL_V, cases.BESSEL_X, indexing="ij")
    vv, xx = V.ravel(), X.ravel()
    keep = np.ones_like(xx, dtype=bool)
    if name in ("iv", "kv"):
        keep = xx < 500  # the unscaled function over- or underflows; the scaled one covers it
    return vv[keep], xx[keep]


def _both(name, v, x, dtype):
    out = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        a = pt.tensor("v", dtype=dtype, shape=(None,))
        b = pt.tensor("x", dtype=dtype, shape=(None,))
        f = ptt.function([a, b], getattr(pt, name)(a, b), **kw)
        out.append(np.asarray(f(v.astype(dtype), x.astype(dtype))).astype("float64"))
    return out


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("name", NAMES)
def test_bessel_grid_against_jax_and_scipy(name, dtype):
    v, x = _grid(name)
    if dtype == "float32":
        # float32's own range: the unscaled functions overflow beyond it
        v, x = v.astype("float32").astype("float64"), x.astype("float32").astype("float64")
    jax, got = _both(name, v, x, dtype)
    want = getattr(sps, name)(v, x)
    if dtype == "float64":
        err = np.abs(got - want) / np.maximum(np.abs(want), 1e-280)
        ok = (np.abs(got - want) < 1e-9) | (err < 5e-8) | (np.isnan(got) & np.isnan(want))
        assert ok.all(), (name, v[~ok][:4], x[~ok][:4], got[~ok][:4], want[~ok][:4])
        return
    fin = np.isfinite(want) & (np.abs(want) < np.finfo(np.float32).max)
    err = np.abs(got - want)
    bound = np.maximum(2e-5 * np.maximum(1.0, np.abs(want)),
                       np.nan_to_num(2 * np.abs(jax - want), nan=0.0))
    bad = fin & ~(err <= bound)
    assert not bad.any(), (name, v[bad][:4], x[bad][:4], "port", got[bad][:4],
                           "jax", jax[bad][:4], "scipy", want[bad][:4])


def test_negative_argument_contract():
    """For x < 0: an integer order by parity, NaN otherwise (scipy's)."""
    v = np.array([0.0, 1.0, 2.0, 3.0, 0.5, -3.0])
    x = np.array([-5.0, -1.0, -2.0, -3.0, -1.5, -2.5])
    for name in ("ive", "jv", "iv"):
        jax, got = _both(name, v, x, "float64")
        want = getattr(sps, name)(v, x)
        np.testing.assert_allclose(got, want, rtol=1e-10, equal_nan=True)
        np.testing.assert_allclose(jax, want, rtol=1e-8, equal_nan=True)


def test_zero_and_infinite_arguments():
    """x = 0 and infinite operands: scipy's values, or the JAX package's
    where they differ (ive(-0.5, 0): the JAX package's limit from the
    right, 0; scipy's NaN)."""
    v = np.array([0.0, 1.0, 0.5, 2.0, np.inf, 1.0, np.nan, 1.0])
    x = np.array([0.0, 0.0, 0.0, 0.0, 1.0, np.inf, 1.0, np.nan])
    for name in NAMES:
        jax, got = _both(name, v, x, "float64")
        with np.errstate(all="ignore"):
            want = getattr(sps, name)(v, x)
        same = [(np.isnan(got) & np.isnan(r)) | (got == r) for r in (want, jax)]
        assert (same[0] | same[1]).all(), (name, got, want, jax)


@pytest.mark.parametrize("name", ["iv", "ive", "jv", "kv", "kve"])
def test_bessel_gradient_against_the_jax_package(name):
    x0 = np.array([0.3, 1.7, 2.7, 8.0])
    out = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        x = pt.dvector("x")
        g = ptt.grad(pt.sum(getattr(pt, name)(1.3, x)), x)
        out.append(np.asarray(ptt.function([x], g, **kw)(x0)))
    np.testing.assert_allclose(out[1], out[0], rtol=1e-8)
    eps = 1e-6
    fd = (getattr(sps, name)(1.3, x0 + eps) - getattr(sps, name)(1.3, x0 - eps)) / (2 * eps)
    np.testing.assert_allclose(out[1], fd, rtol=1e-6)


# --- the bessel loop (benchsuite.py:1067 ours_bessel) -------------------------

N, STEPS = 64, 3


def scipy_loop(v0, steps):
    return bessel_reference(v0, steps)[0]


def _loop(ptt, pt, kw):
    v = ptt.shared(v_start(N), name="v", shape=(N,), **kw)
    y = 0.999 * v + 0.001 * pt.kve(1.0, v) * pt.ive(0.5, v)
    return v, ptt.train_loop([], y[0], {v: y}, n_steps=STEPS, name="bessel_loop", **kw)


def _ops(fg):
    from pytensor_tpu.scan.op import Scan as JScan
    from pytensor_tpu_torch.scan.op import Scan as TScan

    out = []
    for n in fg.toposort():
        out.append(type(n.op).__name__ + ("{" + n.op.scalar_op.name + "}"
                                          if hasattr(n.op, "scalar_op") else ""))
        if isinstance(n.op, (JScan, TScan)):
            out += ["  " + o for o in _ops(n.op.fgraph)]
    return out


def test_bessel_loop_in_both_packages():
    (jv, jf), (tv, tf) = _loop(jptt, jpt, {}), _loop(tptt, tpt, {"device": "cpu"})
    jops, tops = _ops(jf.maker.fgraph), _ops(tf.fgraph)
    assert tops == jops
    # the loop body fuses nothing, in either package: kve and ive run alone
    # (on a card, each a one-node K1 launch)
    assert "  Elemwise{kve}" in tops and "  Elemwise{ive}" in tops
    assert not any("FusedElemwise" in o for o in tops if o.startswith("  "))
    y_j, y_t = float(np.asarray(jf())), float(np.asarray(tf()))
    want = scipy_loop(v_start(N), STEPS)
    np.testing.assert_allclose(np.asarray(tv.get_value()), want, rtol=2e-6)
    np.testing.assert_allclose(np.asarray(jv.get_value()), want, rtol=2e-6)
    assert abs(y_t - want[0]) <= 2e-6 * abs(want[0]) and abs(y_j - y_t) <= 4e-6 * abs(y_j)
    assert tf.linked.host_reads == []


def test_bessel_value_and_gradient_functions_op_for_op():
    """Path (iii): ``function()`` of y and of grad(sum(y), v), which brings
    in kve(0, v), kve(2, v), ive(-0.5, v) and ive(1.5, v) (the negative
    order's reflection)."""
    out, ops = [], []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        v = ptt.shared(v_start(N), name="v", shape=(N,), **kw)
        y = 0.999 * v + 0.001 * pt.kve(1.0, v) * pt.ive(0.5, v)
        f = ptt.function([], [y, ptt.grad(pt.sum(y), v)], **kw)
        out.append([np.asarray(r) for r in f()])
        ops.append(_ops(f.maker.fgraph if hasattr(f, "maker") else f.fgraph))
    assert ops[0] == ops[1]
    assert sum("FusedElemwise" in o for o in ops[1]) == 2
    want_y, want_g = bessel_grad_reference(v_start(N))
    for y, g in out:
        np.testing.assert_allclose(y, want_y, rtol=2e-7)
        np.testing.assert_allclose(g, want_g, rtol=2e-7)


@pytest.mark.parametrize("pallas", [False, True], ids=["step_loop", "scan__pallas"])
def test_the_models_bessel_loop_on_the_cpu(pallas):
    """``models/bessel.py``'s loop and functions, as chip_smoke.py drives
    them on the card (paths (i)-(iii)), at a small size on the CPU: under
    ``scan__pallas`` the scan is K2-eligible and K2's wrapper runs its
    step loop on CPU tensors."""
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda.scan_kernel import ScanKernel

    with config.change_flags(scan__pallas=pallas):
        f, v = make_bessel_loop(N, STEPS, device="cpu")
    kinds = [type(fn).__name__ for fn, *_ in f.linked.steps]
    assert ("ScanKernel" in kinds) == pallas
    y0 = float(f())
    want_v, want_y0 = bessel_reference(v_start(N), STEPS)
    np.testing.assert_allclose(v.get_value().numpy(), want_v, rtol=2e-6)
    assert abs(y0 - want_y0) <= 2e-6 * abs(want_y0)
    assert f.linked.host_reads == [] and ScanKernel
    g, _ = make_bessel_functions(N, device="cpu")
    y, grad = (r.numpy() for r in g())
    want_y, want_g = bessel_grad_reference(v_start(N))
    np.testing.assert_allclose(y, want_y, rtol=2e-7)
    np.testing.assert_allclose(grad, want_g, rtol=2e-7)

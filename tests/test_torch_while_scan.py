"""While-scans (``until``) in the port against the JAX package.

Each graph is built in both packages from the same seeded numpy inputs and
compiled with the default ``FAST_RUN`` (the port on the CPU); the outputs
are held for shape, dtype and value, float64 at ``rtol 1e-12`` (gradients
``1e-10``) and float32 within ``2e-6`` of the largest magnitude.  The
cases are the JAX package's own (``tests/test_scan.py:60-140, 316-395``,
``tests/test_ref_scan.py:431-530``, ``tests/test_ref_scan2.py:171-190,
800-815``), small versions of the two paths ``chip_smoke.py`` drives on a
card (the converged power iteration with its gradient, and the
divergence-stopped radon trajectory), the forward graphs op for op
against the JAX package's rewritten graph (its numpy oracle's mode, which
leaves out the XLA path's ``WhileScanDynLen``), and K2's refusal.

The pinned difference: a while-scan's reverse scan runs the steps its
forward ran, where the JAX package's runs all ``n_steps`` and masks the
rest.  The values agree, but where an inner gradient is not finite at the
padded rows' zeros, the JAX package's gradient is NaN and the port's is
the executed prefix's (``test_gradient_never_reads_the_padded_rows``).
"""

import importlib

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.sparse as jsparse
import pytensor_tpu.tensor as jpt
import pytensor_tpu.tensor.random as jrand
from pytensor_tpu.compile.mode import PY, Mode
import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.sparse as tsparse
import pytensor_tpu_torch.tensor as tpt
import pytensor_tpu_torch.tensor.random as trand


class Pkg:
    """One package's namespaces, by the names the graph-building
    functions below use."""

    def __init__(self, name, ptt, pt, rand, sparse, kw):
        self.name, self.ptt, self.pt, self.rand, self.sparse, self.kw = (
            name, ptt, pt, rand, sparse, kw)
        self.until = importlib.import_module(ptt.__name__ + ".scan").until

    def function(self, inputs, outputs, **kw):
        return self.ptt.function(inputs, outputs, **self.kw, **kw)

    def rng(self, seed):
        return self.rand.RandomStream(seed, **self.kw)


JAX = Pkg("jax", jptt, jpt, jrand, jsparse, {})
PORT = Pkg("torch", tptt, tpt, trand, tsparse, {"device": "cpu"})


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _ops(f):
    fg = f.maker.fgraph if hasattr(f, "maker") else f.fgraph
    return [type(n.op).__name__ for n in fg.toposort()]


def held(got, want, rtol=1e-12, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif want.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-6 * max(1.0, float(np.max(np.abs(want)))),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-300, err_msg=what)


def both(build, values, rtol=1e-12, jax_mode=None):
    """``build(pkg) -> (inputs, outputs)`` in each package, compiled and
    called on ``values``; the port's outputs are held to the JAX
    package's (in ``jax_mode``, by default ``FAST_RUN``) and returned,
    with the two functions."""
    res, fns = [], []
    for pkg in (JAX, PORT):
        ins, outs = build(pkg)
        f = pkg.function(ins, outs, **({"mode": jax_mode} if pkg is JAX and jax_mode else {}))
        res.append([_np(o) for o in f(*values)])
        fns.append(f)
    for k, (g, w) in enumerate(zip(res[1], res[0])):
        held(g, w, rtol, what=f"output {k}")
    return res[1], fns


# --- the JAX package's cases ------------------------------------------------------


def _doubling(p):
    x0 = p.pt.dscalar("x0")
    out, _ = p.ptt.scan(lambda acc: (acc * 2, p.until(acc * 2 > 100)), outputs_info=[x0],
                        n_steps=20)
    return [x0], [out, out.shape[0], out.owner.inputs[1], out[-1]]


def test_doubling_stops_after_the_condition_and_exposes_steps_done():
    (tr, n, steps, last), _ = both(_doubling, [1.0])
    np.testing.assert_array_equal(tr, [2.0 ** k for k in range(1, 8)])
    assert int(n) == int(steps) == 7 and float(last) == 128.0


def _constant_start(p):
    out, _ = p.ptt.scan(lambda acc: (acc * 2, p.until(acc * 2 >= 100)),
                        outputs_info=[p.pt.constant(1.0, dtype="float64")], n_steps=20)
    return [], [out]


def test_constant_start_is_folded_alike():
    (tr,), _ = both(_constant_start, [])
    assert tr[-1] == 128.0


def _with_sequence(p):
    x = p.pt.dvector("x")
    out, _ = p.ptt.scan(lambda xt, acc: (acc + xt, p.until(acc + xt > 6.0)), sequences=[x],
                        outputs_info=[p.pt.constant(0.0, dtype="float64")])
    return [x], [out]


def test_sequence_stops_at_the_executed_prefix():
    (tr,), _ = both(_with_sequence, [np.arange(1.0, 9.0)])
    np.testing.assert_array_equal(tr, [1, 3, 6, 10])


def _mit_sot(p):
    init = p.pt.dvector("init")
    out, _ = p.ptt.scan(lambda a2, a1: (a1 + a2, p.until(a1 + a2 >= 30.0)),
                        outputs_info=[dict(initial=init, taps=[-2, -1])], n_steps=12)
    return [init], [out]


def test_mit_sot_fibonacci():
    (tr,), _ = both(_mit_sot, [np.array([1.0, 1.0])])
    np.testing.assert_array_equal(tr, [2, 3, 5, 8, 13, 21, 34])


def test_early_exit_runs_only_the_executed_steps():
    """200,000 steps asked, 17 run: the step loop stops at the exit."""
    out, _ = tptt.scan(lambda acc: (acc * 2, PORT.until(acc * 2 >= 1e5)),
                       outputs_info=[tpt.constant(1.0, dtype="float64")], n_steps=200_000)
    f = PORT.function([], [out[-1], out.shape[0]])
    last, n = f()
    assert float(last) == 131072.0 and int(n) == 17


def _gradient(p):
    x, y0, a = p.pt.dvector("x"), p.pt.dscalar("y0"), p.pt.dscalar("a")
    tr, _ = p.ptt.scan(lambda xt, acc, aa: (aa * acc + xt, p.until(aa * acc + xt > 3.0)),
                       sequences=[x], outputs_info=[y0], non_sequences=[a])
    loss = tr.sum() + tr[-1]
    return [x, y0, a], [loss, *p.ptt.grad(loss, [x, y0, a])]


def test_gradient_of_a_while_scan():
    xv = np.array([0.3, 0.4, 0.5, 0.6, 0.7, 0.8])
    (loss, gx, gy, ga), _ = both(_gradient, [xv, 0.5, 1.3], rtol=1e-10)
    assert np.all(gx[4:] == 0.0) and np.all(gx[:4] != 0.0)


def _multitap_nit(p):
    c9, c4, c2 = (p.pt.constant(np.float64(v)) for v in (0.9, 0.4, 2.0))
    y0 = p.pt.dvector("y0")

    def step(ym2, ym1):
        nxt = c9 * ym1 + c4 * ym2
        return (nxt, nxt ** 2), p.until(nxt > c2)

    (tr, sq), _ = p.ptt.scan(step, outputs_info=[dict(initial=y0, taps=[-2, -1]), None],
                             n_steps=12)
    loss = tr.sum() + 2.0 * sq.sum()
    return [y0], [tr, sq, loss, p.ptt.grad(loss, y0)]


def test_gradient_with_multi_tap_state_and_nit_sot():
    (tr, sq, loss, g), _ = both(_multitap_nit, [np.array([0.5, 0.6])], rtol=1e-10)
    assert 1 < tr.shape[0] < 12 and sq.shape == tr.shape


SEQ = np.arange(15, dtype="float64")


def _grad_until(p, truncate=-1):
    x, u = p.pt.dvector("x"), p.pt.scalar("u", dtype="int64")
    r = p.ptt.scan(lambda xt, uu: (xt * xt, p.until(xt > uu)), sequences=x,
                   non_sequences=[u], truncate_gradient=truncate, return_updates=False)
    return [x, u], [r, p.ptt.grad(r.sum(), x)]


@pytest.mark.parametrize("truncate", [-1, 3])
def test_grad_until_and_truncate(truncate):
    (r, g), _ = both(lambda p: _grad_until(p, truncate), [SEQ, 5], rtol=1e-10)
    want = 2 * np.concatenate([SEQ[:7], np.zeros(8)])
    if truncate != -1:
        want[: 7 - truncate] = 0
    np.testing.assert_array_equal(r, SEQ[:7] ** 2)
    np.testing.assert_array_equal(g, want)


def _grad_until_matrix(p):
    X, u = p.pt.dmatrix("X"), p.pt.scalar("u", dtype="int64")
    r = p.ptt.scan(lambda xt, uu: (xt * xt, p.until(p.pt.all(xt > uu))), sequences=X,
                   non_sequences=[u], return_updates=False)
    return [X, u], [r, p.ptt.grad(r.sum(), X)]


def test_grad_until_ndim_greater_one():
    """Against the JAX package's unrewritten numpy oracle, as
    ``tests/test_torch_scan_grad.py`` does: its canonicalize pass takes
    ~14 s on this graph (it reaches its use ratio)."""
    arr = np.tile(SEQ.reshape((-1, 1)), (1, 5))
    (r, g), _ = both(_grad_until_matrix, [arr, 5], rtol=1e-10,
                     jax_mode=Mode(linker="py", optimizer="None"))
    assert r.shape == (7, 5) and np.all(g[7:] == 0)


def _recurrent(p):
    x, x0 = p.pt.dvector("x"), p.pt.dscalar("x0")
    xs = p.ptt.scan(lambda y, acc: (1.3 * acc + y, p.until(1.3 * acc + y > 5.0)),
                    sequences=x, outputs_info=[x0], return_updates=False)
    return [x, x0], [xs, *p.ptt.grad(xs.sum(), [x, x0])]


def test_grad_until_with_recurrent_state():
    (xs, gs, g0), _ = both(_recurrent, [np.linspace(0.4, 0.9, 12), 0.2], rtol=1e-10)
    k = xs.shape[0]
    assert 1 < k < 12
    j = np.arange(12)
    np.testing.assert_allclose(gs, np.where(j < k, (1.3 ** (k - j) - 1) / 0.3, 0.0),
                               rtol=1e-10)


def _hidden(p):
    max_value, n_steps = p.pt.dscalar("max_value"), p.pt.scalar("n", dtype="int32")

    def accum(prev, step):
        return [prev + step, step + 1], p.until(prev + step > max_value)

    rs = p.ptt.scan(accum, outputs_info=[p.pt.constant(0.0), p.pt.constant(0.0)],
                    n_steps=n_steps, return_updates=False)
    return [max_value, n_steps], rs


def test_condition_hidden_input_becomes_a_non_sequence():
    (total, steps), (_, f) = both(_hidden, [100.0, 100])
    assert total[-1] > 100.0 and total.shape == (15,)
    node = next(n for n in f.fgraph.toposort() if type(n.op).__name__ == "Scan")
    assert node.op.info.as_while and node.op.info.n_non_seqs == 1


def _forms(p):
    x0 = p.pt.dscalar("x0")
    sh = p.ptt.shared(np.float64(0.0), **p.kw)
    outs, upd = p.ptt.scan(lambda acc: (acc + 1.0, {sh: sh + acc}, p.until(acc > 3.0)),
                           outputs_info=[x0], n_steps=10)
    only_until, _ = p.ptt.scan(lambda acc: p.until(acc > 3.0), sequences=[outs])
    return [x0], [outs, sh + 0.0], upd


def test_the_three_until_forms():
    """``(outputs, updates, until)``; ``until`` alone (a scan of no outputs
    builds); the traced update reads the executed prefix's last value."""
    res = []
    for pkg in (JAX, PORT):
        ins, outs, upd = _forms(pkg)
        f = pkg.function(ins, outs, updates=upd)
        first = [_np(o) for o in f(0.0)]
        res.append(first + [_np(o) for o in f(0.0)])
    for g, w in zip(res[1], res[0]):
        held(g, w)
    np.testing.assert_array_equal(res[1][0], [1, 2, 3, 4, 5])
    assert float(res[1][3]) == 10.0  # the update after one call: 0 + 1 + 2 + 3 + 4


def _while_shape(p):
    x = p.pt.dvector("x")
    o = p.ptt.scan(lambda xt: (xt + 1, p.until(xt > 3)), x, return_updates=False)
    return [x], [o, o.shape[0]]


def test_while_shape_is_the_executed_length():
    vx = np.zeros(50)
    vx[23] = 4
    (o, n), _ = both(_while_shape, [vx])
    assert o.shape == (24,) and int(n) == 24


# --- RNG in a while-scan -------------------------------------------------------------


def _walk(p):
    srng = p.rng(3)

    def step(prev):
        nxt = prev + p.pt.abs(srng.normal(0.0, 1.0)) + 0.01
        return nxt, p.until(nxt >= 3.0)

    walk, updates = p.ptt.scan(step, outputs_info=[p.pt.constant(0.0, dtype="float64")],
                               n_steps=64)
    (key,) = list(updates)
    return p.function([], walk, updates=updates), key


def test_rng_key_threads_through_the_loop_and_matches_after_an_early_exit():
    walks, keys = [], []
    for pkg in (JAX, PORT):
        f, key = _walk(pkg)
        walks.append([_np(f()), _np(f())])
        keys.append(_np(key.get_value()))
    for g, w in zip(walks[1], walks[0]):
        held(g, w)
    np.testing.assert_array_equal(keys[1], keys[0])
    a = walks[1][0]
    assert a[-1] >= 3.0 and (a[:-1] < 3.0).all() and a.shape[0] < 64


def _random_grad(p):
    x = p.pt.dscalar("x")
    srng = p.rng(0)

    def step(prev):
        return prev + srng.uniform(), p.until(prev > 5)

    out, updates = p.ptt.scan(step, outputs_info=x, n_steps=10)
    return p.function([x], [out, p.ptt.grad(out.sum(), x)], updates=updates)


def test_until_with_rng_and_its_gradient():
    fns = [_random_grad(pkg) for pkg in (JAX, PORT)]
    for i in (-5, 0, 3):
        want, got = (f(np.float64(i)) for f in fns)
        held(got[0], want[0])
        held(got[1], want[1])
        assert _np(got[0]).shape[0] == int(_np(got[1]))


# --- the chip paths, small -----------------------------------------------------------


def test_converged_power_iteration_and_its_gradient():
    from pytensor_tpu_torch.models.power import (
        choose_tol,
        power_graphs,
        power_matrix,
        power_reference,
    )

    A, x0 = power_matrix(512, 10, seed=3)
    tol, margin = choose_tol(power_reference(A, x0), 10)
    assert margin > 1.5
    w = np.random.default_rng(4).standard_normal((512, 1)).astype("float32")

    def build(p):
        x, wv, (xs,), g = power_graphs(p.ptt, p.pt, p.sparse, A, tol)
        return [x, wv], [xs, g]

    (xs, g), (_, f) = both(build, [x0, w])
    assert xs.shape == (10, 512, 1)
    ops = _ops(f)
    assert "RoutedSpMV" not in ops  # inside the scans
    inner = [type(n.op).__name__ for n in f.fgraph.toposort() if type(n.op).__name__ == "Scan"]
    assert len(inner) == 2


def test_divergence_stopped_radon_trajectory():
    """The trajectory at 40 observations and 5 counties: a step size at
    which the energy diverges mid-trajectory and one at which it does
    not, each against the JAX package and against the port's for-scan of
    the same length (the same rows up to the exit)."""
    from pytensor_tpu.models.radon import make_radon_graphs as jgraphs
    from pytensor_tpu_torch.models.radon import (
        make_radon_graphs as tgraphs,
        theta_start,
        trajectory_graphs,
    )

    graphs = {"jax": jgraphs, "torch": tgraphs}
    th0 = theta_start(9)
    m0 = np.random.default_rng(1).standard_normal(9)
    lengths = []
    for eps in (0.3, 0.02):
        def build(p, stop=True):
            t0, mm, traces = trajectory_graphs(p.ptt, p.pt, graphs[p.name](40, 5), 48, eps, stop)
            return [t0, mm], traces

        (ths, ms, hs), _ = both(build, [th0, m0], rtol=1e-10)
        full = PORT.function(*build(PORT, stop=False))(th0, m0)
        k = ths.shape[0]
        for a, b in zip((ths, ms, hs), full):
            np.testing.assert_array_equal(a, _np(b)[:k])
        diverged = _np(full[3])  # the for-scan's trace of the same test
        assert not diverged[: k - 1].any() and (k == 48 or diverged[k - 1])
        lengths.append(k)
    assert 1 < lengths[0] < 48 and lengths[1] == 48


# --- graphs, rewrites and K2 -----------------------------------------------------------


def _multitap_forward(p):
    ins, outs = _multitap_nit(p)
    return ins, outs[:2]


@pytest.mark.parametrize("build", [_doubling, _with_sequence, _mit_sot, _multitap_forward,
                                   _hidden, _while_shape], ids=lambda b: b.__name__)
def test_forward_graphs_op_for_op(build):
    """The port's rewritten graph against the JAX package's with its
    ``FAST_RUN`` rewrites and not the XLA path's (``WhileScanDynLen``):
    the same ops in the same order, inner graphs included."""
    ins, outs = build(JAX)
    jf = jptt.function(ins, outs, mode=PY)
    ins, outs = build(PORT)
    tf = PORT.function(ins, outs)
    assert _ops(tf) == _ops(jf)

    def inner(f):
        fg = f.maker.fgraph if hasattr(f, "maker") else f.fgraph
        return [[type(m.op).__name__ for m in n.op.fgraph.toposort()]
                for n in fg.toposort() if type(n.op).__name__ == "Scan"]

    assert inner(tf) == inner(jf)


def test_rewrites_refuse_a_while_scan():
    """A nit-sot that does not depend on the state is pushed out of a
    for-scan and kept in a while-scan, in both packages."""
    def build(p, stop):
        x = p.pt.dvector("x")

        def step(xt, acc):
            out = (acc + xt, p.pt.exp(xt) * 2.0)
            return (out, p.until(acc + xt > 6.0)) if stop else out

        (tr, ex), _ = p.ptt.scan(step, sequences=[x], outputs_info=[p.pt.constant(0.0), None])
        return [x], [tr, ex]

    for stop in (True, False):
        ops = []
        for pkg, kw in ((JAX, {"mode": PY}), (PORT, {})):
            ins, outs = build(pkg, stop)
            f = pkg.ptt.function(ins, outs, **pkg.kw, **kw)
            fg = f.maker.fgraph if hasattr(f, "maker") else f.fgraph
            scan = next(n for n in fg.toposort() if type(n.op).__name__ == "Scan")
            ops.append((scan.op.info.n_nit_sot, _ops(f)))
        assert ops[0][0] == ops[1][0] == (1 if stop else 0)
        if stop:
            assert ops[0][1] == ops[1][1]


def test_k2_refuses_a_while_scan():
    from pytensor_tpu.link.pallas.scan_pallas import pallas_scan_eligible
    from pytensor_tpu_torch.link.cuda.scan_kernel import scan_kernel_eligible

    for pkg, eligible in ((JAX, pallas_scan_eligible), (PORT, scan_kernel_eligible)):
        for stop in (True, False):
            x0 = pkg.pt.tensor("x0", dtype="float32", shape=(8,))

            def step(acc):
                nxt = pkg.pt.tanh(acc) * np.float32(1.5)
                return (nxt, pkg.until(pkg.pt.all(nxt > 10.0))) if stop else nxt

            out, _ = pkg.ptt.scan(step, outputs_info=[x0], n_steps=16)
            node = (out.owner.inputs[0] if stop else out).owner
            assert eligible(node.op, node) is (not stop), (pkg.name, stop)


def test_a_plan_holding_a_while_scan_runs_eagerly():
    ins, outs = _doubling(PORT)
    f = PORT.function(ins, outs)
    assert any("reads its condition on the host" in r for r in f.linked.host_reads)


def test_gradient_never_reads_the_padded_rows():
    """The pinned difference: sqrt's gradient at a padded row's zero is
    infinite, and the JAX package's masked reverse scan multiplies it by
    a zero cotangent (NaN); the port's reverse scan runs the executed
    steps only, and its gradient is the finite one of the prefix."""
    def build(p):
        x0 = p.pt.dscalar("x0")
        tr, _ = p.ptt.scan(lambda a: (p.pt.sqrt(a) + 1.0, p.until(a > 2.0)), outputs_info=[x0],
                           n_steps=10)
        return [x0], [tr, p.ptt.grad(tr.sum(), x0)]

    ins, outs = build(JAX)
    jtr, jg = (np.asarray(v) for v in jptt.function(ins, outs)(0.5))
    ins, outs = build(PORT)
    ttr, tg = (_np(v) for v in PORT.function(ins, outs)(0.5))
    held(ttr, jtr)
    assert np.isnan(jg)
    # d/dx0 of the prefix's sum by central differences
    f = PORT.function(ins, outs[0].sum())
    eps = 1e-6
    fd = (float(f(0.5 + eps)) - float(f(0.5 - eps))) / (2 * eps)
    np.testing.assert_allclose(float(tg), fd, rtol=1e-6)

"""Backprop through scan (``Scan.L_op``) in the port against the JAX
package, on the CPU.

Each case builds the same graph in both packages from the same numpy
inputs (``np.random.default_rng`` with a fixed seed) and compares the
values: the for-scan gradient cases of ``tests/test_scan.py:151-221``,
``:412-636`` and ``:779`` and the ``grad`` cases of
``tests/test_ref_scan.py`` from ``:276`` (without ``until`` and RNG), plus
``truncate_gradient``, ``go_backwards``, several sequences, the views,
``scan_checkpoints`` and ``verify_grad``, and the cases of
``tests/test_ref_scan2.py:216-372``; those of its ``:408-528`` are in
``test_torch_scan_grad2.py``, which imports this file's helpers (the two
files run on two workers).  The JAX package runs
the graph as built, on its numpy oracle (``Mode(linker="py", optimizer=
"None")``: its rewrites take up to 80 s on some of these gradient graphs
on the CPU, in the ShapeFeature branch of ``local_useless_slice_parts``);
the port runs its default mode, rewritten, on its step loop.  The JAX
package's rewritten graphs are held against the port's op by op in
``tests/test_torch_models.py`` (the Elman step and loop).

Tolerance: ``rtol 1e-10`` in float64 and ``rtol 1e-5`` in float32, over
``max(1, |value|)``: the two packages sum the same products in other
orders.
"""

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
from pytensor_tpu.config import config as jconfig
from pytensor_tpu.link.pallas.scan_pallas import pallas_scan_eligible

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.config import config as tconfig
from pytensor_tpu_torch.link.cuda.scan_kernel import scan_kernel_eligible


class Pkg:
    """One package, as the cases use it."""

    def __init__(self, name):
        self.name = name
        self.torch = name == "torch"
        self.ptt, self.pt, self.config = ((tptt, tpt, tconfig) if self.torch
                                          else (jptt, jpt, jconfig))
        self.scan = self.ptt.scan
        self.grad = self.ptt.grad

    def shared(self, value, name=None):
        kw = {"device": "cpu"} if self.torch else {}
        return self.ptt.shared(value, name=name, **kw)

    def function(self, inputs, outputs, **kw):
        if self.torch:
            kw["device"] = "cpu"
        return self.ptt.function(inputs, outputs, **kw)

    def verify_grad(self, fun, pt, rng):
        kw = {"device": "cpu"} if self.torch else {}
        return self.ptt.verify_grad(fun, pt, rng=rng, **kw)


PKGS = [Pkg("jax"), Pkg("torch")]


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _values(P, build):
    inputs, outputs, values = build(P)
    mode = None if P.torch else P.ptt.Mode(linker="py", optimizer="None")
    res = P.function(inputs, outputs, mode=mode)(*values)
    return [_np(r) for r in (res if isinstance(res, (list, tuple)) else [res])]


def _close(got, want, what=""):
    assert got.shape == want.shape and got.dtype == want.dtype, (what, got.dtype, want.dtype)
    rtol = 1e-5 if got.dtype == np.float32 else 1e-10
    scale = np.maximum(1.0, np.abs(want.astype("float64")))
    err = np.abs(got.astype("float64") - want.astype("float64")) / scale
    assert float(err.max(initial=0.0)) <= rtol, (what, float(err.max()))


def _same(build):
    j, t = (_values(P, build) for P in PKGS)
    assert len(j) == len(t)
    for k, (a, b) in enumerate(zip(t, j)):
        _close(a, b, f"output {k}")
    return t


def _rng(seed=0):
    return np.random.default_rng(seed)


def _dvec(P, name):
    return P.pt.tensor(name, dtype="float64", shape=(None,))


def _dmat(P, name):
    return P.pt.tensor(name, dtype="float64", shape=(None, None))


def _dscalar(P, name):
    return P.pt.tensor(name, dtype="float64", shape=())


CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


# --- tests/test_scan.py:151-221 ------------------------------------------------------

@case
def grad_sitsot(P):
    x = _dvec(P, "x")
    out, _ = P.scan(lambda xt, acc: acc * xt, sequences=[x],
                    outputs_info=[P.pt.constant(1.0, dtype="float64")])
    return [x], P.grad(out[-1], x), [np.array([2.0, 3.0, 4.0])]


@case
def grad_nonseq(P):
    x, a = _dvec(P, "x"), _dscalar(P, "a")
    ew, _ = P.scan(lambda xt, prev, a: a * xt + (1 - a) * prev, sequences=[x],
                   outputs_info=[P.pt.constant(0.0, dtype="float64")], non_sequences=[a])
    return [x, a], P.grad(ew.sum(), a), [np.arange(4.0), 0.3]


def _rnn_cost(P, X, Wx, Wh):
    pt = P.pt
    H, _ = P.scan(lambda xt, hprev, a, b: pt.tanh(pt.dot(xt, a) + pt.dot(hprev, b)),
                  sequences=[X], outputs_info=[pt.as_tensor_variable(np.zeros(3))],
                  non_sequences=[Wx, Wh])
    return (H[-1] ** 2).sum()


@case
def rnn_bptt(P):
    X, Wx, Wh = _dmat(P, "X"), _dmat(P, "Wx"), _dmat(P, "Wh")
    rng = _rng()
    vals = [rng.random((4, 2)), rng.random((2, 3)) * 0.5, rng.random((3, 3)) * 0.5]
    return [X, Wx, Wh], P.grad(_rnn_cost(P, X, Wx, Wh), [X, Wx, Wh]), vals


@case
def grad_mit_sot(P):
    w = _dscalar(P, "w")
    init = P.pt.as_tensor_variable(np.array([1.0, 1.0]))
    s, _ = P.scan(lambda fm2, fm1, w: w * fm2 + fm1,
                  outputs_info=[dict(initial=init, taps=[-2, -1])], non_sequences=[w],
                  n_steps=5)
    return [w], P.grad(s[-1], w), [1.0]


@case
def grad_init(P):
    h0 = _dscalar(P, "h0")
    out, _ = P.scan(lambda prev: prev * 0.5, outputs_info=[h0], n_steps=3)
    return [h0], P.grad(out[-1], h0), [4.0]


# --- tests/test_scan.py:412-636 --------------------------------------------------------

@case
def second_order(P):
    x, a = _dvec(P, "x"), _dscalar(P, "a")
    tr, _ = P.scan(lambda xt, acc, aa: acc * aa + xt ** 2, sequences=[x],
                   outputs_info=[P.pt.constant(np.float64(0.5))], non_sequences=[a])
    g_a = P.grad((tr ** 2).sum(), a)
    return [x, a], [g_a, P.grad(g_a, a)], [np.array([0.3, 0.5, 0.2, 0.7]), 0.9]


@case
def push_out_seqs_nonseq_grad(P):
    pt = P.pt
    xs, w = _dmat(P, "xs"), _dmat(P, "w")
    out, _ = P.scan(lambda xt, acc, ww: acc * np.float64(0.9) + (ww @ xt), sequences=[xs],
                    outputs_info=[pt.zeros((3,), dtype="float64")], non_sequences=[w])
    rng = _rng()
    return ([xs, w], [out[-1], *P.grad((out[-1] ** 2).sum(), [xs, w])],
            [rng.normal(size=(5, 3)), rng.normal(size=(3, 3))])


@case
def push_out_add_grad(P):
    pt = P.pt
    x, w = _dvec(P, "x"), _dmat(P, "w")
    out, _ = P.scan(lambda xt, acc, ww: acc + xt * pt.exp(ww).sum(), sequences=[x],
                    outputs_info=[pt.constant(0.0, dtype="float64")], non_sequences=[w])
    return [x, w], [out[-1], *P.grad(out[-1] ** 2, [x, w])], [np.arange(4.0), np.ones((2, 2))]


@case
def checkpoints_grad(P):
    from importlib import import_module

    checkpoints = import_module(f"{P.ptt.__name__}.scan.checkpoints")
    x = _dvec(P, "x")
    out, _ = checkpoints.scan_checkpoints(lambda xt, acc: acc * np.float64(0.9) + xt,
                                          sequences=[x],
                                          outputs_info=P.pt.constant(np.float64(0.0)),
                                          save_every_N=4)
    assert out.owner.op.tag_remat
    loss = out[-1] ** 2
    return [x], [loss, P.grad(loss, x)], [np.arange(8.0) * 0.1]


# --- tests/test_ref_scan.py from :276 ------------------------------------------------------

@case
def grad_numeric_shared(P):
    shared_var = P.shared(np.float32(1.0))
    _, updates = P.scan(lambda: ([], {shared_var: shared_var + np.float32(1.0)}), n_steps=10)
    return [], P.grad(next(iter(updates.values())), shared_var), []


def _powers(P):
    pt = P.pt
    c, x = _dvec(P, "c"), _dscalar(P, "x")
    components = P.scan(lambda coeff, power, free_var: coeff * (free_var ** power),
                        outputs_info=None, sequences=[c, pt.arange(1000)], non_sequences=x,
                        return_updates=False)
    return c, x, P.grad(components.sum(), x)


@case
def grad_multiple_seqs_different_nsteps(P):
    c, x, dP = _powers(P)
    return [c, x], dP, [np.array([1.0, 2.0, -3.0, 4.0]), 2.0]


@case
def grad_of_grad_of_state(P):
    c, x, dP = _powers(P)
    return [c, x], P.grad(dP.sum(), x), [np.array([1.0, 2.0, -3.0, 4.0]), 2.0]


@case
def grad_multiple_taps_state(P):
    xinit = P.pt.tensor("xinit", dtype="float64", shape=(None, None, None))
    w = _dmat(P, "w")
    xseq, _ = P.scan(n_steps=10, fn=lambda xdl, xprev, w_: w_ + xprev,
                     outputs_info=[dict(initial=xinit, taps=[-4, -1])], non_sequences=w)
    rng = _rng(1)
    return ([xinit, w], P.grad((xseq[-1] ** 2).sum(), [w, xinit]),
            [rng.uniform(1.0, 3.0, size=(5, 2, 2)), rng.uniform(1.0, 3.0, size=(2, 2))])


@case
def disconnected_gradient2(P):
    v, m = _dvec(P, "v"), _dmat(P, "m")
    [_u, m2] = P.scan(lambda x, u: [x + u, u + v], sequences=m,
                      outputs_info=[P.pt.zeros((7,), dtype="float64"), None],
                      return_updates=False)
    rng = _rng(2)
    return [m, v], P.grad(m2.sum(), m), [rng.random((3, 7)), rng.random(7)]


@case
def disconnected_gradient3(P):
    v = _dvec(P, "v")
    [_o1, out2] = P.scan(lambda seq: (seq + 1, seq + 2), sequences=v, return_updates=False)
    return [v], P.grad(out2.sum(), v), [_rng(3).random(5)]


@case
def grad_bug_disconnected_input(P):
    W = P.shared(np.zeros((3, 3)), name="W")
    v = P.pt.tensor("v", dtype="int32", shape=(None,))
    y = P.scan(lambda i, W_: W_[i], sequences=v, outputs_info=None, non_sequences=W,
               return_updates=False)
    return [v], P.grad(y.sum(), W), [np.asarray([1, 2], "int32")]


@case
def grad_find_input(P):
    w = P.shared(np.array(0.5, dtype="float32"), name="w")
    init = P.pt.tensor("init", dtype="float32", shape=())
    out = P.scan(fn=lambda prev: prev * w, outputs_info=init, n_steps=2, return_updates=False)
    return [init], P.grad(out[-1], w), [np.float32(1.5)]


@case
def grad_wrt_shared(P):
    x1 = P.shared(np.float64(3.0), name="x1")
    x2 = _dvec(P, "x2")
    y = P.scan(lambda v: x1 * v, sequences=x2, return_updates=False)
    return [x2], P.grad(y.sum(), x1), [np.array([2.0, 3.0])]


@case
def default_value_broadcasted(P):
    pt = P.pt
    X = _dmat(P, "X")
    W_x = P.shared(_rng(4).random((2, 4)) * 0.1, "W_x")
    value = P.scan(lambda x, pre_h: pt.dot(pt.reshape(x, (1, 2)), W_x), sequences=X,
                   outputs_info=[pt.alloc(np.float64(0.0), 1, 4)], return_updates=False)
    cost = pt.mean(value)
    return [X], [cost, P.grad(cost, W_x)], [_rng(5).random((10, 2))]


# --- tests/test_ref_scan2.py:216-372 ------------------------------------------------------

@case
def inner_grad(P):
    pt = P.pt
    x, A = _dvec(P, "x"), _dmat(P, "A")
    fc1 = P.shared(np.float64(0.5), name="fc1")
    fc2 = P.shared(np.float64(0.9), name="fc2")
    gy = P.grad(fc1 * pt.dot(x * x, pt.dot(A, x)), x)
    hy = P.scan(lambda i, gy_, x_: P.grad(gy_[i] * fc2, x_), sequences=pt.arange(gy.shape[0]),
                non_sequences=[gy, x], return_updates=False)
    return [x, A], hy, [np.array([1.0, 1.0]), np.array([[1.0, 1.0], [1.0, 0.0]])]


@case
def high_order_grad_sitsot(P):
    x = _dscalar(P, "x")
    ys = P.scan(fn=lambda xtm1: xtm1 ** 2, outputs_info=[x], n_steps=4, return_updates=False)
    derivs, d = [], ys[-1]
    for _ in range(4):
        d = P.grad(d, x)
        derivs.append(d)
    return [x], derivs, [np.float64(0.95)]


@case
def second_derivative_mit_mot(P):
    pt = P.pt
    seq = pt.tensor("seq", shape=(2,), dtype="float64")
    z = _dscalar(P, "z")
    x0 = pt.tensor("x0", shape=(2,), dtype="float64")
    xs = P.scan(lambda s, xtm2, xtm1, z_: s * ((xtm2 * 0 + xtm1) ** 2) * (z_ / 2),
                sequences=[seq], outputs_info=[{"initial": x0, "taps": (-2, -1)}],
                non_sequences=[z], n_steps=2, return_updates=False)
    g_x0, g_z, g_seq = P.grad(xs[-1], [x0, z, seq])
    g = g_x0.sum() + g_z.sum() * 0 + g_seq.sum() * 0
    return [seq, x0, z], [g, P.grad(g, wrt=x0).sum()], [np.array([2.0, 2.0]), np.ones(2), 2.0]


# --- the options and the views ----------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 10])
def test_truncate_gradient(n):
    def build(P):
        x, a = _dvec(P, "x"), _dscalar(P, "a")
        tr, _ = P.scan(lambda xt, acc, aa: acc * aa + xt ** 2, sequences=[x],
                       outputs_info=[P.pt.constant(np.float64(0.5))], non_sequences=[a],
                       truncate_gradient=n)
        assert tr.owner.op.truncate_gradient == n
        return [x, a], P.grad((tr ** 2).sum(), [x, a]), [np.linspace(0.1, 0.8, 6), 0.9]

    g = _same(build)
    if n < 6:  # steps before the window get no gradient
        np.testing.assert_array_equal(g[0][: 6 - n], 0.0)


@pytest.mark.parametrize("view", ["map", "reduce", "foldl", "foldr"])
def test_views_grad(view):
    def build(P):
        from importlib import import_module

        views = import_module(f"{P.ptt.__name__}.scan.views")
        x, a = _dvec(P, "x"), _dscalar(P, "a")
        if view == "map":
            out, _ = views.map(lambda xt, aa: P.pt.sin(xt * aa), [x], [a])
            cost = (out ** 2).sum()
        else:
            out, _ = getattr(views, view)(lambda xt, acc, aa: acc * aa + xt, [x],
                                          P.pt.constant(np.float64(0.25)), [a])
            cost = out ** 2
        return [x, a], [cost, *P.grad(cost, [x, a])], [np.linspace(-1.0, 1.0, 5), 0.7]

    _same(build)


def test_go_backwards_grad():
    def build(P):
        x = _dvec(P, "x")
        out, _ = P.scan(lambda xt, acc: acc * np.float64(0.5) + xt ** 3, sequences=[x],
                        outputs_info=[P.pt.constant(np.float64(0.0))], go_backwards=True)
        return [x], [out, P.grad((out ** 2).sum(), x)], [np.linspace(0.2, 1.0, 5)]

    _same(build)


def test_several_unknown_length_sequences_take_the_shortest():
    def build(P):
        x, y = _dvec(P, "x"), _dvec(P, "y")
        out, _ = P.scan(lambda a, b, acc: acc + a * b, sequences=[x, y],
                        outputs_info=[P.pt.constant(np.float64(0.0))])
        return [x, y], [out, *P.grad(out[-1], [x, y])], [np.arange(5.0), np.arange(3.0) + 1]

    out = _same(build)
    assert out[0].shape == (3,) and out[1][3:].tolist() == [0.0, 0.0]


@pytest.mark.parametrize("name", sorted(CASES))
def test_grad_matches_jax(name):
    _same(CASES[name])


# --- verify_grad, and what raises in both ---------------------------------------------------

@pytest.mark.parametrize("which", ["rnn", "sitsot_of_grad", "mitsot_of_grad"])
def test_verify_grad(which):
    """The JAX package's ``verify_grad`` cases (``tests/test_scan.py:185``,
    ``tests/test_ref_scan2.py`` TestHigherOrderGrads) pass in the port."""
    P = PKGS[1]
    rng = _rng()
    if which == "rnn":
        def fun(X, Wx, Wh):
            return _rnn_cost(P, X, Wx, Wh)

        pt = [rng.random((4, 2)), rng.random((2, 3)) * 0.5, rng.random((3, 3)) * 0.5]
    elif which == "sitsot_of_grad":
        def fun(inp):
            outs = P.scan(fn=lambda x: x * 2, outputs_info=[inp], n_steps=5,
                          return_updates=False)
            return P.grad(outs.sum(), inp).sum()

        pt = [rng.random(3)]
    else:
        def fun(input0, input1):
            def inner(m2, s):
                out = (m2 + s) ** 1.02
                return out, out

            outs = P.scan(fn=inner, outputs_info=[dict(initial=input0, taps=[-2]), input1],
                          n_steps=3, return_updates=False)
            return (P.grad(outs[0].sum(), input0).sum()
                    + P.grad(outs[1].sum(), input1).sum())

        pt = [rng.random((2, 3)), rng.random(3)]
    assert P.verify_grad(fun, pt, rng=np.random.default_rng(1))


def test_verify_grad_catches_a_wrong_gradient():
    from pytensor_tpu_torch.gradient import GradientError, grad_scale

    P = PKGS[1]
    with pytest.raises(GradientError):
        P.verify_grad(lambda x: P.pt.sin(grad_scale(x, 2.0)).sum(), [np.arange(3.0)],
                      rng=np.random.default_rng(1))


@pytest.mark.parametrize("P", PKGS, ids=lambda P: P.name)
def test_inconsistent_broadcast_error(P):
    x = P.pt.tensor("x", dtype="float64", shape=(None, None, None))
    y = P.scan(fn=lambda x_, prev_x: x_ + prev_x, sequences=x,
               outputs_info=[dict(initial=P.pt.constant(np.zeros((1, 10))))],
               return_updates=False)
    with pytest.raises(TypeError):
        P.grad(y.sum(), x)


@pytest.mark.parametrize("P", PKGS, ids=lambda P: P.name)
def test_gradient_graphs_build(P):
    """Cases of the JAX package that only build the gradient: a mit-sot
    and sit-sot's second derivative, multi-tap states, and every Scan's
    ``connection_pattern`` in the graph of a gradient of a gradient."""
    pt = P.pt
    inputs = [_dmat(P, "m"), _dvec(P, "v")]

    def inner(m2, m1, s):
        out = (m2 + m1 + s) ** 1.05
        return out, out

    outs = P.scan(fn=inner, outputs_info=[dict(initial=inputs[0], taps=[-2, -1]), inputs[1]],
                  n_steps=5, return_updates=False)
    gs = [P.grad(outs[0].sum(), inputs[0]), P.grad(outs[1].sum(), inputs[1])]
    gg = P.grad(sum(g.sum() for g in gs), inputs[0])
    seen = 0
    graph = __import__(f"{P.ptt.__name__}.graph.traversal", fromlist=["ancestors"])
    for v in graph.ancestors([gg]):
        if v.owner is not None and type(v.owner.op).__name__ == "Scan":
            pat = v.owner.op.connection_pattern(v.owner)
            assert len(pat) == len(v.owner.inputs) and not any(pat[0])
            seen += 1
    assert seen >= 3
    a0 = P.shared(np.arange(2, dtype="float64"))
    a = P.scan(lambda a_m2, a_m1: a_m1, outputs_info=[{"initial": a0, "taps": [-2, -1]}],
               n_steps=2, return_updates=False)
    P.grad(a[-1], a0)
    m, v = _dmat(P, "m"), _dvec(P, "v")
    [_u, m2] = P.scan(lambda _, u: [u, v], sequences=m,
                      outputs_info=[pt.zeros((7,), dtype="float64"), None], return_updates=False)
    P.grad((m * m2).sum(), v)


# --- K2 eligibility of a gradient's scans -----------------------------------------------------

def _pallas_bptt(P):
    pt = P.pt
    v0 = pt.tensor("v0", dtype="float32", shape=(4,))
    W = pt.as_tensor_variable((np.eye(4) * 0.9 + 0.05).astype("float32"))
    tr, _ = P.scan(lambda acc: pt.tanh(pt.dot(W, acc)), outputs_info=[v0], n_steps=6)
    return [v0], P.grad(tr[-1].sum(), v0), [_rng().standard_normal(4).astype("float32")]


def _eligibility(P, f):
    rule = scan_kernel_eligible if P.torch else pallas_scan_eligible
    fg = f.maker.fgraph if hasattr(f, "maker") else f.fgraph
    return {n.op.name or "scan": rule(n.op, n) for n in fg.toposort() if type(n.op).__name__ == "Scan"}


def test_pallas_bptt_matches_the_loop_and_k2_takes_the_forward_scan_only():
    """``tests/test_scan.py:779``: under ``scan__pallas`` a gradient's
    forward scan is eligible for the whole-loop kernel and its reverse
    scan, whose sequences have unknown length after the flip, is not, in
    both packages; the values match the step loop's."""
    decisions, values = {}, {}
    for P in PKGS:
        for pallas in (False, True):
            with P.config.change_flags(scan__pallas=pallas):
                inputs, outputs, vals = _pallas_bptt(P)
                f = P.function(inputs, outputs)
                decisions[P.name, pallas] = _eligibility(P, f)
                values[P.name, pallas] = _np(f(*vals))
    assert decisions["torch", True] == decisions["jax", True] == {"scan": True,
                                                                   "grad_of_scan": False}
    for k, v in values.items():
        _close(v, values["jax", False], str(k))

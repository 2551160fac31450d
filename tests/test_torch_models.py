"""The logistic-regression, MLP, Elman RNN, GP, Kalman-filter and
batched-Cholesky models of the port against the JAX package's, on the CPU
at small widths.

For the logistic-regression SGD step (``function`` and a 3-step
``train_loop``), the 2-layer MLP step, the deep MLP "MFU" step (float32),
the GEMM chain and the Elman BPTT step (``function`` and a 3-step
``train_loop``, whose scans sit inside the loop's scan; each scan's
inner graph counted in, nested ones too, and the Elman gradients against
``rnn_reference``, float64 NumPy): the rewritten graphs hold the JAX
package's ops, a
``Counter`` of op names with each FusedElemwise group by its inner ops,
``Dot22Scalar`` and the scans' inner graphs included; the values match
after 3 steps (losses and updated shared variables); and each linked plan
reads nothing back from the device (``Plan.host_reads`` is empty), so on
a card each is one CUDA graph.  The linalg models (GP at n 32, the Kalman
filter over 16 steps, the batched Cholesky at batch 4, n 8) also against
float64 NumPy, each tolerance stated in its test.  Tolerance: float32
``rtol 1e-5`` over ``max(1, |value|)``: XLA and torch sum the products of a matmul and a
mean in other orders, and the MFU step's ramps are float32 ``sin``s.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import pytensor_tpu.models.gp as jgp
import pytensor_tpu.models.kalman as jkalman
import pytensor_tpu.models.logreg as jlogreg
import pytensor_tpu.models.mlp as jmlp
import pytensor_tpu.models.rnn as jrnn
from pytensor_tpu.config import config as jconfig
from pytensor_tpu.link.pallas.scan_pallas import pallas_scan_eligible

import pytensor_tpu_torch as ptt
import pytensor_tpu_torch.models.gp as tgp
import pytensor_tpu_torch.models.kalman as tkalman
import pytensor_tpu_torch.models.logreg as tlogreg
import pytensor_tpu_torch.models.mlp as tmlp
import pytensor_tpu_torch.models.rnn as trnn
from pytensor_tpu_torch.config import config as tconfig
from pytensor_tpu_torch.link.cuda.scan_kernel import scan_kernel_eligible

RTOL = 1e-5


def _np(v):
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, what=""):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and str(got.dtype) == str(want.dtype), what
    scale = np.maximum(1.0, np.abs(want.astype("float64")))
    err = np.abs(got.astype("float64") - want.astype("float64")) / scale
    assert float(err.max(initial=0.0)) <= RTOL, (what, float(err.max()))


def _ops(fgraph):
    """Op names, each FusedElemwise by its inner ops, each scan's inner
    graph counted in."""
    c = Counter()
    for node in fgraph.apply_nodes:
        name = type(node.op).__name__
        c[str(node.op) if name == "FusedElemwise" else name] += 1
        inner = getattr(node.op, "fgraph", None)
        if name == "Scan":
            c.update(f"Scan/{k}" for k in _ops(inner).elements())
    return c


def _fgraph(f):
    return f.maker.fgraph if hasattr(f, "maker") else f.fgraph


def _same_graphs(jf, tf):
    assert _ops(_fgraph(tf)) == _ops(_fgraph(jf))
    assert tf.linked.host_reads == []


@pytest.mark.parametrize("steps", [1, 3], ids=["function", "train_loop"])
def test_logreg_step(steps):
    jf, (X, y), (jw, jb) = jlogreg.make_logreg_training_step(n=64, d=8, n_steps_per_call=steps)
    tf, (X2, y2), (tw, tb) = tlogreg.make_logreg_training_step(n=64, d=8, n_steps_per_call=steps,
                                                              device="cpu")
    np.testing.assert_array_equal(X, X2)
    _same_graphs(jf, tf)
    for k in range(3):
        _close(tf(X, y), jf(X, y), f"loss {k}")
    _close(tw.get_value(), jw.get_value(), "w")
    _close(tb.get_value(), jb.get_value(), "b")


def test_logreg_graphs():
    (ji, jo, jv), (ti, to, tv) = (m.make_logreg_graphs(n=32, d=4) for m in (jlogreg, tlogreg))
    for a, b in zip(jv, tv):
        np.testing.assert_array_equal(a, b)
    assert [o.type.shape for o in jo] == [o.type.shape for o in to]


def test_mlp_training_step():
    jf, (X, y), jparams = jmlp.make_mlp_training_step(n=32, d=6, h=10)
    tf, _, tparams = tmlp.make_mlp_training_step(n=32, d=6, h=10, device="cpu")
    _same_graphs(jf, tf)
    assert _ops(_fgraph(tf))["Dot22Scalar"] == 2
    for k in range(3):
        _close(tf(X, y), jf(X, y), f"loss {k}")
    for j, t in zip(jparams, tparams):
        _close(t.get_value(), j.get_value(), str(t))


@pytest.mark.parametrize("steps", [1, 3], ids=["function", "train_loop"])
def test_mlp_mfu_step(steps):
    jf, jflops, (jX, jT) = jmlp.make_mlp_mfu_step(batch=16, d=8, depth=2, dtype="float32",
                                                  n_steps_per_call=steps)
    tf, tflops, (tX, tT) = tmlp.make_mlp_mfu_step(batch=16, d=8, depth=2, dtype="float32",
                                                  n_steps_per_call=steps, device="cpu")
    assert jflops == tflops == 2 * 3 * 2 * 16 * 8 * 8
    _close(tX, jX, "X ramp")
    _close(tT, jT, "T ramp")
    _same_graphs(jf, tf)
    # each loss reads the weights the steps before it left
    for k in range(3):
        _close(tf(tX, tT), jf(jX, jT), f"loss {k}")


def test_mlp_mfu_gradients_and_update():
    """The MFU step's gradients (its graph linked with them as outputs) and
    one step's update against the float64 NumPy step (``mlp_mfu_reference``,
    on the run's sides of relu's kink): each gradient to RTOL of its
    layer's max|ref|, each weight beyond half a float32 ulp to RTOL of its
    layer's largest update (which a dropped update would miss by O(1))."""
    X, T, Ws, acts, loss, grads, _, (Xd, Td) = tmlp.mlp_mfu_graph(64, 32, 2, "float32",
                                                                  device="cpu")
    out = ptt.function([X, T], [loss, *grads, *acts], device="cpu")(Xd, Td)
    init = [_np(W.get_value()) for W in Ws]
    masks = [_np(a) >= 0 for a in out[3:]]
    losses, after, r_grads = tmlp.mlp_mfu_reference(_np(Xd), _np(Td), init, 1e-3, 1, masks)
    assert abs(float(out[0]) - losses[0]) <= RTOL * losses[0]
    for g, r in zip(out[1:3], r_grads):
        assert np.abs(_np(g) - r).max() <= RTOL * np.abs(r).max()
    f, _, (Xs, Ts) = tmlp.make_mlp_mfu_step(64, 32, 2, "float32", device="cpu")
    f(Xs, Ts)
    stepped = [_np(v.get_value()) for v in sorted(f.shared_vars, key=lambda v: v.name)]
    for a, r, x in zip(stepped, after[0], init):
        rounding = 0.5 * np.spacing(np.maximum(np.abs(a), np.abs(r)).astype("float32"))
        beyond = np.abs(a - r) - rounding
        assert beyond.max() <= RTOL * np.abs(r - x).max()
        assert (np.abs(x - r) - rounding).max() > 0.1 * np.abs(r - x).max()



def test_mlp_mfu_reference_in_torch_is_the_numpy_steps():
    """``mlp_mfu_reference(..., device=)``, the float64 steps as torch ops
    (what ``chip_smoke.py`` phase 11 runs on the card), gives the NumPy
    steps' losses, weights and first gradients, on the run's sides of
    relu's kink, within float64 rounding (1e-12 of each array's largest)."""
    X, T, Ws, acts, loss, grads, _, (Xd, Td) = tmlp.mlp_mfu_graph(64, 32, 3, "float32",
                                                                  device="cpu")
    out = ptt.function([X, T], [loss, *grads, *acts], device="cpu")(Xd, Td)
    init = [_np(W.get_value()) for W in Ws]
    masks = [_np(a) >= 0 for a in out[4:]]
    want = tmlp.mlp_mfu_reference(_np(Xd), _np(Td), init, 1e-3, 3, masks)
    got = tmlp.mlp_mfu_reference(Xd, Td, [W.get_value() for W in Ws], 1e-3, 3, masks,
                                 device="cpu")
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12)
    for g, w in zip([*sum(got[1], []), *got[2]], [*sum(want[1], []), *want[2]]):
        assert isinstance(g, np.ndarray) and g.dtype == np.float64
        assert np.abs(g - w).max() <= 1e-12 * np.abs(w).max()

def test_mlp_mfu_step_bfloat16():
    """The MFU step at its default dtype, bfloat16 (batch 16, d 8, depth 2):
    bfloat16 weights, a float32 loss, each step's loss within ``1e-6`` of
    the float64 step that rounds where the graph rounds, from the same
    weights, and the unrounded float64 step's within bfloat16's rounding
    (``tests/test_torch_bfloat16.py`` holds it against the JAX package)."""
    f, flops, (X, T) = tmlp.make_mlp_mfu_step(batch=16, d=8, depth=2, lr=0.5, device="cpu")
    assert flops == 2 * 3 * 2 * 16 * 8 * 8
    Ws = sorted(f.shared_vars, key=lambda v: v.name)
    assert X.dtype == T.dtype == torch.bfloat16
    assert all(w.get_value().dtype == torch.bfloat16 for w in Ws)
    for _ in range(2):
        before = [w.get_value() for w in Ws]
        loss = f(X, T)
        assert loss.dtype == torch.float32
        ref, _, _ = tmlp.mlp_mfu_reference(X, T, before, 0.5, 1, bf16=True)
        assert abs(float(loss) - ref[0]) <= 1e-6 * ref[0]
        ref, _, _ = tmlp.mlp_mfu_reference(X, T, before, 0.5, 1)
        assert abs(float(loss) - ref[0]) <= 2.0 ** -6 * ref[0]


def test_gemm_chain():
    jf, jflops = jmlp.make_gemm_chain(batch=16, d=8, nmat=2, dtype="float32", n_steps_per_call=3)
    tf, tflops = tmlp.make_gemm_chain(batch=16, d=8, nmat=2, dtype="float32", n_steps_per_call=3,
                                      device="cpu")
    assert jflops == tflops
    _same_graphs(jf, tf)
    for k in range(3):
        _close(tf(), jf(), f"scale {k}")


# --- the Elman RNN BPTT step (models/rnn.py) -----------------------------------------

ELMAN = dict(seq_len=8, n_in=4, n_hidden=8)


def _deep_ops(fgraph, path=""):
    """Op names by the path of scans they sit in, nested scans included;
    a Blockwise by its core op, a FusedElemwise by its inner ops."""
    c = Counter()
    for node in fgraph.apply_nodes:
        op = node.op
        name = type(op).__name__
        key = {"FusedElemwise": str(op), "Elemwise": str(op),
               "Blockwise": f"Blockwise{{{type(getattr(op, 'core_op', op)).__name__}}}"}
        c[path + key.get(name, name)] += 1
        if name == "Scan":
            c.update(_deep_ops(op.fgraph, f"{path}Scan[{op.name}]/"))
    return c


def _batch3(X, y):
    return np.ascontiguousarray(X[:, :3]), np.ascontiguousarray(y[:3])


@pytest.mark.parametrize("steps", [1, 3], ids=["function", "train_loop"])
def test_elman_step(steps):
    """The Elman step and its 3-step loop: the JAX package's ops in the
    outer graph and in every scan's inner graph (the step: 4 FusedElemwise
    groups, 3 Blockwise{Dot} the push-out made, the forward scan's Gemm and
    the reverse scan's; the loop: 6 scans inside the loop's, with Dot and
    no push-out there), the same losses and weights after 3 calls at batch
    3, and nothing read back from the device."""
    jf, (X, y), jw = jrnn.make_elman_rnn_bptt(n_steps_per_call=steps, **ELMAN)
    tf, (X2, y2), tw = trnn.make_elman_rnn_bptt(n_steps_per_call=steps, device="cpu", **ELMAN)
    np.testing.assert_array_equal(X, X2)
    ops = _deep_ops(_fgraph(tf))
    assert ops == _deep_ops(_fgraph(jf))
    if steps == 1:
        assert ops["Blockwise{Dot}"] == 3 and ops["Scan"] == 2
        assert sum(v for k, v in ops.items() if k.startswith("FusedElemwise")) == 4
    else:
        assert ops["Scan[elman_loop]/Scan"] == 6 and not ops["Blockwise{Dot}"]
    assert tf.linked.host_reads == []
    X, y = _batch3(X, y)
    for k in range(3):
        _close(tf(X, y), jf(X, y), f"loss {k}")
    for j, t in zip(jw, tw):
        _close(t.get_value(), j.get_value(), str(t))


def test_elman_gradients_against_rnn_reference():
    """The step's loss and gradients (its graph linked with them as
    outputs), one step's and three steps' updates against the float64
    NumPy BPTT of ``rnn_reference``: the loss and each gradient to RTOL of
    the gradient's max|ref|, each weight to RTOL of its largest update,
    which a dropped update would miss by O(1)."""
    X, y, W, loss, grads, _, (Xv, yv), _ = trnn.elman_graph(device="cpu", **ELMAN)
    W0 = [_np(w.get_value()).copy() for w in W]
    out = ptt.function([X, y], [loss, *grads], device="cpu")(Xv, yv)
    losses, r_grads, after = trnn.rnn_reference(Xv, yv, *W0, 0.01, 3)
    assert abs(float(out[0]) - losses[0]) <= RTOL * losses[0]
    for g, r in zip(out[1:], r_grads):
        assert np.abs(_np(g) - r).max() <= RTOL * np.abs(r).max()
    f, _, tw = trnn.make_elman_rnn_bptt(device="cpu", **ELMAN)
    for _ in range(3):
        f(Xv, yv)
    for w, r, x in zip(tw, after[-1], W0):
        assert np.abs(_np(w.get_value()) - r).max() <= RTOL * np.abs(r - x).max()


def test_elman_scans_take_the_step_loop_in_both():
    """Under ``scan__pallas`` neither package sends the Elman scans to the
    whole-loop kernel: their sequences and carries have unknown dims
    (``(8, 4, ?)`` after the push-out, with a static batch of 4)."""
    decisions = []
    for (make, rule, config, kw) in ((jrnn.make_elman_rnn_bptt, pallas_scan_eligible, jconfig, {}),
                                     (trnn.make_elman_rnn_bptt, scan_kernel_eligible, tconfig,
                                      {"device": "cpu"})):
        with config.change_flags(scan__pallas=True):
            f, _, _ = make(**ELMAN, **kw)
        decisions.append({n.op.name: rule(n.op, n) for n in _fgraph(f).apply_nodes
                          if type(n.op).__name__ == "Scan"})
    assert decisions[0] == decisions[1] == {"elman": False, "grad_of_elman": False}


def test_elman_step_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises((RuntimeError, AssertionError)):
        trnn.make_elman_rnn_bptt(**ELMAN)


# --- the linalg paths: the GP, the Kalman filter, the batched Cholesky ---------------

def _linalg_pair(path):
    from test_torch_linalg_rewrites import _functions

    return _functions("jax")[path](), _functions("torch")[path]()


@pytest.mark.parametrize("steps", [1, 3], ids=["function", "train_loop"])
def test_gp_sgd_step(steps):
    """The GP SGD step (n 32, float32) and its 3-step loop: the JAX
    package's values after 3 calls (each nmll and the hyperparameters), and
    the float64 NumPy SGD of ``gp_reference`` (closed-form gradient): the
    first nmll to RTOL, the hyperparameters after all the steps to RTOL of
    the largest update (a dropped update reads 1)."""
    jf, jp = jgp.make_gp_sgd_step(n=32, dtype="float32", n_steps_per_call=steps)
    tf, tp = tgp.make_gp_sgd_step(n=32, dtype="float32", n_steps_per_call=steps, device="cpu")
    assert tf.linked.host_reads == []
    nmlls = [tf() for _ in range(3)]
    for k, got in enumerate(nmlls):
        _close(got, jf(), f"nmll {k}")
    for j, t in zip(jp, tp):
        _close(t.get_value(), j.get_value(), t.name)
    X, y = tgp.gp_data(32, 3, "float32")
    ref_nmll, _, thetas = tgp.gp_reference(X, y, np.zeros(3), 1e-3, 3 * steps)
    if steps == 1:
        assert abs(float(nmlls[0]) - ref_nmll[0]) <= RTOL * ref_nmll[0]
    got = np.array([float(_np(p.get_value())) for p in tp])
    assert np.abs(got - thetas[-1]).max() <= RTOL * np.abs(thetas[-1]).max()


def test_gp_marginal_likelihood_float64():
    """The float64 nmll and its gradient against the JAX package's and
    against ``gp_reference``, within 1e-12 and 1e-10 relative."""
    jf, theta = jgp.make_gp_marginal_likelihood(n=32)
    tf, _ = tgp.make_gp_marginal_likelihood(n=32, device="cpu")
    got, want = [_np(v) for v in tf(*theta)], [_np(v) for v in jf(*theta)]
    assert [g.dtype for g in got] == [w.dtype for w in want] == [np.float64] * 4
    np.testing.assert_allclose(got, want, rtol=1e-12)
    nmll, grads, _ = tgp.gp_reference(*tgp.gp_data(32, 3, "float64"), np.zeros(3))
    np.testing.assert_allclose(got, [nmll[0], *grads[0]], rtol=1e-10)


def test_kalman_loglike_and_grad():
    """16 steps, k 4, p 2, float32: the log-likelihood is float64 on the
    float32 data in both packages; the outputs against the JAX package's
    (RTOL), against ``numpy_kalman_loglike`` (float64; 1e-6, the filter's
    float32 rounding) and the gradient against central differences of it
    (1e-4 of max|g|)."""
    jf, theta, (ys, Z) = jkalman.make_kalman_loglike_and_grad(16, dtype="float32")
    tf, theta2, (ys2, Z2) = tkalman.make_kalman_loglike_and_grad(16, dtype="float32",
                                                                 device="cpu")
    np.testing.assert_array_equal(ys, ys2)
    assert tf.linked.host_reads == []
    got, want = tf(*theta), jf(*theta)
    for k, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"output {k}")
    T, lq, lh = (np.asarray(v, "float64") for v in theta)
    ll = tkalman.numpy_kalman_loglike(ys.astype("float64"), T, Z.astype("float64"),
                                      np.exp(lq), np.exp(lh))
    assert abs(float(got[0]) - ll) <= 1e-6 * abs(ll)
    for g, r in zip(got[1:], tkalman.numpy_kalman_grad(ys, T, Z, lq, lh)):
        assert np.abs(_np(g) - r).max() <= 1e-4 * max(1.0, np.abs(r).max())


@pytest.mark.parametrize("path", ["kalman step", "kalman loop", "chol step", "chol loop"])
def test_kalman_and_batched_cholesky_steps(path):
    """The Kalman SGD step of ``benchsuite.py:1129`` (16 steps, shared T)
    and the batched Cholesky step of ``benchsuite.py:978`` (batch 4, n 8),
    each with its 3-step loop: the JAX package's outputs after 3 calls and
    its state (RTOL)."""
    jf, tf = _linalg_pair(path)
    for k in range(3):
        _close(tf(), jf(), f"{path} {k}")
    jstate = {v.name: v.get_value() for v in jf.maker.fgraph.inputs if hasattr(v, "get_value")}
    tstate = {v.name: v.get_value() for v in tf.shared_vars}
    assert set(jstate) == set(tstate)
    for name, v in tstate.items():
        _close(v, jstate[name], name)


def test_batched_cholesky_against_numpy():
    """The loss, ``sum(L ** 2)``, is the sum of the traces of A; L against
    float64 NumPy over max|L| and the gradient against the identity, to
    RTOL."""
    from pytensor_tpu_torch.models import batched_cholesky as tbc

    f, A = tbc.make_batched_cholesky_step(4, 8, device="cpu")
    A0 = tbc.spd_stack(4, 8).astype("float64")
    loss = float(f())
    assert abs(loss - np.trace(A0, axis1=1, axis2=2).sum()) <= RTOL * loss
    A.set_value(tbc.spd_stack(4, 8))
    L = ptt.tensor.linalg.cholesky(A)
    L_v, g_v = ptt.function([], [L, ptt.grad(ptt.tensor.sum(L ** 2), A)], device="cpu")()
    ref = np.linalg.cholesky(A0)
    assert np.abs(_np(L_v) - ref).max() <= RTOL * np.abs(ref).max()
    assert np.abs(_np(g_v) - np.eye(8)).max() <= RTOL


def test_linalg_makers_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from pytensor_tpu_torch.models import batched_cholesky as tbc

    for make in (lambda: tgp.make_gp_sgd_step(8), lambda: tgp.make_gp_marginal_likelihood(8),
                 lambda: tkalman.make_kalman_loglike_and_grad(4),
                 lambda: tkalman.make_kalman_sgd_step(4), lambda: tbc.make_batched_cholesky_step(2, 3)):
        with pytest.raises((RuntimeError, AssertionError)):
            make()

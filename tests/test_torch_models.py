"""The logistic-regression, MLP and Elman RNN models of the port against
the JAX package's, on the CPU at small widths.

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
a card each is one CUDA graph.  Tolerance: float32 ``rtol 1e-5`` over
``max(1, |value|)``: XLA and torch sum the products of a matmul and a
mean in other orders, and the MFU step's ramps are float32 ``sin``s.
"""

from collections import Counter

import numpy as np
import pytest
import torch

import pytensor_tpu.models.logreg as jlogreg
import pytensor_tpu.models.mlp as jmlp
import pytensor_tpu.models.rnn as jrnn
from pytensor_tpu.config import config as jconfig
from pytensor_tpu.link.pallas.scan_pallas import pallas_scan_eligible

import pytensor_tpu_torch as ptt
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


def test_mlp_mfu_step_refuses_bfloat16():
    with pytest.raises(NotImplementedError, match="bfloat16"):
        tmlp.make_mlp_mfu_step(batch=4, d=4, depth=1, device="cpu")


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

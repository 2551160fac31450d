"""The logistic-regression and MLP models of the port against the JAX
package's, on the CPU at small widths.

For the logistic-regression SGD step (``function`` and a 3-step
``train_loop``), the 2-layer MLP step, the deep MLP "MFU" step (float32)
and the GEMM chain: the rewritten graphs hold the JAX package's ops, a
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

import pytensor_tpu_torch as ptt
import pytensor_tpu_torch.models.logreg as tlogreg
import pytensor_tpu_torch.models.mlp as tmlp

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

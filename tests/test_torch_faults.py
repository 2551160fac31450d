"""Five faults once found in the port, each held against the JAX package.

The same numpy inputs go through ``function()`` of both packages on the
CPU (FAST_RUN in both), and the port must give what the JAX package gives:

1. an output never shares memory with a shared variable, so a later
   update by another function does not change it in the caller's hands,
   while an output that shares memory with nothing is not copied;
2. and 3. ``sqr`` and ``abs`` of a bool tensor are bool, alone and fused;
4. ``sigmoid`` of an integer tensor builds a graph and is refused with a
   ``TypeError`` when its function is built or run;
5. ``grad(sum(sqrt(sqr(x))), x)`` rewrites to ``sign(x)`` op for op, so
   it is finite at 0 and keeps the sign of -0.0.

Values are compared exactly (bools, signs of zero) or at ``rtol 1e-12``.
"""

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt

JAX = (jptt, jpt, {})
PORT = (tptt, tpt, {"device": "cpu"})


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("view", ["whole", "slice"])
def test_outputs_do_not_alias_shared_variables_across_functions(view):
    """``function([], x)`` and ``function([], x[1:])`` return what the
    shared variable held when they ran, after a third function updates
    it."""
    held = []
    for ptt, pt, kw in (JAX, PORT):
        x = ptt.shared(np.zeros(3), name="x", **kw)
        read = ptt.function([], x if view == "whole" else x[1:], **kw)
        bump = ptt.function([], [], updates={x: x + 1.0}, **kw)
        before = read()
        bump()
        held.append((_np(before), _np(read()), _np(x.get_value())))
    (j_before, j_after, j_x), (t_before, t_after, t_x) = held
    np.testing.assert_array_equal(j_before, np.zeros(3 if view == "whole" else 2))
    for t, j in ((t_before, j_before), (t_after, j_after), (t_x, j_x)):
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t, j)


def test_only_outputs_that_alias_a_shared_variable_are_copied(monkeypatch):
    """Of ``[x, x * 2, y + 1]`` only ``x`` is copied: one clone a call."""
    x = tptt.shared(np.arange(3.0), name="x", device="cpu")
    y = tpt.tensor("y", dtype="float64", shape=(3,))
    f = tptt.function([y], [x, x * 2.0, y + 1.0], device="cpu")
    clones = []
    clone = torch.Tensor.clone

    def counted(self, *args, **kwargs):
        clones.append(self)
        return clone(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "clone", counted)
    out = f(torch.ones(3, dtype=torch.float64))
    assert len(clones) == 1
    shared_ptr = x.get_value(borrow=True).untyped_storage().data_ptr()
    assert out[0].untyped_storage().data_ptr() != shared_ptr
    np.testing.assert_array_equal(out[0].numpy(), [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(out[2].numpy(), [2.0, 2.0, 2.0])


# name -> the inputs used, and the graph over the bool vectors b, c
_BOOL_GRAPHS = {
    "sqr": (1, lambda pt, b, c: pt.sqr(b)),
    "abs": (1, lambda pt, b, c: pt.abs(b)),
    "fused": (2, lambda pt, b, c: pt.sqr(b) * c + pt.abs(c)),
}


@pytest.mark.parametrize("name", sorted(_BOOL_GRAPHS))
def test_sqr_and_abs_of_bool_are_bool_like_jax(name):
    n_in, build = _BOOL_GRAPHS[name]
    vals = list(np.random.default_rng(5).integers(0, 2, size=(2, 7)).astype(bool))[:n_in]
    outs = []
    for ptt, pt, kw in (JAX, PORT):
        b = pt.tensor("b", dtype="bool", shape=(7,))
        c = pt.tensor("c", dtype="bool", shape=(7,))
        y = build(pt, b, c)
        assert y.type.dtype == "bool"
        outs.append(_np(ptt.function([b, c][:n_in], y, **kw)(*vals)))
    j, t = outs
    assert j.dtype == t.dtype == np.bool_
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("graph", ["alone", "fused"])
def test_sigmoid_of_integers_is_refused_like_jax(graph):
    vals = np.array([1, -2, 3], dtype="int32")
    for ptt, pt, kw in (JAX, PORT):
        i = pt.tensor("i", dtype="int32", shape=(3,))
        y = pt.sigmoid(i) if graph == "alone" else pt.sigmoid(i) * 2.0 + 1.0
        assert y.type.dtype == "float64"  # the graph itself builds
        with pytest.raises(TypeError, match="int32"):
            ptt.function([i], y, **kw)(vals)
    # on floats it runs, and agrees
    outs = []
    for ptt, pt, kw in (JAX, PORT):
        x = pt.tensor("x", dtype="float64", shape=(3,))
        f = ptt.function([x], pt.sigmoid(x) * 2.0 + 1.0, **kw)
        outs.append(_np(f(vals.astype("float64"))))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_grad_of_sqrt_sqr_is_sign_like_jax(dtype):
    vals = np.array([0.0, -0.0, 2.0, -3.0], dtype=dtype)
    graphs, outs = [], []
    for ptt, pt, kw in (JAX, PORT):
        x = pt.tensor("x", dtype=dtype, shape=(4,))
        f = ptt.function([x], ptt.grad(pt.sum(pt.sqrt(pt.sqr(x))), x), **kw)
        graphs.append([str(nd.op) for nd in f.fgraph.toposort()])
        outs.append(_np(f(vals)))
    assert graphs[1] == graphs[0] == ["Elemwise{sign}"]
    j, t = outs
    assert t.dtype == j.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, [0.0, 0.0, 1.0, -1.0])
    np.testing.assert_array_equal(np.signbit(t), [False, True, False, True])
    np.testing.assert_array_equal(np.signbit(t), np.signbit(j))

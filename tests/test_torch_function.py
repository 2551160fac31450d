"""The port's ``function()`` against the JAX package's, on the CPU.

``givens``, ``updates`` on shared variables (written in place into the
shared tensor), ``trust_input``, a scan that reads and updates shared
variables, and the device rule: a function is linked for one explicit
device, and an input or a shared tensor on another device raises.  The
``meta`` device stands in for a second device here.  Float64 values are
compared exactly up to ``rtol 1e-12``.
"""

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.compile.maker import UnusedInputError

RTOL = 1e-12


def test_givens_match_jax():
    vals = np.linspace(-1.0, 1.0, 5)
    outs = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        x = pt.tensor("x", dtype="float64", shape=(5,))
        y = pt.tensor("y", dtype="float64", shape=(5,))
        f = ptt.function([x], pt.exp(x) * y, givens={y: x * 2.0 + 1.0}, **kw)
        outs.append(np.asarray(f(vals)))
    np.testing.assert_allclose(outs[1], outs[0], rtol=RTOL)
    np.testing.assert_allclose(outs[1], np.exp(vals) * (vals * 2 + 1), rtol=RTOL)


def test_updates_write_the_shared_tensor_in_place():
    start = np.arange(3.0)
    j_acc = jptt.shared(start.copy(), name="acc")
    t_acc = tptt.shared(start.copy(), name="acc", device="cpu")
    held = t_acc.get_value(borrow=True)
    ptr = held.data_ptr()
    fs = []
    for ptt, pt, acc, kw in ((jptt, jpt, j_acc, {}), (tptt, tpt, t_acc, {"device": "cpu"})):
        x = pt.tensor("x", dtype="float64", shape=(3,))
        fs.append(ptt.function([x], [acc * 1.0, acc.sum()], updates={acc: acc + x}, **kw))
    for step in range(3):
        x = np.full(3, float(step + 1))
        j_out = [np.asarray(o) for o in fs[0](x)]
        t_out = [o.numpy() for o in fs[1](x)]
        for a, b in zip(t_out, j_out):
            np.testing.assert_allclose(a, b, rtol=RTOL)
        np.testing.assert_allclose(t_acc.get_value().numpy(), j_acc.get_value(), rtol=RTOL)
    # the update went into the tensor the caller holds
    assert t_acc.get_value(borrow=True) is held and held.data_ptr() == ptr
    np.testing.assert_allclose(held.numpy(), start + 6.0)


def test_outputs_and_swapped_updates_read_the_old_values():
    """An output that is a view of an updated shared tensor, and a swap of
    two shared variables, see the values from before the call."""
    a = tptt.shared(np.array([1.0, 2.0]), name="a", device="cpu")
    b = tptt.shared(np.array([3.0, 4.0]), name="b", device="cpu")
    f = tptt.function([], [a, b[::-1]], updates={a: b, b: a}, device="cpu")
    out_a, out_b = f()
    np.testing.assert_array_equal(out_a.numpy(), [1.0, 2.0])
    np.testing.assert_array_equal(out_b.numpy(), [4.0, 3.0])
    np.testing.assert_array_equal(a.get_value().numpy(), [3.0, 4.0])
    np.testing.assert_array_equal(b.get_value().numpy(), [1.0, 2.0])


def test_scan_with_shared_variables_matches_jax():
    """A scan whose step reads one shared variable and updates another:
    the updates ``scan`` returns go through ``function``."""
    outs = {}
    for pkg, ptt, pt, kw in (("jax", jptt, jpt, {}), ("torch", tptt, tpt, {"device": "cpu"})):
        w = ptt.shared(np.array([0.5, -0.25]), name="w", **kw)
        count = ptt.shared(np.array([0.0, 0.0]), name="count", **kw)
        x = pt.tensor("x", dtype="float64", shape=(2,))
        tr, upd = ptt.scan(lambda acc: (acc * w + 1.0, {count: count + acc}),
                           outputs_info=[x], n_steps=4)
        f = ptt.function([x], tr, updates=upd, **kw)
        first = f(np.array([1.0, 2.0]))
        second = f(np.array([1.0, 2.0]))
        outs[pkg] = [np.asarray(first) if pkg == "jax" else first.numpy(),
                     np.asarray(second) if pkg == "jax" else second.numpy(),
                     np.asarray(count.get_value()) if pkg == "jax" else count.get_value().numpy()]
    for a, b in zip(outs["torch"], outs["jax"]):
        np.testing.assert_allclose(a, b, rtol=RTOL)


def test_trust_input_takes_tensors_as_they_are():
    x = tpt.tensor("x", dtype="float32", shape=(4,))
    f = tptt.function([x], x * np.float32(3.0), trust_input=True, device="cpu")
    np.testing.assert_array_equal(f(torch.ones(4)).numpy(), [3.0] * 4)


def test_wrong_device_raises():
    x = tpt.tensor("x", dtype="float32", shape=(4,))
    f = tptt.function([x], x + np.float32(1.0), device="cpu")
    with pytest.raises(ValueError, match="meta"):
        f(torch.empty(4, device="meta"))
    s = tptt.shared(np.zeros(4, "float32"), name="s", device="meta")
    with pytest.raises(ValueError, match="meta"):
        tptt.function([x], x + s, device="cpu")
    if not torch.cuda.is_available():
        # the port never falls back to the CPU when CUDA is missing
        with pytest.raises(RuntimeError, match="cuda"):
            tptt.function([x], x, device="cuda")


def test_unused_input_and_shared_input_raise():
    x = tpt.tensor("x", dtype="float32", shape=(4,))
    y = tpt.tensor("y", dtype="float32", shape=(4,))
    with pytest.raises(UnusedInputError):
        tptt.function([x, y], x * np.float32(2.0), device="cpu")
    s = tptt.shared(np.zeros(4, "float32"), name="s", device="cpu")
    with pytest.raises(TypeError, match="implicit"):
        tptt.function([s], s * np.float32(2.0), device="cpu")

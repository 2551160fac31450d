"""The cases of ``tests/test_ref_link_xla.py`` whose ops the port has, run
through the port's linker on the CPU.

Each case builds the same graph in both packages and holds the port's
``function`` (the torch lowerings of ``link/torch/dispatch.py``) to the JAX
package's numpy oracle (``mode="FAST_COMPILE"``) and to its XLA path, as
``compare_xla_and_py`` holds the XLA path to the oracle: same shapes and
dtypes, ``rtol 1e-6``, ``atol 1e-8``.  Where the JAX package compiles a
dynamic shape as a static argument (a reshape, an arange bound, a slice
bound or split sizes fed by an input), the port reads the value on the
host.  Left out: the cases of ops the port has not yet (ifelse,
CheckAndRaise, sort, einsum, Blockwise, softmax, the special functions,
extra_ops, pad) and of OpFromGraph as a user op.
"""

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt

floatX = "float64"
PKGS = ((jptt, jpt), (tptt, tpt))


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _compare(build, values, rtol=1e-6, atol=1e-8):
    """``build(ptt, pt) -> (inputs, outputs)`` in both packages; the port
    against the oracle and the XLA path.  Returns the port's outputs."""
    res = {}
    for ptt, pt in PKGS:
        inputs, outputs = build(ptt, pt)
        if pt is jpt:
            res["py"] = ptt.function(inputs, outputs, mode="FAST_COMPILE",
                                     on_unused_input="ignore")(*values)
            res["xla"] = ptt.function(inputs, outputs, on_unused_input="ignore")(*values)
        else:
            res["torch"] = ptt.function(inputs, outputs, device="cpu")(*values)
    for ref in ("py", "xla"):
        for g, w in zip(res["torch"], res[ref]):
            g, w = _np(g), _np(w)
            assert g.shape == w.shape, (ref, g.shape, w.shape)
            assert str(g.dtype) == str(w.dtype), (ref, g.dtype, w.dtype)
            np.testing.assert_allclose(g, w, rtol=rtol, atol=atol)
    return res["torch"]


def _mod(pt, name):
    from importlib import import_module

    return import_module(pt.__name__.rsplit(".", 1)[0] + "." + name)


# --- math / blas ------------------------------------------------------------------

def test_max_and_argmax():
    def build(ptt, pt):
        m = _mod(pt, "tensor.math")
        x = pt.dvector("x")
        return [x], [m.Max([0])(x) * m.Argmax([0])(x)]

    _compare(build, [np.r_[1.0, 2.0]])


def test_dot_chain():
    def build(ptt, pt):
        y, x = pt.dvector("y"), pt.dvector("x")
        A, alpha, beta = pt.dmatrix("A"), pt.dscalar("alpha"), pt.dscalar("beta")
        return [y, x, A, alpha, beta], [y.dot(alpha * A).dot(x) + beta * y]

    _compare(build, [np.r_[1.0, 2.0], np.r_[3.0, 4.0], np.asarray([[1.0, 2.0], [3.0, 4.0]]),
                     np.array(3.0), np.array(5.0)])


def test_maximum_and_reduce_max():
    def build(ptt, pt):
        y, x = pt.dvector("y"), pt.dvector("x")
        return [y, x], [pt.maximum(y, x), pt.max(y)]

    _compare(build, [np.r_[1.0, 2.0], np.r_[3.0, 0.0]])


def test_batched_dot():
    av = np.linspace(-1, 1, 10 * 5 * 3).astype(floatX).reshape((10, 5, 3))
    bv = np.linspace(1, -1, 10 * 3 * 2).astype(floatX).reshape((10, 3, 2))

    def build(ptt, pt):
        a, b = pt.tensor3("a", dtype=floatX), pt.tensor3("b", dtype=floatX)
        return [a, b], [_mod(pt, "tensor.blas").BatchedDot()(a, b)]

    _compare(build, [av, bv])
    a, b = tpt.tensor3("a", dtype=floatX), tpt.tensor3("b", dtype=floatX)
    f = tptt.function([a, b], _mod(tpt, "tensor.blas").BatchedDot()(a, b), device="cpu")
    with pytest.raises(Exception):
        f(av[:-1], bv)


# --- elemwise ---------------------------------------------------------------------

def test_dimshuffle():
    v = np.c_[[1.0, 2.0], [3.0, 4.0]]

    def build(ptt, pt):
        a = pt.dmatrix("a")
        return [a], [a.T, a.dimshuffle([0, 1, "x"])]

    _compare(build, [v])

    def build_b(ptt, pt):
        b = pt.tensor(dtype=floatX, shape=(None, 1), name="b")
        return [b], [b.dimshuffle((0,))]

    _compare(build_b, [np.c_[[1.0, 2.0, 3.0, 4.0]]])


def test_careduce():
    mv = np.c_[[1.0, 2.0, 3.0], [1.0, 2.0, 3.0]]

    def build(ptt, pt):
        m = pt.dmatrix("m")
        return [m], [pt.sum(m), pt.sum(m, axis=0), pt.sum(m, axis=1), pt.prod(m, axis=0),
                     pt.all(m), pt.any(m, axis=1), pt.min(m, axis=1)]

    _compare(build, [mv])


def test_multiple_input_multiply():
    def build(ptt, pt):
        x, y, z = pt.dvectors("xyz")
        return [x, y, z], [pt.mul(x, y, z)]

    _compare(build, [np.r_[1.5], np.r_[2.5], np.r_[3.5]])


@pytest.mark.parametrize("op", ["add", "mul"])
def test_variadic_broadcast(op):
    rng = np.random.default_rng(213234)
    vals = [rng.normal(size=s) for s in [(3, 4), (1, 4), (3, 1)]]

    def build(ptt, pt):
        x = pt.tensor("x", shape=(3, 4), dtype=floatX)
        y = pt.tensor("y", shape=(1, 4), dtype=floatX)
        z = pt.tensor("z", shape=(3, 1), dtype=floatX)
        out = getattr(pt, op)(x, y, z)
        assert len(out.owner.inputs) == 3
        return [x, y, z], [out]

    _compare(build, vals)


@pytest.mark.parametrize("dtype", ["bool", "int8"])
def test_variadic_add_dtype(dtype):
    vals = (np.array([True, False, True]) if dtype == "bool"
            else np.array([1, 2, 3], dtype=dtype))

    def build(ptt, pt):
        xs = [pt.tensor(k, shape=(3,), dtype=dtype) for k in "xyz"]
        return xs, [pt.add(*xs)]

    _compare(build, [vals, vals, vals])


# --- shape ------------------------------------------------------------------------

def test_shape_ops():
    x_np = np.zeros((20, 3))

    def build(ptt, pt):
        s = _mod(pt, "tensor.shape")
        c = pt.as_tensor_variable(x_np)
        return [], [s.Shape()(c), s.Shape_i(1)(c)]

    _compare(build, [])


def test_specify_shape():
    def build(ptt, pt):
        a, b, shp = pt.dmatrix("a"), pt.dmatrix("b"), pt.dmatrix("shape")
        return [a, b, shp], [pt.specify_shape(a, (4, None)), pt.specify_shape(b, shp.shape)]

    _compare(build, [np.ones((4, 5)), np.ones((4, 5)), np.ones((4, 5))])


def test_reshape_forms():
    def build(ptt, pt):
        a = pt.dvector("a")
        return [a], [pt.reshape(a, (2, 2)), pt.reshape(a, a.shape),
                     pt.reshape(a, (a.shape[0] // 2, a.shape[0] // 2))]

    _compare(build, [np.r_[1.0, 2.0, 3.0, 4.0]])


def test_reshape_shape_graph_input():
    """The JAX package compiles the shape input as a static argument; the
    port reads it on the host (and does not capture the plan)."""
    def build(ptt, pt):
        a, b = pt.dvector("a"), pt.iscalar("b")
        return [a, b], [pt.reshape(a, (b, b))]

    _compare(build, [np.r_[1.0, 2.0, 3.0, 4.0], np.array(2, dtype="int32")])


def test_compile_ops():
    def build(ptt, pt):
        ops = _mod(pt, "compile.ops")
        return [], [ops.DeepCopyOp()(pt.as_tensor_variable(1.1)),
                    ops.ViewOp()(pt.as_tensor_variable(np.zeros((20, 1, 1))))]

    _compare(build, [])


# --- tensor basics ------------------------------------------------------------------

def test_alloc():
    def build(ptt, pt):
        a, av = pt.dscalar("a"), pt.dvector("av")
        return [a, av], [pt.alloc(0.0, 2, 3), pt.alloc(1.1, 2, 3), pt.alloc(a, 20),
                         pt.alloc(av, 20, 10)]

    res = _compare(build, [np.array(10.0), np.ones(10)])
    assert tuple(res[0].shape) == (2, 3)


def test_alloc_empty():
    x = _mod(tpt, "tensor.basic").AllocEmpty("float32")(2, 3)
    r = tptt.function([], x, device="cpu")()
    assert tuple(r.shape) == (2, 3) and r.dtype == torch.float32


def test_make_vector_and_arange():
    def build(ptt, pt):
        x = pt.dvector("x")
        return [x], [pt.make_vector(1, 2, 3), pt.arange(1, 10, 2), pt.arange(1, x.shape[-1], 2),
                     pt.arange(x.shape[-1])]

    res = _compare(build, [np.zeros(200)])
    assert int(res[-1][-1]) == 199


def test_arange_nonconcrete_compiles():
    """The bound is an input: read on the host at each call."""
    a = tpt.iscalar("a")
    f = tptt.function([a], tpt.arange(a), device="cpu")
    np.testing.assert_array_equal(f(np.int32(4)).numpy(), np.arange(4))
    np.testing.assert_array_equal(f(np.int32(7)).numpy(), np.arange(7))


def test_join():
    def build(ptt, pt):
        a, b = pt.dmatrix("a"), pt.dmatrix("b")
        return [a, b], [pt.join(0, a, b)]

    _compare(build, [np.c_[[1.0, 2.0, 3.0]], np.c_[[4.0, 5.0, 6.0]]])
    _compare(build, [np.c_[[1.0, 2.0, 3.0]], np.c_[[4.0, 5.0]]])

    def build1(ptt, pt):
        a, b = pt.dmatrix("a"), pt.dmatrix("b")
        return [a, b], [pt.join(1, a, b)]

    _compare(build1, [np.c_[[1.0, 2.0, 3.0]], np.c_[[4.0, 5.0, 6.0]]])
    _compare(build1, [np.c_[[1.0, 2.0], [3.0, 4.0]], np.c_[[5.0, 6.0]]])


def test_split_basic():
    def build(ptt, pt):
        a = pt.dmatrix("a")
        a2 = pt.matrix("a2", shape=(6, None), dtype=floatX)
        return [a, a2], [*pt.split(a, splits_size=[1, 2, 3], n_splits=3, axis=0),
                         *pt.split(a2, splits_size=[2, a2.shape[0] - 2], n_splits=2, axis=0),
                         *pt.split(a2, splits_size=[2, a2.shape[1] - 2], n_splits=2, axis=1)]

    _compare(build, [np.zeros((6, 4)), np.arange(24.0).reshape(6, 4)])


def test_split_runtime_errors():
    a = tpt.dmatrix("a")
    with pytest.raises(ValueError):
        tpt.split(a, splits_size=[2, 2, 2], n_splits=2, axis=0)
    f = tptt.function([a], tpt.split(a, splits_size=[2, 4], n_splits=2, axis=0), device="cpu")
    with pytest.raises(ValueError):
        f(np.zeros((7, 4)))


def test_eye_tri():
    def build(ptt, pt):
        return [], [pt.eye(3), pt.tri(10, 10, 0), pt.eye(3, 5, -1)]

    _compare(build, [])


# --- subtensor ------------------------------------------------------------------------

SHAPE = (3, 4, 5)
X_NP = np.arange(np.prod(SHAPE)).reshape(SHAPE)


def test_subtensor_constant():
    mask = np.random.default_rng(0).binomial(1, 0.5, size=SHAPE).astype(bool)

    def build(ptt, pt):
        x = pt.tensor("x", shape=SHAPE, dtype="int64")
        adv1 = _mod(pt, "tensor.subtensor").advanced_subtensor1
        return [x], [x[1, 2, 0], x[1:, 1, :], x[:2, 1, :], x[1:2, 1, :], x[::-1],
                     adv1(x, [1, 2]), x[[1, 2], [2, 3]], x[[1, 2], :], x[[1, 2], :, [3, 4]],
                     x[mask]]

    _compare(build, [X_NP])


def test_subtensor_dynamic_bound():
    a = tpt.iscalar("a")
    f = tptt.function([a], tpt.arange(3)[:a], device="cpu")
    np.testing.assert_array_equal(f(np.int32(1)).numpy(), [0])
    np.testing.assert_array_equal(f(np.int32(3)).numpy(), [0, 1, 2])


def test_dynamic_boolean_mask_raises():
    x = tpt.vector("x", dtype="float64")
    with pytest.raises(NotImplementedError):
        tptt.function([x], x[x < 0], device="cpu")(np.arange(-5.0, 5.0))


def test_inc_subtensor_basic():
    def build(ptt, pt):
        s = _mod(pt, "tensor.subtensor")
        x = pt.tensor("x", shape=SHAPE, dtype=floatX)
        st = pt.as_tensor_variable(np.array(-10.0, dtype=floatX))
        stv = pt.as_tensor_variable(np.r_[-1.0, 0.0].astype(floatX))
        out = s.set_subtensor(x[1, 2, 3], st)
        assert isinstance(out.owner.op, s.IncSubtensor)
        return [x], [out, s.set_subtensor(x[:2, 0, 0], stv), s.set_subtensor(x[0, 1:3, 0], stv),
                     s.inc_subtensor(x[1, 2, 3], st), s.inc_subtensor(x[:2, 0, 0], stv)]

    _compare(build, [np.arange(60).reshape(SHAPE).astype(floatX)])


def test_inc_subtensor_advanced():
    rng = np.random.default_rng(213234)
    x_np = rng.uniform(-1, 1, size=SHAPE).astype(floatX)
    st3_np = rng.uniform(-1, 1, size=(2, 4, 5)).astype(floatX)

    def build(ptt, pt):
        s = _mod(pt, "tensor.subtensor")
        x = pt.tensor("x", shape=SHAPE, dtype=floatX)
        st3 = pt.as_tensor_variable(st3_np)
        stv = pt.as_tensor_variable(np.r_[-1.0, 0.0].astype(floatX))
        mask = pt.constant(x_np > 0)
        stm = pt.as_tensor_variable(x_np[[0, 2], 0, :3])
        return [x], [s.set_subtensor(x[np.r_[0, 2]], st3), s.set_subtensor(x[[0, 2], 0, 0], stv),
                    s.set_subtensor(x[mask], 0.0), s.inc_subtensor(x[np.r_[0, 2]], st3),
                    s.inc_subtensor(x[[0, 2], 0, 0], stv), s.set_subtensor(x[mask], 1.0),
                    s.set_subtensor(x[[0, 2], 0, :3], stm), s.inc_subtensor(x[[0, 2], 0, :3], stm),
                    s.inc_subtensor(x[[0, 0, 2], :, [1, 1, 4]], x[0, :, 0])]

    _compare(build, [np.arange(60).reshape(SHAPE).astype(floatX)])


@pytest.mark.parametrize("mode", ["inc", "set"])
def test_advanced_inc_subtensor1_runtime_broadcast(mode):
    s = _mod(tpt, "tensor.subtensor")
    func = {"inc": s.advanced_inc_subtensor1, "set": s.advanced_set_subtensor1}[mode]
    y = tpt.matrix("y", dtype="float64")
    f = tptt.function([y], func(tpt.zeros((10, 5)), y, np.repeat(np.arange(10), 2)),
                      device="cpu")
    f(np.ones((20, 5)))
    for bad in (np.ones((1, 5)), np.ones((20, 1))):
        with pytest.raises(ValueError, match="[Rr]untime broadcast"):
            f(bad)


# --- scalars ------------------------------------------------------------------------------

def test_second_and_identity():
    def build(ptt, pt):
        ps = _mod(pt, "scalar.basic")
        ew = _mod(pt, "tensor.elemwise").Elemwise
        a0, b, a1 = pt.dscalar("a0"), pt.dscalar("b"), pt.dvector("a1")
        a2 = pt.matrix("a2", shape=(1, None), dtype="float64")
        b2 = pt.matrix("b2", shape=(None, 1), dtype="int32")
        return [a0, b, a1, a2, b2], [pt.second(a0, b), pt.second(a1, b), pt.second(a2, b2),
                                     ew(ps.identity)(a0)]

    _compare(build, [np.array(10.0), np.array(5.0), np.zeros(5), np.zeros((1, 3)),
                     np.ones((5, 1), dtype="int32")])


def test_sigmoid_and_variadic_scalar_mix():
    def build(ptt, pt):
        x, mu, tau = pt.dvector("x"), pt.dvector("mu"), pt.dvector("tau")
        return [x, mu, tau], [pt.sigmoid(x), -tau * mu, -tau * (tau - mu) ** 2]

    _compare(build, [np.r_[1.0, 2.0], np.r_[0.1, 1.1], np.r_[1.0, 2.0]])


@pytest.mark.parametrize("expr", ["add", "mul", "div", "mod"])
def test_scalar_shape_arith(expr):
    def build(ptt, pt):
        x = pt.dmatrix("x")
        s0, s1 = x.shape[0], x.shape[1]
        size = {"add": s0 + s0 + s1, "mul": s0 * s0 * s1, "div": s0 // s1, "mod": s0 % s1}[expr]
        return [x], [pt.ones(size)]

    _compare(build, [np.ones((12, 3))])


def test_multioutput():
    def build(ptt, pt):
        x, y = pt.dvector("x"), pt.dvector("y")
        return [x, y], [pt.cosh(x ** 2 + y / 3.0), pt.cosh(x / 3.0 + y ** 2)]

    _compare(build, [np.r_[1.0, 2.0], np.r_[3.0, 4.0]])


def test_logp_switch_graph():
    def build(ptt, pt):
        mu, tau, sigma, value = (pt.dvector(k) for k in ("mu", "tau", "sigma", "value"))
        logp = (-tau * (value - mu) ** 2 + pt.log(tau / np.pi / 2.0)) / 2.0
        alltrue = pt.all(pt.all(1 * (sigma > 0)))
        return [mu, tau, sigma, value], [pt.switch(alltrue, logp, -np.inf)]

    _compare(build, [np.r_[0.0, 0.0], np.r_[1.0, 1.0], np.r_[1.0, 1.0], np.r_[0.1, -10.0]])


def test_one_element_host_values_beside_device_tensors():
    """A one-element value computed on the host (the length of a batch,
    cast, broadcast to (1,)) meets a tensor on another device: ``second``
    fills it on that device, any other Elemwise takes it as a scalar; the
    ``meta`` device stands in for the card here."""
    from pytensor_tpu_torch.link.torch.dispatch import elemwise_fn

    y = tpt.tensor("y", dtype="float32", shape=(None,))
    h = tpt.tensor("h", dtype="float32", shape=(1,))
    host = torch.tensor([0.25])
    for out in (tpt.second(y, h), y * h, h - y):
        res = elemwise_fn(out.owner)(torch.empty(256, device="meta"), host) \
            if out.owner.inputs[0] is y else \
            elemwise_fn(out.owner)(host, torch.empty(256, device="meta"))
        assert res.device.type == "meta" and tuple(res.shape) == (256,)
    res = elemwise_fn(tpt.second(y, h).owner)(torch.zeros(3), host)
    assert torch.equal(res, torch.full((3,), 0.25))

"""Forward mode in the port against the JAX package: ``pushforward`` (the
double pullback), its aliases ``Rop`` and ``pushforward_through_pullback``,
``Lop``, ``subgraph_grad``, ``as_list_or_tuple`` and the ops' ``R_op``.

Each graph is built in both packages on the same seeded numpy inputs (the
JAX package with its defaults, the port on the CPU, both ``FAST_RUN``
unless a case says otherwise) and the values held at ``rtol 1e-12`` in
float64 (the RNN scan's Jvps, sums of products in another order, at
``1e-10``; the radon Hessian-vector product at ``1e-10`` of ``max|ref|``).
The cases are the JAX package's ``tests/test_grad.py:105-125``,
``tests/test_gradient_utils.py:70-80``, ``tests/test_ref_scan2.py:672``
(the Jvp of an RNN scan against the scan of gradients) and
``tests/test_scan.py:517``, each ported ``R_op`` (``Dot`` in its four rank
pairs, ``DimShuffle``, ``Elemwise``, ``MatrixInverse``, ``OpFromGraph``
and ``ZeroGrad``), and the radon model's Hessian-vector product at 40/5
against the JAX package's, against ``hessian_vector_product`` and against
central differences of ``dlogp``.
"""

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.gradient as jgrad
import pytensor_tpu.tensor as jpt
import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.gradient as tgrad
import pytensor_tpu_torch.tensor as tpt

PKGS = {"jax": (jptt, jpt, jgrad, {}), "torch": (tptt, tpt, tgrad, {"device": "cpu"})}


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def both(build, *values, mode=None):
    """The values of ``build(ptt, pt, G)``'s ``(inputs, outputs)`` in each
    package, ``{"jax": [...], "torch": [...]}``."""
    out = {}
    for name, (ptt, pt, G, kw) in PKGS.items():
        inputs, outputs = build(ptt, pt, G)
        f = ptt.function(inputs, outputs, mode=mode, on_unused_input="ignore", **kw)
        res = f(*values)
        out[name] = [_np(r) for r in (res if isinstance(res, (list, tuple)) else [res])]
    return out


def held(res, rtol=1e-12):
    for g, w in zip(res["torch"], res["jax"], strict=True):
        assert g.shape == w.shape and g.dtype == w.dtype, (g.shape, w.shape, g.dtype, w.dtype)
        np.testing.assert_allclose(g, w, rtol=rtol, atol=0)


rng = np.random.default_rng(11)


@pytest.mark.parametrize("mode", ["FAST_COMPILE", "FAST_RUN"])
def test_hessian_vector_product_and_rop(mode):
    """``tests/test_grad.py:105-125``."""
    def hvp(ptt, pt, G):
        x, p = pt.dvector("x"), pt.dvector("p")
        return [x, p], G.hessian_vector_product((x ** 3).sum(), x, p)

    res = both(hvp, np.array([1.0, 2.0]), np.array([1.0, 1.0]), mode=mode)
    held(res)
    np.testing.assert_allclose(res["torch"][0], [6.0, 12.0])

    def rop(ptt, pt, G):
        x, v = pt.dvector("x"), pt.dvector("v")
        return [x, v], ptt.Rop((x ** 2).sum(), x, v)

    res = both(rop, np.array([1.0, 2.0]), np.array([1.0, 0.0]), mode=mode)
    held(res)
    assert float(res["torch"][0]) == 2.0


def test_gradient_utils():
    """``tests/test_gradient_utils.py:70-80``."""
    for G in (jgrad, tgrad):
        assert G.as_list_or_tuple(True, False, 3) == [3]
        assert G.as_list_or_tuple(False, True, 3) == (3,)
        assert G.as_list_or_tuple(False, False, 3) == 3
        assert G.as_list_or_tuple(True, False, (1, 2)) == [1, 2]
        with pytest.raises(ValueError):
            G.as_list_or_tuple(True, True, 3)
        assert G.pushforward_through_pullback is G.pushforward
    assert tptt.Rop is not None and tptt.Lop is not None


def test_lop_is_pullback():
    def build(ptt, pt, G):
        x, v = pt.dvector("x"), pt.dvector("v")
        return [x, v], [G.Lop(pt.tanh(x) * 2.0, x, v), G.pullback(pt.tanh(x) * 2.0, x, v)]

    res = both(build, rng.standard_normal(5), rng.standard_normal(5))
    held(res)
    np.testing.assert_array_equal(*res["torch"])


def test_pushforward_through_an_rnn_scan():
    """``tests/test_ref_scan2.py:672``: the Jvp of the last state of an RNN
    scan with respect to each input equals the scan of the gradients'
    projections, in both packages (float64)."""
    lrng = np.random.default_rng(31)
    vals = [lrng.uniform(size=s) for s in ((8, 5), (5,), (5, 5), (8, 5), (5,), (5, 5))]

    def build(ptt, pt, G):
        from importlib import import_module

        shape = import_module(pt.__name__ + ".shape")
        u, h0, W = pt.dmatrix("U"), pt.dvector("h0"), pt.dmatrix("W")
        _u = shape.specify_shape(u, (8, 5))
        _h0 = shape.specify_shape(h0, (5,))
        _W = shape.specify_shape(W, (5, 5))
        o = ptt.scan(lambda _ut, _y, _Wm: pt.tanh(pt.dot(_Wm, _ut + _y)), sequences=_u,
                     outputs_info=_h0, non_sequences=_W, name="rnn_fn",
                     return_updates=False)[-1]
        eu, eh0, eW = pt.dmatrix("eu"), pt.dvector("eh0"), pt.dmatrix("eW")
        pf = [G.pushforward(o, _u, eu), G.pushforward(o, _h0, eh0), G.pushforward(o, _W, eW)]

        def ref(wrt, e):
            return ptt.scan(lambda i, o_, w_, e_: (ptt.grad(o_[i], w_) * e_).sum(),
                            sequences=pt.arange(o.shape[0]), non_sequences=[o, wrt, e],
                            return_updates=False)

        return [u, h0, W, eu, eh0, eW], pf + [ref(_u, eu), ref(_h0, eh0), ref(_W, eW)]

    res = both(build, *vals)
    held(res, rtol=1e-10)  # a scan of products: summed in other orders
    for k in range(3):
        np.testing.assert_allclose(res["torch"][k], res["torch"][k + 3], atol=1e-12)


def test_rop_through_scan():
    """``tests/test_scan.py:517``: the Jvp of a running sum's squares,
    under ``FAST_COMPILE``, against the gradient's projection."""
    def build(ptt, pt, G):
        x, v = pt.dvector("x"), pt.dvector("v")
        tr, _ = ptt.scan(lambda xt, acc: acc * np.float64(0.9) + xt ** 2, sequences=[x],
                         outputs_info=[pt.constant(np.float64(0.5))])
        y = (tr ** 2).sum()
        return [x, v], [G.pushforward([y], [x], [v])[0], (ptt.grad(y, x) * v).sum()]

    res = both(build, np.array([0.3, 0.5, 0.2]), np.array([1.0, -0.5, 2.0]),
               mode="FAST_COMPILE")
    held(res)
    np.testing.assert_allclose(*res["torch"], rtol=1e-12)


# --- each ported R_op ------------------------------------------------------------

def _rop_case(kind):
    """``(build, values)``: the op's ``R_op`` called on the graph's
    inputs and tangents, and the inputs' values."""
    if kind.startswith("dot"):
        shapes = {"dot vv": ((4,), (4,)), "dot mv": ((3, 4), (4,)),
                  "dot vm": ((3,), (3, 4)), "dot mm": ((3, 4), (4, 2))}[kind]

        def build(ptt, pt, G):
            xs = [pt.tensor(f"x{k}", dtype="float64", shape=(None,) * len(s))
                  for k, s in enumerate(shapes)]
            es = [pt.tensor(f"e{k}", dtype="float64", shape=(None,) * len(s))
                  for k, s in enumerate(shapes)]
            node = pt.dot(*xs).owner
            return xs + es, [node.op.R_op(xs, es)[0], node.op.R_op(xs, [es[0], None])[0]]

        return build, [rng.standard_normal(s) for s in shapes * 2]
    if kind == "dimshuffle":
        def build(ptt, pt, G):
            x, e = pt.dmatrix("x"), pt.dmatrix("e")
            node = x.dimshuffle(1, "x", 0).owner
            return [x, e], node.op.R_op([x], [e])

        return build, [rng.standard_normal((3, 4)), rng.standard_normal((3, 4))]
    if kind == "elemwise":
        def build(ptt, pt, G):
            x, y, ex, ey = pt.dvector("x"), pt.dvector("y"), pt.dvector("ex"), pt.dvector("ey")
            node = (pt.exp(x) * pt.log(y)).owner
            both_t = node.op.R_op(node.inputs, [ex, ey])
            node2 = pt.arctan2(x, y).owner
            return [x, y, ex, ey], both_t + node2.op.R_op([x, y], [ex, None])

        return build, [rng.standard_normal(5), rng.uniform(1, 2, 5), rng.standard_normal(5),
                       rng.standard_normal(5)]
    if kind == "matrix_inverse":
        def build(ptt, pt, G):
            from importlib import import_module

            linalg = import_module(pt.__name__ + ".linalg")
            x, e = pt.dmatrix("x"), pt.dmatrix("e")
            node = linalg.matrix_inverse(x).owner
            return [x, e], node.op.R_op([x], [e])

        a = rng.standard_normal((4, 4)) + 4 * np.eye(4)
        return build, [a, rng.standard_normal((4, 4))]
    if kind == "opfromgraph":
        def build(ptt, pt, G):
            a, b = pt.dvector("a"), pt.dvector("b")
            op = ptt.OpFromGraph([a, b], [pt.tanh(a * b).sum(), a * 2.0])
            x, y, ex, ey = pt.dvector("x"), pt.dvector("y"), pt.dvector("ex"), pt.dvector("ey")
            return [x, y, ex, ey], op.R_op([x, y], [ex, ey])

        return build, [rng.standard_normal(4) for _ in range(4)]
    if kind == "zero_grad":
        def build(ptt, pt, G):
            x, e = pt.dvector("x"), pt.dvector("e")
            node = G.zero_grad(x).owner
            assert node.op.R_op([x], [e]) == [None]
            return [x, e], [G.pushforward(G.zero_grad(x) * x, x, e)]

        return build, [rng.standard_normal(3), rng.standard_normal(3)]
    raise KeyError(kind)


ROP_KINDS = ["dot vv", "dot mv", "dot vm", "dot mm", "dimshuffle", "elemwise",
             "matrix_inverse", "opfromgraph", "zero_grad"]


@pytest.mark.parametrize("kind", ROP_KINDS)
def test_each_ported_r_op(kind):
    build, values = _rop_case(kind)
    held(both(build, *values))


def test_the_default_r_op_raises():
    from pytensor_tpu.graph.op import Op as JOp
    from pytensor_tpu_torch.graph.op import Op as TOp

    for Op in (JOp, TOp):
        with pytest.raises(NotImplementedError):
            Op().R_op([], [])


def test_subgraph_grad():
    """The gradient chained in two pieces through ``subgraph_grad`` equals
    the whole gradient, in both packages."""
    def build(ptt, pt, G):
        x, w1, w2 = pt.dvector("x"), pt.dvector("w1"), pt.dvector("w2")
        h = pt.tanh(x * w1)
        cost = pt.sum((h * w2) ** 2)
        g2, (gh,) = G.subgraph_grad(wrt=[w2], end=[h], cost=cost)
        g1, _ = G.subgraph_grad(wrt=[w1], end=[x], start={h: gh})
        whole = ptt.grad(cost, [w1, w2])
        details = G.subgraph_grad(wrt=[w2], end=[h], cost=cost, details=True)
        return [x, w1, w2], [g1[0], g2[0], *whole, details[3][0]]

    res = both(build, *(rng.standard_normal(4) for _ in range(3)))
    held(res)
    np.testing.assert_allclose(res["torch"][0], res["torch"][2], rtol=1e-12)
    for G in (jgrad, tgrad):
        with pytest.raises(ValueError):
            G.subgraph_grad(wrt=[], end=[])


def test_radon_hessian_vector_product():
    """``pushforward(dlogp, theta, v)`` at 40/5 in float64: the JAX
    package's value at ``1e-10`` of ``max|ref|``, the reverse-over-reverse
    product and central differences of ``dlogp``; under ``FAST_RUN`` the
    port's graph reads no dummy cotangent (``theta`` and ``v`` are its only
    inputs) and fuses its elementwise chains."""
    from pytensor_tpu.models.radon import make_radon_graphs as jgraphs
    from pytensor_tpu_torch.models.radon import make_radon_graphs as tgraphs
    from pytensor_tpu_torch.models.radon import theta_start

    n = 9
    th = theta_start(n, "float64") + 0.1 * np.random.default_rng(5).standard_normal(n)
    v = np.random.default_rng(6).standard_normal(n)
    vals = {}
    for name, graphs in (("jax", jgraphs), ("torch", tgraphs)):
        ptt, pt, G, kw = PKGS[name]
        (theta,), (logp, dlogp), _ = graphs(40, 5, "float64")
        vv = pt.dvector("v")
        hvp = G.pushforward(dlogp, theta, vv)
        rr = G.hessian_vector_product(logp, theta, vv)
        f = ptt.function([theta, vv], [hvp, rr], **kw)
        vals[name] = [_np(r) for r in f(th, v)]
        if name == "torch":
            assert len(f.fgraph.inputs) == 2
            assert any(type(nd.op).__name__ == "FusedElemwise" for nd in f.fgraph.apply_nodes)
            d = ptt.function([theta], dlogp, **kw)
            h = 1e-5
            fd = (_np(d(th + h * v)) - _np(d(th - h * v))) / (2 * h)
    scale = np.abs(vals["jax"][0]).max()
    np.testing.assert_allclose(vals["torch"][0], vals["jax"][0], atol=1e-10 * scale, rtol=0)
    np.testing.assert_allclose(vals["torch"][0], vals["torch"][1], atol=1e-10 * scale, rtol=0)
    np.testing.assert_allclose(vals["torch"][0], fd, atol=1e-6 * scale, rtol=0)

"""Blockwise, vectorize_graph, jacobian and hessian in the port against
the JAX package, on the CPU.

The batched-matmul case of ``tests/test_op_grids_blockwise.py`` (the
others batch ``tensor/linalg.py``, which the port has not yet: ROADMAP.md
Queue 1 item 9) over more batch layouts and with its gradient; each
batching rule of ``tensor/blockwise.py`` through ``vectorize_graph``; the
``Blockwise`` fallback of an op without a rule; ``jacobian``, ``hessian``
and ``hessian_vector_product``.  Each output's static type must be the
JAX package's, ``None`` for ``None`` (the scan kernel's eligibility reads
them), the rewritten graphs must hold the same ops, and the values must
agree at ``rtol 1e-10`` (float64; sums in other orders).
"""

from collections import Counter

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
from pytensor_tpu.graph.replace import vectorize_graph as jvectorize_graph
from pytensor_tpu.gradient import hessian_vector_product as jhvp

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.graph.replace import vectorize_graph as tvectorize_graph
from pytensor_tpu_torch.gradient import hessian_vector_product as thvp
from pytensor_tpu_torch.tensor.blockwise import Blockwise

PKGS = {"jax": (jptt, jpt, jvectorize_graph, jhvp), "torch": (tptt, tpt, tvectorize_graph, thvp)}


def _np(v):
    return v.detach().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _ops(fgraph):
    c = Counter()
    for node in fgraph.apply_nodes:
        op = node.op
        name = type(op).__name__
        c[f"Blockwise{{{type(op.core_op).__name__}}}" if name == "Blockwise" else name] += 1
    return c


def _both(build, values):
    """Build in both packages, compile, run; hold the static types, the
    ops and the values of the port to the JAX package's."""
    res = {}
    for pkg, (ptt, pt, vec, hvp) in PKGS.items():
        inputs, outputs = build(ptt, pt, vec, hvp)
        outputs = outputs if isinstance(outputs, list) else [outputs]
        kw = {"device": "cpu"} if pkg == "torch" else {}
        f = ptt.function(inputs, outputs, **kw)
        fg = f.maker.fgraph if hasattr(f, "maker") else f.fgraph
        res[pkg] = ([o.type for o in outputs], _ops(fg), [_np(v) for v in f(*values)])
    (jt, jops, jv), (tt, tops, tv) = res["jax"], res["torch"]
    assert [(t.dtype, t.shape) for t in tt] == [(t.dtype, t.shape) for t in jt]
    assert tops == jops
    for a, b in zip(tv, jv):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_allclose(a, b, rtol=1e-10, atol=1e-12)
    return tv, tops


def _t(pt, name, shape):
    return pt.tensor(name, dtype="float64", shape=shape)


rng = np.random.default_rng(17)

MATMULS = [((5, 1, 3, 4), (2, 4, 2)), ((2, 3, 4), (4, 5)), ((3, 4), (2, 4, 5)),
           ((1, 3, 4), (2, 4, 5)), ((4,), (2, 4, 5)), ((2, 3, 4), (4,)),
           ((None, 3, 4), (None, 4, 2))]


@pytest.mark.parametrize("sa,sb", MATMULS, ids=[f"{a}@{b}" for a, b in MATMULS])
def test_batched_matmul(sa, sb):
    """``tests/test_op_grids_blockwise.py:140``: ``matmul`` above 2-d is a
    ``Blockwise{Dot}`` whose batch dimensions broadcast; one batched
    operand becomes one core product (``local_batched_matmul_to_core_
    matmul``).  The gradient batches the core gradient."""
    va = rng.standard_normal(tuple(2 if s is None else s for s in sa))
    vb = rng.standard_normal(tuple(2 if s is None else s for s in sb))

    def build(ptt, pt, vec, hvp):
        a, b = _t(pt, "a", sa), _t(pt, "b", sb)
        out = pt.matmul(a, b)
        return [a, b], [out, *ptt.grad((out ** 2).sum(), [a, b])]

    (got, *_), _ = _both(build, [va, vb])
    np.testing.assert_allclose(got, va @ vb, rtol=1e-10)


def test_blockwise_static_types_and_infer_shape():
    """The output types of ``Blockwise{Dot}`` are the JAX package's, ``None``
    for ``None``: a pushed-out Elman product over ``(64, 4, 32)`` and
    ``(1, ?, ?)`` is ``(64, 4, ?)`` in both."""
    from pytensor_tpu.tensor.blockwise import Blockwise as JBlockwise
    from pytensor_tpu.tensor.math import _dot as jdot
    from pytensor_tpu_torch.tensor.math import _dot as tdot

    shapes = [((64, 4, 32), (1, None, None)), ((64, None, 32), (1, 32, 128)),
              ((3, 1, 2, 5), (1, 7, 5, 4)), ((None, 2, 5), (5, None))]
    for sa, sb in shapes:
        types = []
        for pt, B, dot in ((jpt, JBlockwise, jdot), (tpt, Blockwise, tdot)):
            out = B(dot, signature="(m,k),(k,n)->(m,n)")(_t(pt, "a", sa), _t(pt, "b", sb))
            types.append((out.type.dtype, out.type.shape))
            node = out.owner
            assert node.op.node_batch_ndim(node) == out.type.ndim - 2
        assert types[0] == types[1], (sa, sb, types)
    a, b = _t(tpt, "a", (3, 2, 5)), _t(tpt, "b", (5, 4))
    node = Blockwise(tdot, signature="(m,k),(k,n)->(m,n)")(a, b).owner
    (shape,) = node.op.infer_shape(None, node, [(3, 2, 5), (1, 5, 4)])
    assert [int(tpt.get_scalar_constant_value(s)) if not isinstance(s, int) else s
            for s in shape] == [3, 2, 4]


def test_parse_signature():
    from pytensor_tpu.tensor.blockwise import parse_signature as jparse
    from pytensor_tpu_torch.tensor.blockwise import parse_signature as tparse

    for sig in ("(m,k),(k,n)->(m,n)", "(n),(n)->()", "(),(i)->(i),()", "(n,n)->(n),(n,n)"):
        assert tparse(sig) == jparse(sig)


VECTORIZE = {
    "elemwise": (lambda pt, x: pt.exp(x) * 2.0 + x, (3,), (4, 3)),
    "elemwise_broadcast": (lambda pt, x: x + pt.as_tensor_variable(np.arange(3.0)), (3,), (2, 3)),
    "dimshuffle": (lambda pt, x: x.dimshuffle("x", 1, 0), (2, 3), (4, 2, 3)),
    "careduce": (lambda pt, x: x.sum(axis=0) + x.max(axis=-1).sum(), (2, 3), (4, 2, 3)),
    "subtensor": (lambda pt, x: x[1:, ::-1][0], (3, 4), (2, 3, 4)),
    "reshape": (lambda pt, x: x.reshape((2, 6)), (3, 4), (5, 3, 4)),
    "shape_i": (lambda pt, x: x * pt.cast(x.shape[1], "float64"), (3, 4), (2, 3, 4)),
    "shape": (lambda pt, x: pt.cast(x.shape, "float64").sum() + x, (3, 4), (2, 3, 4)),
    "fallback_dot": (lambda pt, x: pt.dot(x, pt.as_tensor_variable(np.ones((3, 2)))),
                     (4, 3), (5, 4, 3)),
    "fallback_argmax": (lambda pt, x: pt.argmax(x, axis=0), (4, 3), (2, 4, 3)),
}


@pytest.mark.parametrize("name", sorted(VECTORIZE))
def test_vectorize_graph(name):
    """Each batching rule of ``tensor/blockwise.py`` (and the Blockwise
    fallback of an op with none) gives the JAX package's graph, types and
    values, which equal the core graph applied row by row."""
    fn, core, batched = VECTORIZE[name]
    xv = rng.standard_normal(batched)

    def build(ptt, pt, vec, hvp):
        x = _t(pt, "x", core)
        xb = _t(pt, "xb", batched)
        return [xb], vec(fn(pt, x), replace={x: xb})

    (got,), _ = _both(build, [xv])
    x = _t(tpt, "x", core)
    row = tptt.function([x], fn(tpt, x), device="cpu")
    want = np.stack([_np(row(r)) for r in xv.reshape((-1,) + core)])
    np.testing.assert_allclose(got.reshape(want.shape), want, rtol=1e-12)


def test_vectorize_node_fallback_is_a_blockwise_run_on_the_batch():
    x = _t(tpt, "x", (4, 3))
    xb = _t(tpt, "xb", (2, 4, 3))
    out = tvectorize_graph(tpt.argmax(x, axis=0), replace={x: xb})
    assert isinstance(out.owner.op, Blockwise)
    f = tptt.function([xb], out, device="cpu")
    assert any(isinstance(n.op, Blockwise) for n in f.fgraph.apply_nodes)
    assert f.linked.host_reads == []
    xv = rng.standard_normal((2, 4, 3))
    np.testing.assert_array_equal(_np(f(xv)), xv.argmax(axis=1))


def test_useless_blockwise_is_the_core_op():
    from pytensor_tpu_torch.tensor.math import Dot, _dot

    a, b = _t(tpt, "a", (3, 4)), _t(tpt, "b", (4, 2))
    out = Blockwise(_dot, signature="(m,k),(k,n)->(m,n)")(a, b)
    f = tptt.function([a, b], out, device="cpu")
    assert not any(isinstance(n.op, Blockwise) for n in f.fgraph.apply_nodes)
    assert any(isinstance(n.op, Dot) or type(n.op).__name__ == "Dot22"
               for n in f.fgraph.apply_nodes)


def test_jacobian():
    xv = rng.standard_normal(4)

    def build(ptt, pt, vec, hvp):
        x = _t(pt, "x", (None,))
        W = pt.as_tensor_variable(np.arange(12.0).reshape(3, 4) / 10)
        y = pt.tanh(pt.dot(W, x)) * x[0]
        return [x], [ptt.jacobian(y, x), ptt.jacobian(y.sum(), x)]

    (jac, grad), _ = _both(build, [xv])
    W = np.arange(12.0).reshape(3, 4) / 10
    t = np.tanh(W @ xv)
    want = (1 - t ** 2)[:, None] * W * xv[0]
    want[:, 0] += t
    np.testing.assert_allclose(jac, want, rtol=1e-12)
    np.testing.assert_allclose(grad, want.sum(axis=0), rtol=1e-12)


def test_hessian_and_hessian_vector_product():
    xv, pv = rng.standard_normal(3), rng.standard_normal(3)

    def build(ptt, pt, vec, hvp):
        x, p = _t(pt, "x", (None,)), _t(pt, "p", (None,))
        cost = (x ** 3).sum() + x[0] * x[1]
        return [x, p], [ptt.hessian(cost, x), hvp(cost, x, p)]

    (hess, hv), _ = _both(build, [xv, pv])
    want = np.diag(6 * xv)
    want[0, 1] = want[1, 0] = 1.0
    np.testing.assert_allclose(hess, want, rtol=1e-12)
    np.testing.assert_allclose(hv, want @ pv, rtol=1e-12)

"""OpFromGraph in the port against the JAX package.

The twelve cases of the JAX package's ``tests/test_opfromgraph.py``
(encapsulation and reuse, several outputs, constant inputs refused, the
``FAST_COMPILE`` path, the gradient by inlining and by ``lop_overrides``,
second order, ``Rop``, ``inline``, nesting, pickling), each built in both
packages on the same seeded numpy inputs, the JAX package with its
defaults and the port on the CPU, the values held at ``rtol 1e-12``
(float64).  Beside them: ``grad_overrides`` and ``rop_overrides``, a
given ``connection_pattern``, the inline rewrite's position and tags, the
inner-graph rewriting pass keeping an op's options, and
``construct_nominal_fgraph``.
"""

import pickle

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu.compile.builders import OpFromGraph as JOFG
from pytensor_tpu_torch.compile.builders import OpFromGraph as TOFG

PKGS = {"jax": (jptt, jpt, JOFG, {}), "torch": (tptt, tpt, TOFG, {"device": "cpu"})}


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _vals(res):
    return [_np(r) for r in (res if isinstance(res, (list, tuple)) else [res])]


def _simple_ofg(pt, OFG):
    x, w = pt.dvector("x"), pt.dvector("w")
    return OFG([x, w], [pt.tanh(x * w).sum()])


def call_and_reuse(ptt, pt, OFG, kw, rng):
    op = _simple_ofg(pt, OFG)
    a, b = pt.dvector("a"), pt.dvector("b")
    f = ptt.function([a, b], [op(a, b), op(b, a)], **kw)
    av, bv = rng.standard_normal(4), rng.standard_normal(4)
    out = _vals(f(av, bv))
    np.testing.assert_allclose(out[0], np.tanh(av * bv).sum(), rtol=1e-12)
    return out


def multiple_outputs(ptt, pt, OFG, kw, rng):
    x = pt.dvector("x")
    op = OFG([x], [pt.sum(x ** 2), pt.max(x)])
    a = pt.dvector("a")
    return _vals(ptt.function([a], list(op(a)), **kw)(rng.standard_normal(5)))


def constant_inputs_rejected(ptt, pt, OFG, kw, rng):
    c = pt.as_tensor_variable(np.ones(3))
    with pytest.raises(TypeError, match="constant"):
        OFG([c], [c * 2])
    return []


def oracle_executes(ptt, pt, OFG, kw, rng):
    op = _simple_ofg(pt, OFG)
    a, b = pt.dvector("a"), pt.dvector("b")
    f = ptt.function([a, b], op(a, b), mode="FAST_COMPILE", **kw)
    assert any(isinstance(nd.op, OFG) for nd in f.fgraph.apply_nodes)
    return _vals(f(rng.standard_normal(3), rng.standard_normal(3)))


def automatic_grad(ptt, pt, OFG, kw, rng):
    op = _simple_ofg(pt, OFG)
    a, b = pt.dvector("a"), pt.dvector("b")
    f = ptt.function([a, b], ptt.grad(op(a, b), a), **kw)
    return _vals(f(rng.standard_normal(4) * 0.5, rng.standard_normal(4) * 0.5))


def lop_override(ptt, pt, OFG, kw, rng):
    x = pt.dvector("x")
    op = OFG([x], [pt.sum(x ** 2)],
             lop_overrides=lambda inputs, output_grads: [3.0 * output_grads[0] * inputs[0]])
    old = OFG([x], [pt.sum(x ** 2)],
              grad_overrides=lambda inputs, output_grads: [5.0 * output_grads[0] * inputs[0]])
    a = pt.dvector("a")
    f = ptt.function([a], [ptt.grad(op(a), a), ptt.grad(old(a), a)], **kw)
    av = rng.standard_normal(4)
    out = _vals(f(av))
    np.testing.assert_allclose(out[0], 3.0 * av, rtol=1e-12)
    np.testing.assert_allclose(out[1], 5.0 * av, rtol=1e-12)
    return out


def second_order_through_ofg(ptt, pt, OFG, kw, rng):
    x = pt.dscalar("x")
    op = OFG([x], [x ** 3])
    a = pt.dscalar("a")
    g1 = ptt.grad(op(a), a)
    return _vals(ptt.function([a], [g1, ptt.grad(g1, a)], **kw)(2.0))


def rop_through_ofg(ptt, pt, OFG, kw, rng):
    x = pt.dvector("x")
    op = OFG([x], [pt.sum(x ** 2)])
    a, v = pt.dvector("a"), pt.dvector("v")
    f = ptt.function([a, v], ptt.Rop(op(a), a, v), **kw)
    return _vals(f(rng.standard_normal(4), rng.standard_normal(4)))


def rop_override(ptt, pt, OFG, kw, rng):
    x = pt.dvector("x")
    op = OFG([x], [pt.sum(x ** 2)],
             rop_overrides=lambda inputs, evals: [7.0 * pt.sum(inputs[0] * evals[0])])
    a, v = pt.dvector("a"), pt.dvector("v")
    jvp = op.R_op([a], [v])[0]
    return _vals(ptt.function([a, v], jvp, **kw)(rng.standard_normal(4), rng.standard_normal(4)))


def inline_expansion_removes_node(ptt, pt, OFG, kw, rng):
    x = pt.dvector("x")
    op = OFG([x], [pt.exp(x).sum()], inline=True)
    a = pt.dvector("a")
    out = []
    for mode in ("FAST_RUN", "FAST_COMPILE"):
        f = ptt.function([a], op(a), mode=mode, **kw)
        assert "OpFromGraph" not in [type(n.op).__name__ for n in f.fgraph.toposort()]
        out += _vals(f(rng.standard_normal(4)))
    return out


def non_inline_keeps_node_but_matches(ptt, pt, OFG, kw, rng):
    x = pt.dvector("x")
    op = OFG([x], [pt.exp(x).sum()], inline=False)
    a = pt.dvector("a")
    f = ptt.function([a], op(a), **kw)
    assert "OpFromGraph" in [type(n.op).__name__ for n in f.fgraph.toposort()]
    return _vals(f(rng.standard_normal(4)))


def nested_ofg(ptt, pt, OFG, kw, rng):
    x = pt.dvector("x")
    inner = OFG([x], [x * 2.0])
    y = pt.dvector("y")
    outer = OFG([y], [pt.sum(inner(y) ** 2)])
    a = pt.dvector("a")
    f = ptt.function([a], [outer(a), ptt.grad(outer(a), a)], **kw)
    av = rng.standard_normal(3)
    out = _vals(f(av))
    np.testing.assert_allclose(out[1], 8 * av, rtol=1e-12)
    return out


def pickle_function_with_ofg(ptt, pt, OFG, kw, rng):
    op = _simple_ofg(pt, OFG)
    a, b = pt.dvector("a"), pt.dvector("b")
    f = ptt.function([a, b], op(a, b), **kw)
    f2 = pickle.loads(pickle.dumps(f))
    av, bv = rng.standard_normal(3), rng.standard_normal(3)
    return _vals(f(av, bv)) + _vals(f2(av, bv))


CASES = [call_and_reuse, multiple_outputs, constant_inputs_rejected, oracle_executes,
         automatic_grad, lop_override, second_order_through_ofg, rop_through_ofg, rop_override,
         inline_expansion_removes_node, non_inline_keeps_node_but_matches, nested_ofg,
         pickle_function_with_ofg]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_case_in_both_packages(case):
    res = {name: case(ptt, pt, OFG, kw, np.random.default_rng(43))
           for name, (ptt, pt, OFG, kw) in PKGS.items()}
    assert len(res["torch"]) == len(res["jax"])
    for g, w in zip(res["torch"], res["jax"]):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0)


def test_connection_pattern_and_inline_rewrite():
    from pytensor_tpu_torch.compile.builders import construct_nominal_fgraph
    from pytensor_tpu_torch.compile.mode import optdb

    x, y = tpt.dvector("x"), tpt.dvector("y")
    op = TOFG([x, y], [x * 2.0], connection_pattern=[[True], [False]])
    node = op.make_node(x, y)
    assert op.connection_pattern(node) == [[True], [False]]
    assert TOFG([x], [x * 2.0]).connection_pattern(TOFG([x], [x * 2.0]).make_node(x)) == [[True]]
    assert optdb.positions["inline_ofg_expansion"] == -0.01
    assert {"fast_run", "fast_compile"} <= optdb._tags["inline_ofg_expansion"]
    fg = construct_nominal_fgraph([x], [tpt.exp(x)])
    assert fg.inputs[0] is not x and len(fg.apply_nodes) == 1
    with pytest.raises(NotImplementedError):
        op.infer_shape(None, node, [(3,), (3,)])


def test_inner_rewriting_keeps_the_options():
    """The inner-graph pass (``compile/rewriting.py``) rewrites a kept
    OpFromGraph's body and keeps its overrides."""
    x = tpt.dvector("x")
    op = TOFG([x], [tpt.log(1 + tpt.exp(x)).sum()],
              lop_overrides=lambda inputs, output_grads: [output_grads[0] * inputs[0]])
    a = tpt.dvector("a")
    f = tptt.function([a], op(a), device="cpu")
    (node,) = [nd for nd in f.fgraph.apply_nodes if isinstance(nd.op, TOFG)]
    assert node.op is not op and node.op.lop_overrides is op.lop_overrides
    inner = sorted(str(n.op) for n in node.op.fgraph.apply_nodes)
    assert inner != sorted(str(n.op) for n in op.fgraph.apply_nodes)  # log1p(exp) rewritten
    av = np.array([0.5, -1.0, 2.0])
    np.testing.assert_allclose(float(f(av)), np.log1p(np.exp(av)).sum(), rtol=1e-12)

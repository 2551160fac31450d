"""Relational and pattern rewriting in both packages:
``graph/rewriting/{microkanren,kanren,unify,reachability}.py``.  The
cases of ``tests/test_kanren.py`` (the microKanren core, term round trips,
``KanrenRelationSub`` rewriting ``x + x`` to ``2 * x`` and ``a*b + a*c`` to
``a*(b + c)``) and ``tests/test_tooling.py``'s ``match_pattern`` case run
against the port and the JAX package alike: the same answers, the same
rewritten ops and the same values."""

import numpy as np

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
from pytensor_tpu.graph import fg as jfg
from pytensor_tpu.graph.rewriting import basic as jbasic
from pytensor_tpu.graph.rewriting import kanren as jkanren
from pytensor_tpu.graph.rewriting import microkanren as jmk
from pytensor_tpu.graph.rewriting import reachability as jreach
from pytensor_tpu.graph.rewriting import unify as junify

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.graph import fg as tfg
from pytensor_tpu_torch.graph.rewriting import basic as tbasic
from pytensor_tpu_torch.graph.rewriting import kanren as tkanren
from pytensor_tpu_torch.graph.rewriting import microkanren as tmk
from pytensor_tpu_torch.graph.rewriting import reachability as treach
from pytensor_tpu_torch.graph.rewriting import unify as tunify

PKGS = {"jax": (jptt, jpt, jfg, jbasic, jkanren, jmk, {}),
        "torch": (tptt, tpt, tfg, tbasic, tkanren, tmk, {"device": "cpu"})}


def _both(case):
    got = {k: case(*v) for k, v in PKGS.items()}
    assert got["torch"] == got["jax"], got
    return got["torch"]


def _both_rewrites(case):
    """``_both`` on the ops and node counts; the values within 1e-14 (exp
    and log of torch and of XLA differ in the last bit)."""
    got = {k: case(*v) for k, v in PKGS.items()}
    assert got["torch"][:3] == got["jax"][:3], got
    np.testing.assert_allclose(got["torch"][3], got["jax"][3], rtol=1e-14)
    return got["torch"]


def test_unify_basic():
    def case(ptt, pt, fg, basic, kanren, mk, kw):
        x = mk.var()
        return (mk.unify(x, 3, {}) == {x: 3}, mk.unify((1, x), (1, 2), {}) == {x: 2},
                mk.unify((1, x), (2, 2), {}))

    assert _both(case) == (True, True, None)


def test_run_conde_and_lall():
    def case(ptt, pt, fg, basic, kanren, mk, kw):
        x, y = mk.var(), mk.var()
        goal = mk.conde([mk.eq(x, 1)], [mk.eq(x, 2)])
        return (mk.run(0, x, goal), mk.run(1, x, goal),
                mk.run(1, (x, y), mk.lall(mk.eq(x, (1, y)), mk.eq(y, 5))))

    assert _both(case) == ([1, 2], [1], [((1, 5), 5)])


def test_term_roundtrip():
    def case(ptt, pt, fg, basic, kanren, mk, kw):
        x = pt.tensor("x", dtype="float64", shape=(3,))
        e = pt.exp(x) + x
        t = kanren.graph_to_term(e)
        return isinstance(t, tuple), str(kanren.term_to_graph(t).type) == str(e.type)

    assert _both(case) == (True, True)


def _rewrite(ptt, pt, fg, basic, kanren, mk, kw, rel_of, build, n_in, v):
    xs = [pt.tensor(f"x{k}", dtype="float64", shape=(4,)) for k in range(n_in)]
    probe = pt.tensor("p", dtype="float64", shape=(4,))
    add_op, mul_op = (probe + probe).owner.op, (probe * probe).owner.op
    y = build(pt, *xs)
    g = fg.FunctionGraph(xs, [y], clone=False)
    before = len(g.apply_nodes)
    rel = rel_of(mk, pt, add_op, mul_op)
    basic.WalkingGraphRewriter(kanren.KanrenRelationSub(rel)).rewrite(g)
    ops = [str(n.op) for n in g.toposort()]
    f = ptt.function(xs, g.outputs[0], **kw)
    return ops, before, len(g.apply_nodes), np.asarray(f(*v)).tolist()


def test_x_plus_x_becomes_2x():
    v = [np.random.default_rng(0).standard_normal(4)]

    def rel_of(mk, pt, add_op, mul_op):
        two = pt.constant(np.float64(2.0))

        def rel(in_t, out_t):
            w = mk.var()
            return mk.lall(mk.eq(in_t, (add_op, w, w)), mk.eq(out_t, (mul_op, two, w)))
        return rel

    ops, _, _, got = _both_rewrites(lambda *p: _rewrite(
        *p, rel_of, lambda pt, x: pt.exp(x) + pt.exp(x), 1, v))
    assert any("mul" in o for o in ops)
    np.testing.assert_allclose(got, 2 * np.exp(v[0]), rtol=1e-12)


def test_relation_no_match_leaves_graph():
    v = [np.random.default_rng(0).uniform(1, 2, 4)]

    def rel_of(mk, pt, add_op, mul_op):
        def rel(in_t, out_t):
            w = mk.var()
            return mk.lall(mk.eq(in_t, (add_op, w, w)), mk.eq(out_t, w))
        return rel

    _, before, after, _ = _both_rewrites(lambda *p: _rewrite(
        *p, rel_of, lambda pt, x: pt.exp(x) + pt.log(x), 1, v))
    assert before == after


def test_distributive_relation():
    rng = np.random.default_rng(1)
    v = [rng.standard_normal(4) for _ in range(3)]

    def rel_of(mk, pt, add_op, mul_op):
        def rel(in_t, out_t):
            a, u, w = mk.var(), mk.var(), mk.var()
            return mk.lall(mk.eq(in_t, (add_op, (mul_op, a, u), (mul_op, a, w))),
                           mk.eq(out_t, (mul_op, a, (add_op, u, w))))
        return rel

    ops, _, _, got = _both_rewrites(lambda *p: _rewrite(
        *p, rel_of, lambda pt, x, b, c: x * b + x * c, 3, v))
    assert sum("mul" in o for o in ops) == 1
    np.testing.assert_allclose(got, v[0] * (v[1] + v[2]), rtol=1e-12)


def test_match_pattern():
    def case(ptt, pt, *_):
        unify = junify if ptt is jptt else tunify
        x, y = pt.dvector("x"), pt.dvector("y")
        expr = -(x * y)
        neg_op, mul_op = expr.owner.op, expr.owner.inputs[0].owner.op
        b = unify.match_pattern(expr, (neg_op, (mul_op, "a", "b")))
        b2 = unify.match_pattern(x * 2.0, (mul_op, 2.0, "t"))
        miss = unify.match_pattern(x + y, (neg_op, "a"))
        return b["a"] is x and b["b"] is y, b2["t"] is x, miss

    assert _both(case) == (True, True, None)


def test_reachability():
    def case(ptt, pt, fg, *_):
        reach = jreach if ptt is jptt else treach
        x = pt.dvector("x")
        a, b = pt.exp(x), pt.log(x)
        c = a + b
        g = fg.FunctionGraph([x], [c, b * 2], clone=False)
        bits = reach.ancestor_bitsets(g)
        order = g.toposort()
        names = {n: str(n.op) for n in order}
        chosen = reach.greedy_independent_subset([a.owner, b.owner, c.owner], g)
        return ([names[n] for n in chosen],
                sorted(names[m] for m in order if bits[c.owner] >> order.index(m) & 1))

    chosen, ancestors = _both(case)
    assert chosen == ["Elemwise{exp}", "Elemwise{log}"]
    assert ancestors == ["Elemwise{exp}", "Elemwise{log}"]

"""``IfElse`` and the lazy plan in the port against the JAX package.

The cases of ``tests/test_subsystems.py:84-100, 201-304``,
``tests/test_ref_link_xla.py:64-75`` and ``tests/test_tooling.py:443-470``
(laziness, with a counting probe op defined here: the port has no
``as_op`` yet), the three rewrites' graphs op for op against the JAX
package's, the gradient, a small guarded radon model (``models/radon.py
guarded_graphs``, 40 observations, 5 counties), an ``IfElse`` in a scan
body and the lazy plan's free lists.  Each case is built in both packages
from seeded numpy inputs (``tests/torch_control.py``); the port runs on the
CPU.  Tolerances: float64 ``rtol 1e-12`` (gradients ``1e-10``), float32
within ``2e-6`` of the largest magnitude.
"""

import importlib
import weakref

import numpy as np
import pytest

import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.ifelse import IfElse
from pytensor_tpu_torch.link.torch.dispatch import torch_funcify
from pytensor_tpu_torch.models.radon import guarded_graphs
from tests.torch_control import JAX, PORT, both, held, np_, op_strs, ops

RNG = np.random.default_rng(24)


def _n_ifelse(f):
    return sum(type(n.op).__name__ == "IfElse" for n in f.fgraph.apply_nodes)


# --- tests/test_subsystems.py ------------------------------------------------------

def _values(p):
    c, x = p.pt.lscalar("c"), p.pt.dvector("x")
    out = p.ptt.ifelse(p.pt.gt(c, 0), x * 2, x - 1)
    return [c, x], [out, p.ptt.grad(out.sum(), x)]


@pytest.mark.parametrize("c", [1, 0])
def test_values_and_grad(c):
    v = RNG.standard_normal(3)
    (out, g), _ = both(_values, [c, v], rtol=1e-10)
    np.testing.assert_allclose(out, v * 2 if c else v - 1)
    np.testing.assert_allclose(g, [2, 2, 2] if c else [1, 1, 1])


def _merge(p):
    cv = p.pt.dscalar("cv")
    c = cv > 0
    x, y = p.pt.dvector("x"), p.pt.dvector("y")
    a = p.ifelse_mod.ifelse(c, x * 2, y + 1)
    b = p.ifelse_mod.ifelse(c, x - y, y * 3)
    return [cv, x, y], [a, b]


def _constant(p):
    x, y = p.pt.dvector("x"), p.pt.dvector("y")
    return [x, y], [p.ifelse_mod.ifelse(p.pt.constant(np.bool_(True)), x, y)]


def _same(p):
    cv, x = p.pt.dscalar("cv"), p.pt.dvector("x")
    z = x * 2
    return [cv, x], [p.ifelse_mod.ifelse(cv > 0, z, z)]


def _lift(p):
    c = p.pt.scalar("c", dtype="bool")
    x, y = p.pt.dvector("x"), p.pt.dvector("y")
    return [c, x, y], [p.pt.exp(p.ifelse_mod.ifelse(c, x + 1, y * 2)).sum()]


def _no_lift(p):
    c = p.pt.scalar("c", dtype="bool")
    x, y = p.pt.dvector("x"), p.pt.dvector("y")
    z = p.ifelse_mod.ifelse(c, x + 1, y * 2)
    return [c, x, y], [p.pt.exp(z).sum(), z * 3]


REWRITE_CASES = {
    # (the graph, the IfElse nodes left, the inputs by the condition's truth)
    "merge": (_merge, 1, lambda t: [1.0 if t else -1.0, np.arange(3.0), np.ones(3)]),
    "constant": (_constant, 0, lambda t: [np.arange(3.0), np.ones(3)]),
    "same_branches": (_same, 0, lambda t: [1.0 if t else -1.0, np.arange(3.0)]),
    "lift": (_lift, 1, lambda t: [np.bool_(t), np.ones(4), 2 * np.ones(4)]),
    "no_lift": (_no_lift, 1, lambda t: [np.bool_(t), np.ones(4), 2 * np.ones(4)]),
}


@pytest.mark.parametrize("case", sorted(REWRITE_CASES))
@pytest.mark.parametrize("taken", [True, False])
def test_rewritten_graphs_op_for_op(case, taken):
    build, n_ifelse, values = REWRITE_CASES[case]
    _, (jf, tf) = both(build, values(taken))
    assert op_strs(tf) == op_strs(jf)
    assert _n_ifelse(tf) == _n_ifelse(jf) == n_ifelse


def test_lift_sinks_everything_into_the_branches():
    _, (jf, tf) = both(_lift, [np.bool_(True), np.ones(4), 2 * np.ones(4)])
    assert isinstance(tf.fgraph.toposort()[-1].op, IfElse)
    _, (jf, tf) = both(_no_lift, [np.bool_(True), np.ones(4), 2 * np.ones(4)])
    assert not isinstance(tf.fgraph.toposort()[-1].op, IfElse)


def test_merge_values():
    (a, b), _ = both(_merge, [1.0, np.arange(3.0), np.ones(3)])
    np.testing.assert_allclose(a, np.arange(3.0) * 2)
    np.testing.assert_allclose(b, np.arange(3.0) - 1)
    (a, b), _ = both(_merge, [-1.0, np.arange(3.0), np.ones(3)])
    np.testing.assert_allclose(a, 2 * np.ones(3))
    np.testing.assert_allclose(b, 3 * np.ones(3))


def test_reference_name_surface():
    # `import pytensor_tpu_torch.ifelse as m` binds the top-level function,
    # as in the JAX package; the module is reached through importlib
    ife = importlib.import_module("pytensor_tpu_torch.ifelse")
    for n in ("CondMerge", "cond_remove_identical", "cond_merge_ifs_true",
              "cond_merge_ifs_false", "ifelse_lift_single_if_through_acceptable_ops",
              "apply_depends_on", "local_useless_ifelse", "local_ifelse_merge"):
        assert hasattr(ife, n), n
    import pytensor_tpu_torch as ptt

    assert callable(ptt.ifelse) and ptt.ifelse is ife.ifelse


def test_rewrites_at_the_jax_packages_positions():
    for pkg in (JAX, PORT):
        db = pkg.mode
        assert "local_useless_ifelse" in db.canonicalize._names, pkg.name
        assert "local_ifelse_merge" in db.specialize._names, pkg.name
        assert "ifelse_lift_single_if_through_acceptable_ops" in db.specialize._names
    order = [n for n in PORT.mode.specialize._names if "ifelse" in n]
    assert order == [n for n in JAX.mode.specialize._names if "ifelse" in n]


def test_apply_depends_on():
    for pkg in (JAX, PORT):
        x = pkg.pt.dvector("x")
        a = pkg.pt.exp(x)
        b = a * 2
        assert pkg.ifelse_mod.apply_depends_on(b.owner, a.owner)
        assert not pkg.ifelse_mod.apply_depends_on(a.owner, b.owner)


def test_make_node_upcasts_checks_rank_and_merges_static_shapes():
    for pkg in (JAX, PORT):
        c = pkg.pt.bscalar("c")
        a = pkg.pt.tensor("a", dtype="float32", shape=(3, None))
        b = pkg.pt.tensor("b", dtype="float64", shape=(3, 4))
        out = pkg.ifelse_mod.ifelse(c, a, b)
        assert (out.type.dtype, out.type.shape) == ("float64", (3, None)), pkg.name
        with pytest.raises(TypeError):
            pkg.ifelse_mod.ifelse(c, a, pkg.pt.dvector("v"))
        with pytest.raises(TypeError):
            pkg.ifelse_mod.ifelse(pkg.pt.dvector("v"), a, b)
        assert str(pkg.ifelse_mod.IfElse(2, name="pick")) == "if{pick}"


def test_branches_of_two_dtypes_give_the_upcast_dtype():
    """A fault of the JAX package that the port repairs: its make_node
    casts the branches to the upcast dtype and then keeps the uncast ones,
    so its oracle returns float32 under a float64 type and its XLA path
    refuses the node; the port's node takes the cast branches."""
    x = tpt.dvector("x")
    out = PORT.ptt.ifelse(tpt.all(tpt.isfinite(x)), tpt.exp(x).sum(), tpt.constant(-np.inf))
    assert out.owner.inputs[2].type.dtype == "float64"
    f = PORT.function([x], out)
    for v, want in ((np.zeros(3), 3.0), (np.array([np.nan]), -np.inf)):
        got = np_(f(v))
        assert got.dtype == np.float64 and got == want
    jx = JAX.pt.dvector("x")
    jout = JAX.ptt.ifelse(JAX.pt.all(JAX.pt.isfinite(jx)), JAX.pt.exp(jx).sum(),
                          JAX.pt.constant(-np.inf))
    jf = JAX.function([jx], jout, mode="FAST_COMPILE")
    assert np.asarray(jf(np.array([np.nan]))).dtype == np.float32


# --- tests/test_ref_link_xla.py ------------------------------------------------------

def _consts(p):
    return [], [p.ifelse_mod.ifelse(np.array(True), np.r_[1, 2, 3], np.r_[-1, -2, -3])]


def _by_scalar(p):
    a = p.pt.dscalar("a")
    return [a], [p.ifelse_mod.ifelse(a < 0.5, np.r_[1, 2, 3], np.r_[-1, -2, -3])]


def test_ref_link_constant_and_scalar_conditions():
    (out,), _ = both(_consts, [])
    np.testing.assert_array_equal(out, [1, 2, 3])
    for a, want in ((0.2, [1, 2, 3]), (0.7, [-1, -2, -3])):
        (out,), _ = both(_by_scalar, [np.array(a)])
        np.testing.assert_array_equal(out, want)


# --- laziness (tests/test_tooling.py:443-470) ------------------------------------------

class Probe(Op):
    """Doubles its input; its lowering counts its calls."""

    __props__ = ()
    calls = 0

    def make_node(self, x):
        return Apply(self, [x], [x.type()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = inputs[0] * 2.0


@torch_funcify.register(Probe)
def _probe(op, node=None, **kw):
    def probe(x):
        Probe.calls += 1
        return x * 2.0

    return probe


@pytest.fixture
def probe():
    Probe.calls = 0
    return Probe()


@pytest.mark.parametrize("mode", ["FAST_COMPILE", "FAST_RUN"])
def test_untaken_branch_runs_no_node(probe, mode):
    c, x = tpt.tensor("c", dtype="bool", shape=()), tpt.dscalar("x")
    f = PORT.function([c, x], PORT.ptt.ifelse(c, x + 1.0, probe(x)), mode=mode)
    assert f.linked.lazy is not None
    assert float(f(np.True_, 3.0)) == 4.0
    assert Probe.calls == 0
    assert float(f(np.False_, 3.0)) == 6.0
    assert Probe.calls == 1


def test_nested_ifelse_is_lazy(probe):
    from pytensor_tpu_torch.link.torch import linker

    c1, c2 = tpt.tensor("c1", dtype="bool", shape=()), tpt.tensor("c2", dtype="bool", shape=())
    x = tpt.dscalar("x")
    inner = PORT.ptt.ifelse(c2, probe(x), x - 1.0)
    f = PORT.function([c1, c2, x], PORT.ptt.ifelse(c1, x + 1.0, inner), mode="FAST_COMPILE")
    linker.NODES_RUN = 0
    assert float(f(np.True_, np.True_, 5.0)) == 6.0
    assert Probe.calls == 0
    assert linker.NODES_RUN == 2  # x + 1 and the outer IfElse: the inner one never ran
    assert float(f(np.False_, np.False_, 5.0)) == 4.0
    assert Probe.calls == 0
    assert float(f(np.False_, np.True_, 5.0)) == 10.0
    assert Probe.calls == 1


def test_plans_without_an_ifelse_keep_the_topological_loop():
    x = tpt.dvector("x")
    f = PORT.function([x], (tpt.exp(x) * 2).sum())
    assert f.linked.lazy is None
    g = PORT.function([x], PORT.ptt.ifelse(tpt.constant(np.bool_(False)), x, x * 2))
    assert g.linked.lazy is None and g.linked.host_reads == []


def test_ifelse_plan_declares_its_read():
    c, x = tpt.dscalar("c"), tpt.dvector("x")
    f = PORT.function([c, x], PORT.ptt.ifelse(c > 0, x * 2, x - 1))
    assert f.linked.host_reads == [
        f"{n}: the condition is read on the host to choose the branch"
        for n in f.fgraph.toposort() if isinstance(n.op, IfElse)]


# --- the lazy plan's free lists -----------------------------------------------------------

class Hold(Op):
    """``x * 1``; its lowering keeps a weak reference to ``x``."""

    __props__ = ()
    refs: list = []

    def make_node(self, x):
        return Apply(self, [x], [x.type()])


class Look(Op):
    """The identity; its lowering records whether ``Hold``'s input lives."""

    __props__ = ()
    seen: list = []

    def make_node(self, x):
        return Apply(self, [x], [x.type()])


@torch_funcify.register(Hold)
def _hold(op, node=None, **kw):
    def hold(x):
        Hold.refs.append(weakref.ref(x))
        return x * 1.0

    return hold


@torch_funcify.register(Look)
def _look(op, node=None, **kw):
    def look(x):
        Look.seen.append(Hold.refs[-1]() is not None)
        return x

    return look


@pytest.mark.parametrize("other_reader", [False, True])
def test_lazy_plan_frees_by_what_has_run(other_reader):
    """``exp(x)`` is freed once ``Hold`` (its last reader) has run; where
    a reader in the untaken branch would read it too, it stays."""
    Hold.refs.clear()
    Look.seen.clear()
    c, x = tpt.tensor("c", dtype="bool", shape=()), tpt.dvector("x")
    t = tpt.exp(x)
    taken = Look()(Hold()(t))
    untaken = (t * 3.0) if other_reader else x
    f = PORT.function([c, x], PORT.ptt.ifelse(c, taken, untaken), mode="FAST_COMPILE")
    out = f(np.True_, np.zeros(3))
    np.testing.assert_array_equal(np_(out), np.ones(3))
    assert Look.seen == [other_reader]


# --- the guarded radon model and a scan -----------------------------------------------------

def _guarded(p):
    ins, outs, _, _ = guarded_graphs(p.ptt, p.pt, 40, 5, "float64")
    return ins, outs


@pytest.mark.parametrize("bad_theta", [False, True])
def test_guarded_radon_against_the_jax_package(bad_theta):
    _, _, n, y = guarded_graphs(PORT.ptt, PORT.pt, 40, 5, "float64")
    theta = 0.1 * RNG.standard_normal(n)
    if bad_theta:
        theta[3] = np.nan
    (lp, g), (jf, tf) = both(_guarded, [theta, y], rtol=1e-10)
    if bad_theta:
        assert lp == -np.inf and not g.any()
    else:
        assert np.isfinite(lp) and np.isfinite(g).all()
    assert ops(tf) == ops(jf) and _n_ifelse(tf) == 1
    assert [type(n.op).__name__ for n in tf.fgraph.toposort()].count("Assert") == 1


def test_guarded_radon_gradient_through_the_ifelse():
    def build(p):
        (theta, y), (lp, dlp), _, _ = guarded_graphs(p.ptt, p.pt, 40, 5, "float64")
        return [theta, y], [p.ptt.grad(lp, theta), dlp]

    _, _, n, y = guarded_graphs(PORT.ptt, PORT.pt, 40, 5, "float64")
    (g, dlp), _ = both(build, [0.1 * RNG.standard_normal(n), y], rtol=1e-10)
    held(g, dlp, rtol=1e-10)


def _scan_body(p):
    xs = p.pt.dvector("xs")

    def step(v, acc):
        return p.ifelse_mod.ifelse(p.pt.gt(v, 0), acc + v, acc * 0.5 - 1.0)

    res, _ = p.ptt.scan(step, sequences=[xs], outputs_info=[p.pt.constant(0.0, dtype="float64")])
    return [xs], [res]


def test_ifelse_in_a_scan_body():
    from pytensor_tpu_torch.link.cuda.scan_kernel import scan_kernel_eligible
    from pytensor_tpu_torch.scan.op import Scan

    (res,), (_, tf) = both(_scan_body, [RNG.standard_normal(9)])
    scan = next(n for n in tf.fgraph.apply_nodes if isinstance(n.op, Scan))
    assert not scan_kernel_eligible(scan.op, scan)  # K2 takes no IfElse, as in the JAX package
    assert any("a step: " in r for r in tf.linked.host_reads)

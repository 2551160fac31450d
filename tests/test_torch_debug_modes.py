"""``DebugMode``, ``NanGuardMode``, ``MonitorMode`` and ``dump_function``
in the port against the JAX package.

The cases of ``tests/test_subsystems.py:134-158``,
``tests/test_more.py:253-320, 624-640`` and
``tests/test_error_paths.py:121-130``, built in both packages (the port
on the CPU, each package with its own toy op and evil rewrite); the radon
model (40 observations, 5 counties, float64) under each mode against the
JAX package's values; ``dump_function``; and the mode names through
``config.mode`` and ``get_mode``.  On the CPU the port's ``DebugMode``
holds each node against its oracle: a numpy ``perform`` where the op has
one of its own, else the node's lowering on the CPU (for a fused node,
K1's plain version).  Values: float64 ``rtol 1e-12``.
"""

import itertools

import numpy as np
import pytest

import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.compile.debug import BadThunkOutput, DebugMode
from pytensor_tpu_torch.compile.debug.debugmode import StochasticOrder, _RecordingRewriter
from pytensor_tpu_torch.compile.debug.dump import dump_function
from pytensor_tpu_torch.compile.debug.monitormode import MonitorMode, detect_nan
from pytensor_tpu_torch.compile.debug.nanguardmode import NanGuardMode
from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.link.torch.dispatch import torch_funcify
from pytensor_tpu_torch.models.radon import guarded_graphs
from pytensor_tpu_torch.tensor.fused import FusedElemwise
from tests.torch_control import JAX, PORT, held, np_

RNG = np.random.default_rng(11)


def _radon(p):
    return guarded_graphs(p.ptt, p.pt, 40, 5, "float64", asserts=False, conditional=False)


@pytest.mark.parametrize("mode_name", ["DebugMode", "NanGuardMode", "MonitorMode"])
def test_each_mode_on_the_radon_model_gives_the_jax_packages_values(mode_name):
    results = []
    for pkg in (JAX, PORT):
        (theta, y), outs, n, yv = _radon(pkg)
        mode = getattr(pkg.debug, mode_name)()
        f = pkg.function([theta, y], outs, mode=mode)
        th = 0.1 * np.random.default_rng(3).standard_normal(n)
        results.append([np_(o) for o in f(th, yv)])
    for g, w in zip(results[1], results[0]):
        held(g, w, rtol=1e-10)


def test_debugmode_passes_on_a_good_graph_and_holds_every_node():
    for pkg in (JAX, PORT):
        x = pkg.pt.dvector("x")
        f = pkg.function([x], pkg.pt.exp(x).sum(), mode=pkg.debug.DebugMode())
        assert np.isfinite(float(np_(f(np.arange(3.0)))))
    (theta, y), outs, n, yv = _radon(PORT)
    f = PORT.function([theta, y], outs, mode=DebugMode())
    f(0.1 * RNG.standard_normal(n), yv)
    holds = f.linked.holds
    assert [n for n, _, _ in holds] == [n for n in f.fgraph.toposort()]
    fused = [(how, err) for n, how, err in holds if isinstance(n.op, FusedElemwise)]
    assert fused and all(how == "the CPU lowering" and err == 0.0 for how, err in fused)


def test_nanguard_catches_nan():
    for pkg in (JAX, PORT):
        x = pkg.pt.dvector("x")
        f = pkg.function([x], pkg.pt.log(x), mode=pkg.debug.NanGuardMode())
        with pytest.raises(AssertionError, match="NanGuard"):
            f(np.array([-1.0]))
        with pytest.raises(Exception, match="[Nn]an|[Ii]nf"):
            f(np.array([-1.0, 1.0]))


@pytest.mark.parametrize("flag", ["nan", "inf", "big"])
def test_nanguard_messages_and_flags_as_the_jax_package(flag):
    value = {"nan": -1.0, "inf": 0.0, "big": 1e10}[flag]
    messages = []
    for pkg in (JAX, PORT):
        x = pkg.pt.dvector("x")
        out = pkg.pt.log(x) if flag != "big" else x * 10.0
        f = pkg.function([x], out, mode=pkg.debug.NanGuardMode())
        with pytest.raises(AssertionError) as info:
            f(np.array([value, 1.0]))
        messages.append(str(info.value).split(" of ")[0])
        quiet = pkg.function([x], out, mode=pkg.debug.NanGuardMode(
            **{f"{flag}_is_error": False}))
        quiet(np.array([value, 1.0]))
    assert messages[0] == messages[1]
    assert config.nan_guard__nan_is_error and config.nan_guard__inf_is_error
    assert config.nan_guard__big_is_error


def test_nanguard_names_the_first_node_of_the_radon_model():
    names = []
    for pkg in (JAX, PORT):
        (theta, y), outs, n, yv = _radon(pkg)
        f = pkg.function([theta, y], outs, mode=pkg.debug.NanGuardMode())
        th = np.zeros(n)
        th[0] = np.nan
        with pytest.raises(AssertionError, match="NanGuardMode: NaN detected in an input") as info:
            f(th, yv)
        names.append(str(info.value))
    assert names[0] == names[1]


def test_monitormode_sees_every_node_once_a_call():
    for pkg in (JAX, PORT):
        seen = []
        mode = pkg.debug.MonitorMode(post_func=lambda node, thunk: seen.append(node))
        x = pkg.pt.dvector("x")
        f = pkg.function([x], [pkg.pt.exp(x) + 1, pkg.pt.log(x).sum()], mode=mode)
        f(np.arange(1.0, 4.0))
        f(np.arange(1.0, 4.0))
        order = f.fgraph.toposort()
        assert seen == order + order, pkg.name


def test_monitormode_thunk_cells_and_detect_nan():
    before, after = [], []
    mode = MonitorMode(pre_func=lambda n, t: before.append(t.outputs[0][0]),
                       post_func=lambda n, t: after.append(np_(t.outputs[0][0])))
    x = tpt.dvector("x")
    f = PORT.function([x], tpt.exp(x) * 2.0, mode=mode)
    f(np.zeros(2))
    assert before == [None] and np.array_equal(after[0], 2 * np.ones(2))
    g = PORT.function([x], tpt.log(x), mode=MonitorMode(post_func=detect_nan))
    with pytest.raises(AssertionError, match="NaN in output"):
        g(np.array([-1.0]))
    for pkg in (JAX, PORT):
        assert pkg.debug.detect_nan.__name__ == "detect_nan"


# --- a wrong lowering, a wrong rewrite (tests/test_more.py:253-320) ------------------------

class WrongOp(Op):
    __props__ = ()

    def make_node(self, x):
        return Apply(self, [x], [x.type()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = inputs[0] * 2


@torch_funcify.register(WrongOp)
def _wrong(op, node=None, **kw):
    return lambda x: x * 3  # deliberately inconsistent


def test_bad_lowering_detected():
    x = tpt.dvector("x")
    f = PORT.function([x], WrongOp()(x), mode=DebugMode())
    with pytest.raises(BadThunkOutput, match="WrongOp"):
        f(np.ones(3))
    from pytensor_tpu.compile.debug import BadThunkOutput as JaxBad

    assert JaxBad.__name__ == BadThunkOutput.__name__


def _evil_rewrite(pkg):
    """The evil rewrite of ``tests/test_more.py:282`` in ``pkg``,
    registered at optdb 47.5; returns a function that unregisters it."""
    import importlib

    root = pkg.ptt.__name__
    rb = importlib.import_module(root + ".graph.rewriting.basic")
    db_mod = importlib.import_module(root + ".graph.rewriting.db")
    ps = importlib.import_module(root + ".scalar.basic")
    tb = importlib.import_module(root + ".tensor.basic")
    Elemwise = importlib.import_module(root + ".tensor.elemwise").Elemwise
    optdb = pkg.mode.optdb

    @rb.node_rewriter([Elemwise])
    def evil_exp_scale(fgraph, node):
        if getattr(node.op.scalar_op, "name", None) != "exp":
            return False
        if getattr(node.tag, "evil", False):
            return False
        new = Elemwise(ps.exp)(*node.inputs)
        new.owner.tag.evil = True
        return [new * tb.constant(np.float64(1.5))]

    db = db_mod.EquilibriumDB(name="evil")
    db.register("evil_exp_scale", evil_exp_scale, "evil_tag_test")
    optdb.register("evil_test", db, position=47.5)

    def remove():
        del optdb._names["evil_test"]
        del optdb._tags["evil_test"]
        del optdb.positions["evil_test"]

    return remove


@pytest.mark.parametrize("pkg", [JAX, PORT], ids=["jax", "torch"])
def test_bad_rewrite_blamed(pkg):
    remove = _evil_rewrite(pkg)
    try:
        x = pkg.pt.dvector("x")
        mode = pkg.debug.DebugMode().including("evil_tag_test")
        assert type(mode) is pkg.debug.DebugMode
        f = pkg.function([x], pkg.pt.exp(x) + 1.0, mode=mode)
        with pytest.raises(pkg.debug.BadOptimization, match="evil_exp_scale"):
            f(np.ones(3))
        # and a clean pipeline does not blame
        f2 = pkg.function([x], pkg.pt.exp(x) + 1.0, mode=pkg.debug.DebugMode())
        np.testing.assert_allclose(np_(f2(np.ones(3))), np.e + 1)
    finally:
        remove()


def test_excluding_keeps_the_mode():
    m = DebugMode().excluding("fusion")
    assert type(m) is DebugMode and m.linker is not None
    x = tpt.dvector("x")
    f = PORT.function([x], tpt.exp(x) * 2 + 1, mode=m)
    assert not any(isinstance(n.op, FusedElemwise) for n in f.fgraph.apply_nodes)
    np.testing.assert_allclose(np_(f(np.zeros(2))), 3 * np.ones(2))


def test_debugmode_stochastic_order_check():
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.graph.rewriting.basic import GraphRewriter

    x = tpt.dvector("x")
    f = PORT.function([x], tpt.exp(x) + tpt.log1p(x * x), mode=DebugMode())
    np.testing.assert_allclose(np_(f(np.ones(3))), np.e + np.log(2.0))
    flips = itertools.count()

    class Flaky(GraphRewriter):
        def apply(self, fgraph):
            if next(flips) % 2:
                fgraph.replace(fgraph.outputs[0], fgraph.outputs[0] + 0.0, reason="flaky")

    fg = FunctionGraph([x], [tpt.exp(x)], clone=True)
    with pytest.raises(StochasticOrder):
        _RecordingRewriter(Flaky()).apply(fg)


def test_check_isfinite():
    x = tpt.dvector("x")
    f = PORT.function([x], tpt.log(x), mode=DebugMode(check_isfinite=True))
    with pytest.raises(BadThunkOutput, match="non-finite"):
        f(np.array([-1.0]))


# --- dump_function; the mode names --------------------------------------------------------

def test_dump_function_as_the_jax_package():
    texts = []
    for pkg in (JAX, PORT):
        dump = __import__(pkg.ptt.__name__ + ".compile.debug.dump",
                          fromlist=["dump_function"]).dump_function
        x = pkg.pt.dvector("x")
        f = pkg.function([x], (pkg.pt.exp(x) * 2 + 1).sum(), name="dumped")
        texts.append(dump(f))
    for line in ("Function dumped", "  outputs: 1"):
        assert line in texts[0] and line in texts[1]
    assert "FusedElemwise" in texts[1] and "backend: torch" in texts[1]
    x = tpt.dvector("x")
    f = PORT.function([x], (tpt.exp(x) * 2 + 1).sum(), name="dumped")
    text = dump_function(f, hlo=True)
    assert "K1 kernel of FusedElemwise" in text and "extern \"C\"" in text


def test_mode_names_through_config_and_get_mode():
    for pkg in (JAX, PORT):
        assert type(pkg.mode.get_mode("DebugMode")).__name__ == "DebugMode"
        assert type(pkg.mode.get_mode("NanGuardMode")).__name__ == "NanGuardMode"
    for name in ("DebugMode", "NanGuardMode"):
        with config.change_flags(mode=name):
            assert type(PORT.mode.get_mode(None)).__name__ == name
            x = tpt.dvector("x")
            f = PORT.ptt.function([x], tpt.exp(x), device="cpu")
            np.testing.assert_allclose(np_(f(np.zeros(2))), np.ones(2))
    with pytest.raises(Exception):
        config.mode = "NoSuchMode"
    import pytensor_tpu_torch.compile as compile_pkg

    assert compile_pkg.MonitorMode is MonitorMode and compile_pkg.function_dump is dump_function
    assert NanGuardMode().linker.flags == (True, True, True)

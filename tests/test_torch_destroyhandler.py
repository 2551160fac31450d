"""``graph/destroyhandler.py``, ``compile/mode.py AddDestroyHandler`` and
``compile/aliasing.py``'s ``alias_root`` and ``view_tree_set`` in both
packages: the cases of ``tests/test_tooling.py`` (view roots, the
orderings a destroyer needs, protection, two destroyers of one root, the
donation report) give the same answers; ``validate`` refuses destroyers
whose orderings form a cycle; the port's ``Supervisor`` refuses what
``validate`` refuses for a protected input; and functions compiled under a
mode with ``AddDestroyHandler`` (the radon model, a chain of shared-tensor
updates, a scan) give the bits they give without it."""

import numpy as np
import pytest

import pytensor_tpu.compile as jcompile
import pytensor_tpu.graph.destroyhandler as jdh
import pytensor_tpu.tensor as jpt
from pytensor_tpu.graph.basic import Apply as JApply
from pytensor_tpu.graph.fg import FunctionGraph as JFG
from pytensor_tpu.graph.op import Op as JOp

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.graph.destroyhandler as tdh
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.compile import aliasing as taliasing
from pytensor_tpu_torch.compile.mode import FAST_RUN, AddDestroyHandler
from pytensor_tpu_torch.graph.basic import Apply as TApply
from pytensor_tpu_torch.graph.fg import FunctionGraph as TFG
from pytensor_tpu_torch.graph.op import Op as TOp


def _ops(Apply, Op):
    class View(Op):
        __props__ = ()
        view_map = {0: [0]}

        def make_node(self, x):
            return Apply(self, [x], [x.type()])

    class Destroy(Op):
        __props__ = ()
        destroy_map = {0: [0]}

        def make_node(self, x):
            return Apply(self, [x], [x.type()])

    class DestroyFirst(Op):
        """Destroys its first input and reads its second."""
        __props__ = ()
        destroy_map = {0: [0]}

        def make_node(self, x, y):
            return Apply(self, [x, y], [x.type()])

    return View, Destroy, DestroyFirst


PKGS = {"jax": (jpt, JFG, jdh, *_ops(JApply, JOp)),
        "torch": (tpt, TFG, tdh, *_ops(TApply, TOp))}


def _both(case):
    got = {k: case(*v) for k, v in PKGS.items()}
    assert got["torch"] == got["jax"], got
    return got["torch"]


def _raises(fn):
    try:
        fn()
    except Exception as e:
        return type(e).__name__, str(e).split(":")[0]
    return None


def test_view_roots_and_input_protection():
    def case(pt, FG, dh, View, Destroy, _):
        x = pt.dvector("x")
        v = View()(x)
        d = Destroy()(v)
        fg = FG([x], [d], clone=False)
        h = dh.DestroyHandler()
        fg.attach_feature(h)
        refused = _raises(lambda: h.validate(fg))
        x.tag.destroyable = True
        return dh.view_root(v) is x, refused, _raises(lambda: h.validate(fg))

    root, refused, allowed = _both(case)
    assert root and refused[0] == "InconsistencyError" and allowed is None


def test_destroyer_after_every_reader_of_an_alias():
    def case(pt, FG, dh, View, Destroy, _):
        y = pt.dvector("y")
        y.tag.destroyable = True
        reader = View()(y) + 1.0
        d = Destroy()(y)
        fg = FG([y], [reader, d], clone=False)
        h = dh.DestroyHandler()
        fg.attach_feature(h)
        (node,) = [n for n in fg.apply_nodes if isinstance(n.op, Destroy)]
        order = fg.toposort()
        return reader.owner in h.orderings(fg)[node], order.index(reader.owner) < order.index(node)

    assert _both(case) == (True, True)


def test_two_destroyers_of_one_root_and_has_destroyers():
    def case(pt, FG, dh, View, Destroy, _):
        z = pt.dvector("z")
        z.tag.destroyable = True
        fg = FG([z], [Destroy()(z), Destroy()(View()(z))], clone=False)
        h = dh.DestroyHandler()
        fg.attach_feature(h)
        return (_raises(lambda: h.validate(fg)), fg.has_destroyers([z]),
                fg.has_destroyers([pt.dvector("w")]))

    refused, yes, no = _both(case)
    assert "multiple destroyers" in refused[1] and yes == [True] and no == [False]


def test_a_cycle_of_destroyers_is_refused():
    """A destroys x and reads y, B destroys y and reads x: each must run
    after the other."""
    def case(pt, FG, dh, View, Destroy, DestroyFirst):
        x, y = pt.dvector("x"), pt.dvector("y")
        x.tag.destroyable = y.tag.destroyable = True
        fg = FG([x, y], [DestroyFirst()(x, y), DestroyFirst()(y, x)], clone=False)
        h = dh.DestroyHandler()
        fg.attach_feature(h)
        return _raises(lambda: h.validate(fg))

    assert _both(case) == ("InconsistencyError", "destroy orderings introduce a cycle")


def test_donation_report():
    def case(pt, FG, dh, *_):
        x, y = pt.dvector("x"), pt.dvector("y")
        return dh.donation_report(FG([x, y], [x + y, y], clone=False))

    assert _both(case) == {0: True, 1: False}


def test_alias_root_and_view_tree_set():
    def case(pt, FG, dh, View, *_):
        aliasing = jcompile if pt is jpt else taliasing
        x = pt.dvector("x")
        v = View()(x)
        w = View()(v)
        fg = FG([x], [w + 1.0], clone=False)
        return (aliasing.alias_root(w) is x, aliasing.alias_root(x) is x,
                aliasing.view_tree_set(fg, w) == {x, v, w})

    assert _both(case) == (True, True, True)


def test_add_destroy_handler_attaches_once():
    x = tpt.dvector("x")
    fg = TFG([x], [x + 1], clone=False)
    AddDestroyHandler().rewrite(fg)
    AddDestroyHandler().rewrite(fg)
    assert isinstance(fg.destroy_handler, tdh.DestroyHandler)
    assert sum(isinstance(f, tdh.DestroyHandler) for f in fg._features) == 1


def test_supervisor_refuses_what_validate_refuses():
    """A protected (not mutable) input destroyed: the port's Supervisor and
    the DestroyHandler both refuse; marked destroyable and mutable, both
    accept."""
    _, _, _, _, Destroy, _ = PKGS["torch"]
    x = tpt.dvector("x")
    fg = TFG([x], [Destroy()(x) * 2], clone=False)
    taliasing.add_supervisor_to_fgraph(fg, [x])
    h = tdh.DestroyHandler()
    fg.attach_feature(h)
    with pytest.raises(Exception, match="Supervisor"):
        fg._supervisor.validate(fg)
    with pytest.raises(tdh.InconsistencyError):
        h.validate(fg)
    from pytensor_tpu_torch.compile.io import In

    fg2 = TFG([x], [Destroy()(x) * 2], clone=False)
    taliasing.add_supervisor_to_fgraph(fg2, [In(x, mutable=True)])
    x.tag.destroyable = True
    fg2.attach_feature(tdh.DestroyHandler())
    fg2._supervisor.validate(fg2)
    fg2.destroy_handler.validate(fg2)


MODE = FAST_RUN.register(AddDestroyHandler())


def test_radon_under_add_destroy_handler():
    from pytensor_tpu_torch.models.radon import make_radon_graphs, theta_start

    fs = []
    for mode in (FAST_RUN, MODE):
        ins, outs, n = make_radon_graphs(40, 5, "float64")
        fs.append(tptt.function(ins, outs, mode=mode, device="cpu"))
    th = theta_start(n, "float64") + 0.1
    base, handled = (f(th) for f in fs)
    assert hasattr(fs[1].fgraph, "destroy_handler")
    fs[1].fgraph.destroy_handler.validate(fs[1].fgraph)
    assert [type(n.op) for n in fs[0].fgraph.toposort()] == \
        [type(n.op) for n in fs[1].fgraph.toposort()]
    for a, b in zip(base, handled):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    assert all(tdh.donation_report(fs[1].fgraph).values())


def test_shared_updates_and_a_scan_under_add_destroy_handler():
    """A function updating two shared tensors in place (``copy_``) and a
    scan: under the handler, validate passes and the bits are the same."""
    outs = []
    for mode in (FAST_RUN, MODE):
        a = tptt.shared(np.arange(4.0), name="a", device="cpu")
        b = tptt.shared(np.ones(4), name="b", device="cpu")
        s, _ = tptt.scan(lambda acc: acc * 0.5 + a, outputs_info=[b], n_steps=5)
        f = tptt.function([], s[-1], updates={a: b * 2, b: a + s[-1]}, mode=mode,
                          device="cpu")
        got = [np.asarray(f()) for _ in range(3)]
        outs.append((got, a.get_value().numpy(), b.get_value().numpy()))
        if mode is MODE:
            f.fgraph.destroy_handler.validate(f.fgraph)
    for x, y in zip(outs[0][0] + list(outs[0][1:]), outs[1][0] + list(outs[1][1:])):
        assert np.array_equal(x, y)

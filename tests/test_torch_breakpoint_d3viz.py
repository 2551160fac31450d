"""``PdbBreakpoint``, ``d3viz`` and the IPython hooks in the port against
the JAX package.

``PdbBreakpoint`` with its debugger replaced by a recorder, in both
packages: it fires only where the condition holds, with numpy copies of
the monitored values, and its outputs are its inputs; the cases of
``tests/test_tooling.py:48, 243-260, 397-430`` (``debugprint``,
``d3write``, ``d3viz``'s self-contained page with an inner-graph view,
``pydotprint`` and the IPython repr).  Values: float64 ``rtol 1e-12``.
"""

import html
import json
import re

import numpy as np
import pytest

import pytensor_tpu.breakpoint as jbreak
import pytensor_tpu_torch.breakpoint as tbreak
from tests.torch_control import JAX, PORT, both, np_


@pytest.fixture
def recorder(monkeypatch):
    fired = []

    def record(name, monitored):
        fired.append((name, [np.array(m) for m in monitored]))
        return monitored

    monkeypatch.setattr(jbreak.PdbBreakpoint, "debugger", staticmethod(record))
    monkeypatch.setattr(tbreak.PdbBreakpoint, "debugger", staticmethod(record))
    return fired


def _broken(p):
    x = p.pt.dvector("x")
    mod = jbreak if p is JAX else tbreak
    cond = p.pt.gt(x.sum(), 0)
    y, z = mod.PdbBreakpoint("watch")(cond, x * 2, x + 1)
    return [x], [y, z]


@pytest.mark.parametrize("mode", [None, "FAST_COMPILE"])
def test_breakpoint_fires_only_where_the_condition_holds(recorder, mode):
    for v, fires in ((np.arange(1.0, 4.0), True), (-np.arange(1.0, 4.0), False)):
        recorder.clear()
        (y, z), _ = both(_broken, [v], jax_mode=mode, port_mode=mode)
        np.testing.assert_array_equal(y, v * 2)
        np.testing.assert_array_equal(z, v + 1)
        # once a call in each package
        assert len(recorder) == (2 if fires else 0)
        for name, monitored in recorder:
            assert name == "watch"
            np.testing.assert_array_equal(monitored[0], v * 2)
            np.testing.assert_array_equal(monitored[1], v + 1)


def test_breakpoint_outputs_are_its_inputs_and_its_read_is_declared(recorder):
    ins, outs = _broken(PORT)
    f = PORT.function(ins, outs)
    assert any("decide whether to break" in r for r in f.linked.host_reads)
    node = next(n for n in f.fgraph.apply_nodes if isinstance(n.op, tbreak.PdbBreakpoint))
    assert node.op.view_map == {0: [1], 1: [2]}
    import pytensor_tpu_torch as ptt

    assert ptt.breakpoint is tbreak


def _grad(p):
    x = p.pt.dvector("x")
    mod = jbreak if p is JAX else tbreak
    y = mod.PdbBreakpoint("g")(p.pt.gt(x.sum(), 100), x * x)
    return [x], [p.ptt.grad(y.sum(), x)]


def test_breakpoint_gradient(recorder):
    (g,), _ = both(_grad, [np.arange(3.0)], rtol=1e-10)
    np.testing.assert_allclose(g, 2 * np.arange(3.0))
    for pkg, mod in ((JAX, jbreak), (PORT, tbreak)):
        x = pkg.pt.dvector("x")
        node = mod.PdbBreakpoint("c")(pkg.pt.gt(x.sum(), 0), x).owner
        assert node.op.connection_pattern(node) == [[False], [True]]
        with pytest.raises(ValueError):
            mod.PdbBreakpoint("c")(x, x)


# --- d3viz, pydotprint, ipython (tests/test_tooling.py) ----------------------------------

def _graph(p, with_scan=False):
    x = p.pt.dvector("x")
    y = p.pt.exp(x) + 1
    if with_scan:
        tr, _ = p.ptt.scan(lambda a: a * 0.9 + 1.0,
                           outputs_info=[p.pt.constant(0.0, dtype="float64")], n_steps=5)
        y = p.pt.exp(x).sum() + tr[-1]
    return y


def test_debugprint_and_d3write(tmp_path):
    for pkg in (JAX, PORT):
        d3 = __import__(pkg.ptt.__name__ + ".d3viz", fromlist=["d3write"])
        y = _graph(pkg)
        s = pkg.ptt.dprint(y, file="str")
        assert "Elemwise" in s or "exp" in s
        out = tmp_path / f"{pkg.name}.html"
        d3.d3write(y, out)
        assert out.stat().st_size > 500


def test_d3viz_interactive_features(tmp_path):
    pages = []
    for pkg in (JAX, PORT):
        d3viz = __import__(pkg.ptt.__name__ + ".d3viz.d3viz", fromlist=["d3viz"]).d3viz
        out = d3viz(_graph(pkg, with_scan=True), tmp_path / f"{pkg.name}.html")
        t = open(out).read()
        assert "<script" in t and "unpkg" not in t  # self-contained, no CDN
        views = json.loads(re.search(r"const VIEWS = (.*?);\n", t, re.S).group(1))
        assert "main" in views and len(views) >= 2  # the scan's inner graph
        main = views["main"]
        assert "inner" in {n["kind"] for n in main["nodes"]} and main["inner"]
        assert all("detail" in n for n in main["nodes"])
        for feature in ("highlight", "search", "crumbs", "onwheel"):
            assert feature in t
        pages.append(views)
    assert [len(v["nodes"]) for v in pages[0].values()] == [
        len(v["nodes"]) for v in pages[1].values()]


def test_pydotprint_raises_without_pydot_as_the_jax_package(tmp_path):
    errors = []
    for pkg in (JAX, PORT):
        printing = __import__(pkg.ptt.__name__ + ".printing", fromlist=["pydotprint"])
        try:
            printing.pydotprint(_graph(pkg), outfile=str(tmp_path / "g.dot"), format="dot")
            errors.append(None)
        except Exception as e:  # noqa: BLE001 - the two packages' errors are compared
            errors.append(type(e))
    assert errors[0] == errors[1]


def test_ipython_repr():
    import pytensor_tpu.ipython as jip
    import pytensor_tpu_torch.ipython as tip

    for pkg, ip in ((JAX, jip), (PORT, tip)):
        y = _graph(pkg)
        text = ip._repr_html(y)
        assert text == f"<pre>{html.escape(pkg.ptt.dprint(y, file='str'))}</pre>"
        assert ip.register_ipython_formatters() is False  # no IPython session here
    assert np_(1.0) == 1.0

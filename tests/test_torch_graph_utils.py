"""The small modules of ROADMAP Queue 1 item 6 in both packages:
``basic_symbolic.as_symbolic`` (and the ``basic`` alias), the graph
utilities the port gained with it (``equal_computations``,
``FunctionGraph.remove_feature`` and ``dprint``, ``applys_between``,
``utils.difference`` and ``to_return_values``),
``scalar/compatnames.py``'s graph-level names, the
kernel-cache CLI (``bin/cache.py``, on a build directory of its own) and
``misc/check_blas.py`` on the CPU (the card's run is
``tests/test_torch_cuda.py``'s)."""

import numpy as np
import pytest
import scipy.sparse as sp

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
from pytensor_tpu.graph import fg as jfg
from pytensor_tpu.graph import traversal as jtrav
from pytensor_tpu import utils as jutils

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.graph import fg as tfg
from pytensor_tpu_torch.graph import traversal as ttrav
from pytensor_tpu_torch import utils as tutils

PKGS = {"jax": (jptt, jpt, jfg, jtrav, jutils), "torch": (tptt, tpt, tfg, ttrav, tutils)}


def _both(case):
    got = {k: case(*v) for k, v in PKGS.items()}
    assert got["torch"] == got["jax"], got
    return got["torch"]


def test_as_symbolic():
    def case(ptt, pt, *_):
        a = ptt.as_symbolic(np.arange(3.0))
        s = ptt.as_symbolic(slice(1, None, 2))
        n = ptt.as_symbolic(None)
        m = ptt.as_symbolic(sp.eye(3, format="csr"))
        x = pt.dvector("x")
        return (str(a.type), a.data.tolist(), type(s).__name__, s.data, n.name,
                str(m.type.format), m.type.dtype, ptt.as_symbolic(x) is x,
                ptt.basic.as_symbolic is ptt.as_symbolic)

    got = _both(case)
    assert got[1] == [0.0, 1.0, 2.0] and got[3] == slice(1, None, 2) and got[-2:] == (True, True)


def test_equal_computations_and_traversals():
    def case(ptt, pt, fg, trav, utils):
        x, y = pt.dvector("x"), pt.dvector("y")
        a, b = pt.exp(x) + y, pt.exp(x) + y
        c = pt.exp(y) + x
        outs = [a * 2]
        return (fg.equal_computations([a], [b]), fg.equal_computations([a], [c]),
                fg.equal_computations([a], [c], [x, y], [y, x]),
                sorted(str(n.op) for n in trav.applys_between([x, y], outs)),
                utils.difference([3, 1, 2, 1], [1]), utils.to_return_values([5]),
                utils.to_return_values([5, 6]))

    got = _both(case)
    assert got[:3] == (True, False, True) and got[4] == [3, 2]


def test_function_graph_remove_feature_and_dprint():
    from pytensor_tpu_torch.graph.destroyhandler import DestroyHandler
    from pytensor_tpu_torch.tensor.rewriting.shape import ShapeFeature

    x = tpt.dvector("x")
    y, z = tpt.exp(x), tpt.log(x)
    g = tfg.FunctionGraph([x], [y + 1, y * 2], clone=False)
    sf = ShapeFeature()
    g.attach_feature(sf)
    assert sf in g._features and not any(isinstance(f, DestroyHandler) for f in g._features)
    g.remove_feature(sf)
    assert sf not in g._features and not hasattr(g, "shape_feature")
    g.remove_feature(sf)  # a second removal changes nothing
    g.replace(y, z)
    assert "Elemwise{log}" in g.dprint(file="str") and "Elemwise{exp}" not in g.dprint(file="str")


def test_compatnames_graph_names():
    import pytensor_tpu_torch.scalar.compatnames as c
    from pytensor_tpu_torch.graph import null_type, type as gtype
    from pytensor_tpu_torch.printing import pprint

    assert c.pprint is pprint
    assert c.disconnected_type is null_type.disconnected_type
    assert c.HasDataType is gtype.HasDataType and c.HasShape is gtype.HasShape
    assert c.applys_between is ttrav.applys_between
    assert c.difference is tutils.difference and c.to_return_values is tutils.to_return_values
    # the JAX package's lazy name looks in its gradient module, which has none
    import pytensor_tpu.scalar.compatnames as jc

    with pytest.raises(AttributeError):
        jc.disconnected_type


def test_cache_cli(tmp_path, monkeypatch, capsys):
    from pytensor_tpu_torch.bin import cache
    from pytensor_tpu_torch.compile.compilelock import lock_ctx
    from pytensor_tpu_torch.link.cuda import build

    d = tmp_path / "kernels"
    monkeypatch.setattr(build, "BUILD_DIR", d)
    cache.main(["list"])
    assert capsys.readouterr().out == f"kernels: {d} (empty)\n"
    d.mkdir()
    (d / "libk1_abc.so").write_bytes(b"\0" * 2_000_000)
    with lock_ctx(d, "_k1_abc"):
        pass
    cache.main([])
    assert capsys.readouterr().out == f"kernels: {d} — 2 files, 2.0 MB\n"
    cache.main(["unlock"])
    assert capsys.readouterr().out == f"removed {d / '.lock_k1_abc'}\n"
    cache.main(["clear"])
    assert capsys.readouterr().out == f"cleared {d}\n" and not d.exists()


def test_check_blas_on_the_cpu(capsys):
    from pytensor_tpu_torch.misc.check_blas import execute

    for dtype in ("float32", "bfloat16"):
        assert execute(N=32, iters=2, dtype=dtype, device="cpu") > 0
        out = capsys.readouterr().out
        assert out.startswith("device: cpu\n") and f"gemm 32x32 {dtype}:" in out


def test_check_blas_needs_a_card_by_default(monkeypatch):
    import torch

    from pytensor_tpu_torch.misc.check_blas import execute

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)

    with pytest.raises(RuntimeError, match="cuda"):
        execute(N=8, iters=1)

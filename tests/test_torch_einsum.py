"""The port's ``einsum``, the einsum loop of ``benchsuite.py:197
ours_einsum`` and ``pad`` against the JAX package's, on the CPU.

The einsum cases are those of ``tests/test_op_grids_einsum_pad.py`` (every
spec, in float64 with the gradient of each operand, and in float32),
built in both packages (``tests/torch_tail.py``).  The ``Einsum`` node and
its gradient graph are the JAX package's; only the lowering orders the
products: its path on the benchsuite spec has the FLOPs of
``jnp.einsum_path(..., optimize="optimal")``, counted here, and no
``torch.einsum`` call takes more than two operands.  The einsum step's
rewritten graph and the loop's outer and inner graphs equal the JAX
package's op for op (``models/einsum.py`` at small widths), and their
values the JAX package's and ``einsum_reference``'s.  The pad cases are
the grid's: every mode at every width, in 1-d, and the gradients.
"""

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
from pytensor_tpu_torch.models import einsum as em
from pytensor_tpu_torch.tensor.einsum import contraction_path
from tests.torch_tail import check, held

EINSUM_CASES = [
    ("ij,jk->ik", [(3, 4), (4, 5)]),
    ("ij,ij->", [(3, 4), (3, 4)]),
    ("ij->ji", [(3, 4)]),
    ("ii->", [(4, 4)]),
    ("ii->i", [(4, 4)]),
    ("ij->i", [(3, 4)]),
    ("ij->", [(3, 4)]),
    ("i,j->ij", [(3,), (4,)]),
    ("bij,bjk->bik", [(2, 3, 4), (2, 4, 5)]),
    ("bij,bij->b", [(2, 3, 4), (2, 3, 4)]),
    ("ijk,jkl->il", [(2, 3, 4), (3, 4, 5)]),
    ("ij,jk,kl->il", [(2, 3), (3, 4), (4, 2)]),
    ("i,i->", [(5,), (5,)]),
    ("ijk->kji", [(2, 3, 4)]),
    ("ijk->j", [(2, 3, 4)]),
    ("ij,kj->ik", [(3, 4), (5, 4)]),
    ("aij,ajk,akl->ail", [(2, 2, 3), (2, 3, 2), (2, 2, 4)]),
    ("ij,jk,kl,lm->im", [(3, 16), (16, 3), (3, 16), (16, 3)]),
    ("...j,jk->...k", [(2, 3, 4), (4, 5)]),
    ("ij,jk", [(3, 4), (4, 5)]),
]


def _operands(ptt, pt, shapes, dtype):
    return [pt.tensor(f"x{i}", dtype=dtype, shape=s) for i, s in enumerate(shapes)]


@pytest.mark.parametrize("spec,shapes", EINSUM_CASES, ids=[c[0] for c in EINSUM_CASES])
def test_einsum_and_its_gradient(spec, shapes):
    def build(ptt, pt):
        xs = _operands(ptt, pt, shapes, "float64")
        y = pt.einsum(spec, *xs)
        return xs, [y, *ptt.grad(pt.sum(y ** 2), xs)]

    vals = [np.random.default_rng(5).standard_normal(s) for s in shapes]
    got = check(build, vals, kind="prod")
    np.testing.assert_allclose(got[0], np.einsum(spec, *vals), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("spec,shapes", EINSUM_CASES[::3], ids=[c[0] for c in EINSUM_CASES[::3]])
def test_einsum_float32_and_mixed_dtypes(spec, shapes):
    def build(ptt, pt):
        xs = _operands(ptt, pt, shapes, "float32")
        mixed = [pt.cast(xs[0], "float64")] + xs[1:]
        return xs, [pt.einsum(spec, *xs), pt.einsum(spec, *mixed)]

    rng = np.random.default_rng(6)
    got = check(build, [rng.standard_normal(s).astype("float32") for s in shapes], kind="prod")
    assert [str(g.dtype) for g in got] == ["float32", "float64"]


def test_the_einsum_graph_is_the_jax_packages():
    """The same ``Einsum`` nodes in both packages: repeated labels become
    ``diagonal``s and ``...`` explicit letters before the op, and the
    gradient graph is an ``Einsum`` a operand."""
    import pytensor_tpu_torch as tptt
    import pytensor_tpu_torch.tensor as tpt

    from pytensor_tpu.graph.traversal import io_toposort as jtopo
    from pytensor_tpu_torch.graph.traversal import io_toposort as ttopo

    seen = []
    for ptt, pt, topo in ((jptt, jpt, jtopo), (tptt, tpt, ttopo)):
        xs = [pt.dmatrix("a"), pt.tensor3("b", dtype="float64")]
        y = pt.einsum("ii,...ij->...j", xs[0], xs[1])
        g = ptt.grad(pt.sum(y), xs)
        seen.append([(type(n.op).__name__, getattr(n.op, "subscripts", None))
                     for n in topo(xs, [y, *g])])
    assert seen[0] == seen[1]
    assert ("Einsum", "i,aij->aj") in seen[1]


def test_the_path_on_the_benchsuite_spec_is_the_optimal_one():
    """``(a b)``, then ``(c d)``, then their product: 1.684e7 FLOPs at
    benchsuite's shapes, ``jnp.einsum_path``'s count (left to right would
    be 2.52e7, ``b c`` first 1.07e9)."""
    import jax.numpy as jnp

    m, n = em.EINSUM_M, em.EINSUM_N
    shapes = [(m, n), (n, m), (m, n), (n, m)]
    _, info = jnp.einsum_path(em.SPEC, *[np.ones(s, "float32") for s in shapes],
                              optimize="optimal")
    steps, flops = contraction_path(em.SPEC, shapes)
    assert flops == info.opt_cost == em.einsum_flops() == 16_842_752
    assert [spec for _, spec in steps] == ["jk,ij->ik", "lm,kl->km", "km,ik->im"]


def test_no_torch_einsum_of_more_than_two_operands(monkeypatch):
    """The lowering runs the path as one- and two-operand ``torch.einsum``
    calls, and ``fn.paths`` holds the plan of each input signature."""
    import pytensor_tpu_torch as tptt
    import pytensor_tpu_torch.tensor as tpt
    from pytensor_tpu_torch.tensor.einsum import Einsum

    calls = []
    real = torch.einsum

    def spy(spec, *ops):
        calls.append(len(ops))
        return real(spec, *ops)

    monkeypatch.setattr(torch, "einsum", spy)
    xs = [tpt.dmatrix(k) for k in "abcd"]
    f = tptt.function(xs, tpt.einsum(em.SPEC, *xs), device="cpu")
    rng = np.random.default_rng(7)
    vals = [rng.standard_normal(s) for s in ((4, 16), (16, 4), (4, 16), (16, 4))]
    np.testing.assert_allclose(f(*vals).numpy(), np.einsum(em.SPEC, *vals), rtol=1e-12)
    assert calls == [2, 2, 2]
    fn = next(step[0] for step in f.linked.steps if isinstance(step[1].op, Einsum))
    (steps, flops), = fn.paths.values()
    assert flops == 4 * 4 * 4 * 16 + 2 * 4 ** 3


def _jax_einsum(m, n, n_steps=None):
    a0, b, c, d = em.einsum_data(m, n)
    a = jptt.shared(a0, name="a")
    out = jpt.einsum(em.SPEC, a, jpt.constant(b), jpt.constant(c), jpt.constant(d))
    upd = jpt.set_subtensor(a[:m, :m], out / (jpt.sum(jpt.abs(out)) + 1.0))
    if n_steps:
        return jptt.train_loop([], out.sum(), {a: upd}, n_steps=n_steps, name="einsum_loop"), a
    return jptt.function([], out.sum(), updates={a: upd}), a


def _ops(fgraph):
    return [(type(n.op).__name__, getattr(getattr(n.op, "scalar_op", None), "name", None))
            for n in fgraph.toposort()]


def _scan(fgraph):
    return next(n for n in fgraph.apply_nodes if type(n.op).__name__ == "Scan")


@pytest.mark.parametrize("m,n", [(4, 16), (8, 64)])
def test_einsum_step_op_for_op_and_values(m, n):
    """``Einsum, CAReduce, Elemwise(abs), CAReduce, FusedElemwise,
    IncSubtensor`` in both packages; two steps against the JAX package's
    and the float64 reference."""
    fj, aj = _jax_einsum(m, n)
    ft, at = em.make_einsum_step(m=m, n=n, device="cpu")
    assert _ops(ft.fgraph) == _ops(fj.maker.fgraph)
    assert [t for t, _ in _ops(ft.fgraph)] == ["Einsum", "CAReduce", "Elemwise", "CAReduce",
                                               "FusedElemwise", "IncSubtensor"]
    for _ in range(2):
        held(np.float32(ft().numpy()), np.float32(fj()))
    held(at.get_value().numpy(), np.asarray(aj.get_value()))
    ref, total = em.einsum_reference(*em.einsum_data(m, n), 2)
    block = at.get_value().numpy()[:m, :m]
    assert np.max(np.abs(block - ref[:m, :m])) <= 1e-5 * np.max(np.abs(ref[:m, :m]))


@pytest.mark.parametrize("m,n,steps", [(4, 16, 3), (8, 64, 5)])
def test_einsum_loop_op_for_op_and_values(m, n, steps):
    """The loop's outer graph (``SpecifyShape, Scan, Subtensor``) and its
    inner graph (no fusion inside a scan, in either package) equal the JAX
    package's; ``steps`` applications against it and the reference; the
    plan reads nothing on the host."""
    lj, aj = _jax_einsum(m, n, steps)
    lt, at = em.make_einsum_loop(steps, m=m, n=n, device="cpu")
    assert _ops(lt.fgraph) == _ops(lj.maker.fgraph)
    assert _ops(_scan(lt.fgraph).op.fgraph) == _ops(_scan(lj.maker.fgraph).op.fgraph)
    assert _ops(_scan(lt.fgraph).op.fgraph)[0] == ("Einsum", None)
    held(np.float32(lt().numpy()), np.float32(lj()))
    held(at.get_value().numpy(), np.asarray(aj.get_value()))
    ref, total = em.einsum_reference(*em.einsum_data(m, n), steps)
    block = at.get_value().numpy()[:m, :m]
    assert np.max(np.abs(block - ref[:m, :m])) <= 1e-5 * np.max(np.abs(ref[:m, :m]))
    assert lt.linked.host_reads == []


PAD_MODES = ["constant", "edge", "reflect", "symmetric", "wrap", "maximum", "minimum", "mean",
             "linear_ramp"]
PAD_WIDTHS = [1, 2, (1, 2), ((1, 2), (2, 1))]


@pytest.mark.parametrize("width", PAD_WIDTHS, ids=[str(w) for w in PAD_WIDTHS])
@pytest.mark.parametrize("mode", PAD_MODES)
def test_pad(mode, width):
    kwargs = {"constant_values": 1.5} if mode == "constant" else {}

    def build(ptt, pt):
        x, i = pt.dmatrix("x"), pt.lmatrix("i")
        return [x, i], [pt.pad(x, width, mode=mode, **kwargs), pt.pad(i, width, mode=mode)]

    rng = np.random.default_rng(8)
    v, iv = rng.standard_normal((3, 4)), rng.integers(-9, 9, (3, 4))
    got = check(build, [v, iv])
    np.testing.assert_allclose(got[0], np.pad(v, width, mode=mode, **kwargs), rtol=1e-12)


@pytest.mark.parametrize("mode", ["constant", "edge", "reflect", "wrap", "symmetric", "mean"])
def test_pad_1d_and_its_gradient(mode):
    def build(ptt, pt):
        x = pt.dvector("x")
        y = pt.pad(x, 3 if mode in ("constant", "edge", "reflect", "wrap") else 2, mode=mode)
        return [x], [y, ptt.grad(pt.sum(y ** 2), x), pt.pad(x, 0, mode=mode)]

    check(build, [np.random.default_rng(9).standard_normal(5)])

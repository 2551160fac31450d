"""The port's ``extra_ops``, ``TopKOp``, ``functional``, ``reshape`` and
``interpolate`` against the JAX package's, on the CPU.

The cases are those of ``tests/test_op_grids_extra_ops.py``, each built
in both packages (``tests/torch_tail.py``) and run through ``function()``
on inputs from a seed, with gradients where the op has an ``L_op``; the
tolerances are ``torch_tail.py``'s.  Where the port follows the numpy
oracle and the XLA path does not, the case says so and pins both: the
XLA path ignores ``order="F"`` of ``unravel_index`` and
``ravel_multi_index`` and clips where ``mode="raise"`` raises;
``TopKOp``'s order among ties and unsorted is ``lax.top_k``'s, not
``np.argpartition``'s; ``cumprod``'s gradient divides by ``x`` in both,
so it is inf or NaN at a zero.
"""

import importlib

import numpy as np
import pytest

import pytensor_tpu.tensor as jpt
import pytensor_tpu_torch.tensor as tpt
from tests.torch_tail import check, compile_both, held, run

CUM_SHAPES = [((6,), [None, 0, -1]), ((3, 4), [None, 0, 1, -1]), ((2, 3, 2), [None, 0, 1, 2])]


def _cum_values(dtype, shape, seed):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, shape).astype(bool)
    if dtype.startswith("int"):
        return rng.integers(-3, 4, shape).astype(dtype)
    return rng.standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("mode", ["cumsum", "cumprod"])
@pytest.mark.parametrize("shape,axes", CUM_SHAPES, ids=[str(s) for s, _ in CUM_SHAPES])
@pytest.mark.parametrize("dtype", ["bool", "int32", "float32", "float64"])
def test_cumop(dtype, shape, axes, mode):
    """Every axis of the grid in each dtype: the output dtype is the
    input's (torch's own cumsum of an int32 or bool is int64; numpy's bool
    cumsum casts its int64 count back to bool)."""
    def build(ptt, pt):
        x = pt.tensor("x", dtype=dtype, shape=shape)
        return [x], [getattr(pt, mode)(x, axis=a) for a in axes]

    got = check(build, [_cum_values(dtype, shape, 1)], kind="prod")
    assert all(str(g.dtype) == dtype for g in got)


@pytest.mark.parametrize("mode", ["cumsum", "cumprod"])
@pytest.mark.parametrize("axis", [None, 0, 1, -1])
def test_cumop_gradient(mode, axis):
    def build(ptt, pt):
        x = pt.dmatrix("x")
        y = getattr(pt, mode)(x, axis=axis)
        w = np.arange(1.0, 13.0) if axis is None else np.arange(1.0, 5.0)
        return [x], [ptt.grad(pt.sum(y ** 2 * w), x)]

    check(build, [np.random.default_rng(2).uniform(0.5, 2.0, (3, 4))], kind="prod")


def test_cumop_empty_and_variable_methods():
    def build(ptt, pt):
        x, y = pt.dvector("x"), pt.lmatrix("y")
        return [x, y], [pt.cumsum(x), y.cumsum(axis=0), y.cumprod(), y.repeat(2, axis=1),
                        y[None].squeeze(0)]

    check(build, [np.zeros(0), np.arange(6).reshape(2, 3)])


def test_cumprod_gradient_at_a_zero_is_not_finite_in_both():
    """A reference behaviour, not a fault: the gradient of ``cumprod`` is a
    reversed running sum divided by ``x`` (``extra_ops.py CumOp.L_op``), in
    both packages, so it is inf or NaN where ``x`` is 0 (numpy's true
    derivative is finite there)."""
    def build(ptt, pt):
        x = pt.dvector("x")
        return [x], [ptt.grad(pt.sum(pt.cumprod(x)), x)]

    got = check(build, [np.array([2.0, 0.0, 3.0, 0.5])], kind="prod")[0]
    assert not np.isfinite(got[1]) and np.all(np.isfinite(got[[0, 2, 3]]))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("dtype", ["float64", "int32"])
def test_diff(dtype, n):
    def build(ptt, pt):
        x = pt.tensor("x", dtype=dtype, shape=(4, 5))
        return [x], [pt.diff(x, n=n, axis=a) for a in (0, 1, -1)]

    check(build, [_cum_values(dtype, (4, 5), 3)])


def test_squeeze_and_its_refusal():
    def build(ptt, pt):
        x = pt.tensor("x", dtype="float64", shape=(1, 3, 1))
        return [x], [pt.squeeze(x), pt.squeeze(x, 0), pt.squeeze(x, (0, -1)), x.squeeze()]

    check(build, [np.ones((1, 3, 1))])
    for pt in (jpt, tpt):
        with pytest.raises(ValueError, match="non-unit"):
            pt.squeeze(pt.tensor("x", dtype="float64", shape=(1, 3)), 1)


@pytest.mark.parametrize("repeats,axis", [(2, None), (3, 0), (2, 1), (1, 0), ([1, 2, 3], 0),
                                          ([2, 0, 1, 3], 1)])
def test_repeat(repeats, axis):
    def build(ptt, pt):
        x = pt.dmatrix("x")
        y = pt.repeat(x, repeats, axis=axis)
        return [x], [y, ptt.grad(pt.sum(y ** 2), x)] if np.ndim(repeats) == 0 else [y]

    check(build, [np.random.default_rng(4).standard_normal((3, 4))])


def test_repeat_counts_read_on_the_host():
    """Constant counts are read when the graph is linked (the plan may be
    captured); counts that are an input are a host read, so that plan
    runs eagerly (``Plan.host_reads``)."""
    import pytensor_tpu_torch as ptt

    x, r = tpt.dvector("x"), tpt.lvector("r")
    f_const = ptt.function([x], tpt.repeat(x, [1, 0, 2]), device="cpu")
    f_input = ptt.function([x, r], tpt.repeat(x, r), device="cpu")
    assert f_const.linked.host_reads == []
    assert any("read on the host" in h for h in f_input.linked.host_reads)
    xv = np.array([1.0, 2.0, 3.0])
    np.testing.assert_array_equal(f_input(xv, np.array([2, 1, 0])).numpy(), [1.0, 1.0, 2.0])
    np.testing.assert_array_equal(f_const(xv).numpy(), [1.0, 3.0, 3.0])


@pytest.mark.parametrize("dtype", ["float64", "int64", "float32"])
def test_searchsorted(dtype):
    rng = np.random.default_rng(5)
    av = np.sort((rng.integers(0, 20, 8) if dtype.startswith("int")
                  else rng.standard_normal(8)).astype(dtype))
    qv = np.concatenate([av[[1, 4, 4]], [av[0] - 1, av[-1] + 1, av[3]]]).astype(dtype)
    perm = rng.permutation(8)

    def build(ptt, pt):
        a, q = pt.tensor("a", dtype=dtype, shape=(8,)), pt.tensor("q", dtype=dtype, shape=(6,))
        s = pt.lvector("s")
        return [a, q, s], [pt.searchsorted(a, q), pt.searchsorted(a, q, side="right"),
                           pt.searchsorted(a[perm], q, sorter=s),
                           pt.searchsorted(a, pt.cast(q[0], dtype))]

    check(build, [av, qv, np.argsort(av[perm], kind="stable")])


@pytest.mark.parametrize("weights", [False, True])
def test_bincount(weights):
    rng = np.random.default_rng(6)

    def build(ptt, pt):
        x, w = pt.tensor("x", dtype="int64", shape=(10,)), pt.dvector("w")
        out = pt.bincount(x, weights=w if weights else None, minlength=8)
        return ([x, w] if weights else [x]), [out]

    vals = [rng.integers(0, 6, 10)] + ([rng.standard_normal(10)] if weights else [])
    check(build, vals)


@pytest.mark.parametrize("dims", [(6,), (3, 4), (2, 3, 4)])
def test_unravel_and_ravel_index(dims):
    rng = np.random.default_rng(7)

    def build(ptt, pt):
        i = pt.tensor("i", dtype="int64", shape=(5,))
        cs = pt.unravel_index(i, dims)
        wild = [c * 3 - 2 for c in cs]
        return [i], [*cs, pt.ravel_multi_index(cs, dims),
                     pt.ravel_multi_index(wild, dims, mode="wrap"),
                     pt.ravel_multi_index(wild, dims, mode="clip")]

    check(build, [rng.integers(0, int(np.prod(dims)), 5)])


def test_fortran_order_follows_the_oracle():
    """A reference behaviour, not a fault: the XLA path ignores
    ``order="F"`` of ``unravel_index`` and ``ravel_multi_index``
    (``link/xla/dispatch.py:838-858`` pass no order); the port gives the
    numpy oracle's values, which differ from it here."""
    def build(ptt, pt):
        i, j, k = pt.lvector("i"), pt.lvector("j"), pt.lvector("k")
        return [i, j, k], [*pt.unravel_index(i, (3, 4), order="F"),
                           pt.ravel_multi_index((j, k), (3, 4), order="F")]

    vals = [np.array([0, 5, 11]), np.array([0, 1, 2]), np.array([3, 0, 1])]
    fns = compile_both(build, oracle=True)
    got, oracle, xla = (run(fns[k], vals) for k in ("torch", "oracle", "jax"))
    for g, o in zip(got, oracle):
        held(g, o)
    np.testing.assert_array_equal(got[0], [0, 2, 2])
    np.testing.assert_array_equal(got[2], [9, 1, 5])
    np.testing.assert_array_equal(xla[0], [0, 1, 2])
    np.testing.assert_array_equal(xla[2], [3, 4, 9])


def test_ravel_multi_index_raise_follows_the_oracle():
    """A reference behaviour, not a fault: with ``mode="raise"`` an entry
    out of bounds raises in the port and the oracle, and the XLA path
    clips (``link/xla/dispatch.py:847-858``); so does ``unravel_index`` of
    an index past the size, which the XLA path clips too."""
    def build(ptt, pt):
        i, j = pt.lvector("i"), pt.lvector("j")
        return [i, j], [pt.ravel_multi_index((i, j), (3, 4))]

    vals = [np.array([0, 3]), np.array([1, 1])]
    fns = compile_both(build, oracle=True)
    np.testing.assert_array_equal(run(fns["jax"], vals)[0], [1, 9])
    for k in ("oracle", "torch"):
        with pytest.raises(ValueError):
            run(fns[k], vals)

    def build_u(ptt, pt):
        i = pt.lvector("i")
        return [i], list(pt.unravel_index(i, (3, 4)))

    fns = compile_both(build_u, oracle=True)
    for k in ("oracle", "torch"):
        with pytest.raises(ValueError):
            run(fns[k], [np.array([12])])


@pytest.mark.parametrize("m", [0, 1, 2, 7])
def test_bartlett(m):
    check(lambda ptt, pt: ([], [pt.bartlett(m)]), [])


@pytest.mark.parametrize("shape", [(4, 4), (3, 5), (5, 3)])
def test_fill_diagonal(shape):
    def build(ptt, pt):
        x = pt.dmatrix("x")
        return [x], [pt.fill_diagonal(x, 9.0)] + [
            pt.fill_diagonal_offset(x, 7.0, k) for k in (0, 1, 2)]

    check(build, [np.random.default_rng(8).standard_normal(shape)])


def test_linspace_logspace_geomspace_broadcasts():
    def build(ptt, pt):
        x, y = pt.dvector("x"), pt.tensor("y", dtype="float64", shape=(2, 1))
        return [x, y], [pt.linspace(0, 1, 5), pt.linspace(-2.0, 3.0, 4, endpoint=False),
                        pt.logspace(0, 2, 5), pt.geomspace(1, 256, 9),
                        *pt.broadcast_arrays(x, y), pt.broadcast_to(y, (2, 3)),
                        pt.broadcast_to(x[0], (3, 2)), *pt.meshgrid(x, x[:2])]

    check(build, [np.arange(3.0), np.array([[1.0], [2.0]])])


def test_compress_runs_eagerly():
    """``Nonzero``'s output length is read back, so the plan runs eagerly;
    the JAX package's XLA path refuses it (the oracle's value is held)."""
    def build(ptt, pt):
        c, x = pt.vector("c", dtype="bool"), pt.dvector("x")
        return [c, x], [pt.compress(c, x)]

    fns = compile_both(build, oracle=True)
    vals = [np.array([True, False, True, True, False]), np.arange(5.0)]
    held(run(fns["torch"], vals)[0], run(fns["oracle"], vals)[0])
    assert any("read back" in h for h in fns["torch"].linked.host_reads)
    with pytest.raises(NotImplementedError, match="data-dependent"):
        run(fns["jax"], vals)


def test_unique_raises_when_linked_as_in_the_jax_package():
    import pytensor_tpu as jptt
    import pytensor_tpu_torch as ptt

    xj, xt = jpt.lvector("x"), tpt.lvector("x")
    with pytest.raises(NotImplementedError):
        jptt.function([xj], jpt.unique(xj))(np.array([3, 1, 3]))
    with pytest.raises(NotImplementedError, match="data-dependent"):
        ptt.function([xt], tpt.unique(xt), device="cpu")
    np.testing.assert_array_equal(
        jptt.function([xj], jpt.unique(xj), mode="FAST_COMPILE")(np.array([3, 1, 3])), [1, 3])


TOPK_VALUES = np.array([1.0, 3.0, 3.0, 2.0, 3.0, 0.0, 2.0, 1.0, -np.inf, 5.0])


@pytest.mark.parametrize("k", [1, 3, 4, 7, 10])
def test_topk_with_ties(k):
    """Values descending, the lowest index first among ties, as
    ``lax.top_k``; with ``sorted=False`` the same (the JAX package's XLA
    path always sorts)."""
    def build(ptt, pt):
        x, m = pt.dvector("x"), pt.dmatrix("m")
        return [x, m], [*pt.topk(x, k), *pt.topk(x, k, sorted=False), *pt.topk(m, min(k, 4))]

    m = np.random.default_rng(9).integers(0, 4, (3, 6)).astype("float64")
    check(build, [TOPK_VALUES, m])


def test_topk_gradient_and_the_order_among_ties():
    """The gradient routes ``gz`` to the selected positions (both
    packages).  A reference behaviour, not a fault: the oracle's order among
    ties is ``np.argsort(-vals)``'s and its unsorted order
    ``np.argpartition``'s; the port gives ``lax.top_k``'s, the XLA path's."""
    def build(ptt, pt):
        x = pt.dvector("x")
        vals, idx = pt.topk(x, 4)
        return [x], [ptt.grad(pt.sum(vals * np.arange(1.0, 5.0)), x), idx,
                     pt.topk(x, 4, sorted=False)[1]]

    fns = compile_both(build, oracle=True)
    got, xla, oracle = (run(fns[k], [TOPK_VALUES]) for k in ("torch", "jax", "oracle"))
    for g, w in zip(got, xla):
        held(g, w)
    np.testing.assert_array_equal(got[1], [9, 1, 2, 4])
    assert sorted(oracle[1].tolist()) == sorted(got[1].tolist())
    assert sorted(oracle[2].tolist()) == sorted(got[2].tolist())


@pytest.mark.parametrize("axis", [None, 0, 1, (0, 1), -1])
def test_median(axis):
    def build(ptt, pt):
        x, y = pt.dmatrix("x"), pt.dmatrix("y")
        return [x, y], [pt.median(x, axis=axis), pt.median(y, axis=axis)]

    rng = np.random.default_rng(10)
    check(build, [rng.standard_normal((3, 4)), rng.standard_normal((5, 3))])


@pytest.mark.parametrize("shift,axis", [(1, 0), (-2, 1), (3, None), (0, 0), (7, 1)])
def test_roll(shift, axis):
    def build(ptt, pt):
        x, v = pt.dmatrix("x"), pt.dvector("v")
        return [x, v], [pt.roll(x, shift, axis=axis), pt.roll(v, shift, axis=0)]

    rng = np.random.default_rng(11)
    check(build, [rng.standard_normal((3, 4)), rng.standard_normal(5)])


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32"])
def test_nan_to_num_and_infinities(dtype):
    def build(ptt, pt):
        x = pt.tensor("x", dtype=dtype, shape=(None,))
        out = [pt.nan_to_num(x), pt.nan_to_num(x, nan=-1.0, posinf=9.0, neginf=-9.0),
               pt.isposinf(x), pt.isneginf(x), pt.isfinite(x)]
        return [x], out

    v = (np.array([np.nan, np.inf, -np.inf, 0.0, -0.0, 1.5]) if dtype != "int32"
         else np.array([0, 1, -1, 7]))
    check(build, [v.astype(dtype)])


def test_triangle_indices_and_helpers():
    def symbolic(ptt, pt):
        n = pt.lscalar("n")
        return [n], [*pt.tril_indices(n), *pt.triu_indices(n, 1), *pt.tril_indices(3, n)]

    # a symbolic size is a Nonzero of a mask: the XLA path refuses it, the
    # port reads its length back (eager), the oracle's value is held
    fns = compile_both(symbolic, oracle=True)
    for g, w in zip(run(fns["torch"], [np.array(4)]), run(fns["oracle"], [np.array(4)])):
        held(g, w)

    def build(ptt, pt):
        n, x = pt.lscalar("n"), pt.dmatrix("x")
        out = [*pt.tril_indices(4, -1), *pt.triu_indices(3, 1, 5),
               *pt.tril_indices_from(pt.zeros((3, 3))),
               *pt.triu_indices_from(pt.zeros((2, 4))), pt.ceil_intdiv(n, 3),
               pt.inverse_permutation(pt.constant(np.array([2, 0, 1]))),
               pt.stacklists([[x[0, 0], x[0, 1]], [x[1, 0], x[1, 1]]]),
               pt.atleast_3d(x[0]), pt.iround(x), pt.round_half_away_from_zero(x)]
        return [n, x], out

    check(build, [np.array(4), np.array([[0.5, 1.5], [-2.5, 3.25]])])
    assert tpt.get_vector_length(tpt.constant(np.arange(3))) == 3
    assert tpt.is_flat(tpt.dvector("v")) and tpt.slice_at_axis(slice(1), 1) == (
        slice(None), slice(1), Ellipsis)


def test_vectorize():
    def build(ptt, pt):
        x, y = pt.dmatrix("x"), pt.dvector("y")
        f = pt.vectorize(lambda a, b: pt.dot(a, b) + pt.sum(a), signature="(n),(n)->()")
        g = pt.vectorize(lambda a: a * 2 + 1)
        return [x, y], [f(x, y), g(x)]

    rng = np.random.default_rng(12)
    check(build, [rng.standard_normal((3, 4)), rng.standard_normal(4)], kind="prod")


def test_join_and_split_dims():
    def build(ptt, pt):
        x = pt.tensor("x", dtype="float64", shape=(2, 3, 4))
        return [x], [pt.join_dims(x), pt.join_dims(x, 1), pt.join_dims(x, 0, 2),
                     pt.split_dims(pt.join_dims(x, 1), 1, (3, 4)),
                     pt.split_dims(x, -1, (2, -1))]

    check(build, [np.arange(24.0).reshape(2, 3, 4)])


def test_interp():
    xp = np.array([0.0, 1.0, 2.0, 4.0])
    fp = np.array([1.0, 3.0, 2.0, 0.0])

    def build(ptt, pt):
        q = pt.dvector("q")
        return [q], [pt.interp(q, pt.as_tensor_variable(xp), pt.as_tensor_variable(fp)),
                     pt.interp(q, pt.as_tensor_variable(xp), pt.as_tensor_variable(fp),
                               left=-1.0, right=9.0),
                     pt.interpolate1d(pt.as_tensor_variable(xp), pt.as_tensor_variable(fp))(q)]

    got = check(build, [np.array([-1.0, 0.0, 0.5, 1.5, 3.0, 4.0, 5.0])])
    np.testing.assert_allclose(got[0], np.interp([-1.0, 0.0, 0.5, 1.5, 3.0, 4.0, 5.0], xp, fp),
                               rtol=1e-12)


# the names of this slice's modules the port does not have yet: none of
# them; tensor/optimize.py and the complex ops, item 12's tail, come from
# modules outside this slice and are here too
SLICE_MODULES = ["tensor.extra_ops", "tensor.sort", "tensor.einsum", "tensor.functional",
                 "tensor.reshape", "tensor.pad", "tensor.fft", "tensor.fourier",
                 "tensor.signal", "tensor.signal.conv", "tensor.interpolate", "tensor.transfer"]
TAIL = {"optimize", "real", "imag", "conj", "conjugate", "angle", "complex",
        "complex_from_polar"}


def test_namespace_holds_every_public_name_of_the_slice():
    """Every public name that ``pytensor_tpu.tensor`` takes from the slice's
    modules (and those modules themselves, ``pt.fft``, ``pt.signal``,
    ``pt.extra_ops``, ``pt.transfer``) is in ``pytensor_tpu_torch.tensor``,
    and so are item 12's tail, ``optimize`` and the complex ops."""
    names = {"fft", "signal", "extra_ops", "transfer", "concat_with_broadcast", "geomspace"}
    for m in SLICE_MODULES:
        jm = importlib.import_module("pytensor_tpu." + m)
        names |= {n for n, v in list(vars(jm).items())
                  if not n.startswith("_") and n in dir(jpt) and getattr(jpt, n) is v
                  and type(v).__name__ != "module"}
    missing = sorted(n for n in names if not hasattr(tpt, n))
    assert not missing, missing
    assert len(names) > 60
    assert all(hasattr(jpt, n) for n in TAIL)
    assert all(hasattr(tpt, n) for n in TAIL)
    assert tpt.optimize.__name__ == "pytensor_tpu_torch.tensor.optimize"
    for sub in ("fft", "signal", "extra_ops", "transfer"):
        assert getattr(tpt, sub).__name__ == "pytensor_tpu_torch.tensor." + sub
    for n in ("broadcast_shape", "concat_with_broadcast"):
        assert getattr(tpt.extra_ops, n) is getattr(tpt, n)

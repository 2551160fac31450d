"""The port's ``sparse/basic.py`` against the JAX package's, on the CPU.

Each case is built in both packages from the same namespaces-taking
function (``tests/torch_sparse.py``) in csr and in csc, on scipy inputs
and numpy arrays made from a seed: the JAX package's oracle
(``FAST_COMPILE``) gives the values and the structure, its ``FAST_RUN``
graph the ops the port's rewritten graph must have.  The cases are those
of ``tests/test_sparse_grids.py`` and of ``tests/test_subsystems.py``'s
``TestSparse`` and ``TestCSMGradAndFormats``, and one or more for each op
of ``basic.py`` and each of its rewrites.  Tolerances: ``rtol 1e-12``
(float64; the port sums in other orders), the structure exact.

The JAX package's XLA path disagrees with its oracle in six places, which
the port follows (ROADMAP Queue 3's rule); each is pinned here as a
reference behaviour of the JAX package, with the port's answer beside:
``add(S, S)`` keeps the duplicates, ``mul(S, T)`` S's pattern, ``remove0``
the zeros (in ``test_torch_sparse_structured.py``), ``csr_from_dense``
raises under ``jit``, ``MulSV`` by a vector leaves the matrix as it was,
and ``CSMGrad`` of a pattern computed on the device raises.
"""

import numpy as np
import pytest
import scipy.sparse as ssp
import torch

from tests.torch_sparse import (
    FORMATS,
    JAX,
    PORT,
    build,
    dense_of,
    held,
    jptt,
    ops_of,
    rand_sparse,
    run_case,
    scipy_of,
    tptt,
    tsparse,
)

rng = np.random.default_rng(25)
A45 = {fmt: rand_sparse(4, 5, fmt, seed=1) for fmt in FORMATS}
B45 = {fmt: rand_sparse(4, 5, fmt, seed=2) for fmt in FORMATS}
V5 = rng.standard_normal(5)
M53 = rng.standard_normal((5, 3))
D45 = rng.standard_normal((4, 5)) * (rng.random((4, 5)) > 0.5)


def _s(sp, fmt, name="x"):
    return sp.matrix(fmt, name, "float64")


# --- construction ----------------------------------------------------------------------

def csm_props(pt, sp, fmt):
    x = _s(sp, fmt)
    return [x], list(sp.csm_properties(x))


def csm_roundtrip(pt, sp, fmt):
    x = _s(sp, fmt)
    return [x], sp.CSM(fmt)(*sp.csm_properties(x))


def csm_scaled(pt, sp, fmt):
    """``CSM(2 * data, ...)``: a data-only rebuild in the format's layout."""
    x = _s(sp, fmt)
    d, i, p, s = sp.csm_properties(x)
    return [x], [sp.CSM(fmt)(d * 2.0, i, p, s), sp.dense_from_sparse(sp.CSM(fmt)(d * 2.0, i, p, s))]


def csm_fields(pt, sp, fmt):
    x = _s(sp, fmt)
    return [x], [sp.csm_data(x), sp.csm_indices(x), sp.csm_indptr(x), sp.csm_shape(x)]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", [csm_props, csm_roundtrip, csm_scaled, csm_fields],
                         ids=lambda c: c.__name__)
def test_csm_and_properties(case, fmt):
    run_case(case, fmt, [A45[fmt]])


# a triple whose second compressed run is unsorted and holds a duplicate
RAW = {"data": np.array([1.0, 2.0, 3.0, 4.0, 5.0, 6.0]),
       "indices": np.array([2, 0, 3, 1, 3, 0], "int32"),
       "indptr": np.array([0, 2, 5, 6], "int32")}


def csm_raw(pt, sp, fmt):
    d = pt.dvector("d")
    shape = np.array([3, 4] if fmt == "csr" else [4, 3])
    x = sp.CSM(fmt)(d, RAW["indices"], RAW["indptr"], shape)
    return [d], [x, sp.dense_from_sparse(x), sp.sp_sum(x, axis=0), sp.sp_sum(x, axis=1),
                 sp.structured_dot(x, pt.as_tensor_variable(np.arange(1.0, 4.0 if fmt == "csc"
                                                                     else 5.0)))]


@pytest.mark.parametrize("fmt", FORMATS)
def test_csm_keeps_an_unsorted_triple_with_a_duplicate(fmt):
    """``CSM`` keeps the triple as given, as scipy does; the duplicate is
    summed where the matrix is read.  A csc triple becomes the logical
    CSR, whose columns come back sorted from a csc variable's
    properties: the oracle's structure is compared in csr only."""
    got, _, _ = run_case(csm_raw, fmt, [RAW["data"]], structure=fmt == "csr")
    if fmt == "csr":
        assert dense_of(got[1])[1, 3] == 3.0 + 5.0


def csm_grad_path(pt, sp, fmt):
    pat = getattr(ssp, fmt + "_matrix")(np.array([[1.0, 0, 2], [0, 3, 0], [4, 5, 6], [0, 0, 7]]))
    d = pt.dvector("d")
    xs = sp.CSM(fmt)(d, pat.indices, pat.indptr, np.array(pat.shape))
    dense = sp.dense_from_sparse(xs)
    return [d], [dense, jptt.grad((dense ** 3).sum(), d) if pt.__name__.startswith("pytensor_tpu.")
                 else tptt.grad((dense ** 3).sum(), d)]


@pytest.mark.parametrize("fmt", FORMATS)
def test_csm_dense_roundtrip_and_grad(fmt):
    """``TestCSMGradAndFormats.test_csm_dense_roundtrip_and_grad``: the
    gradient through ``CSM.L_op`` (``CSMGrad`` of ``SparseFromDense``,
    which ``local_csm_grad_of_dense`` gathers at the pattern, so the
    nonzeros' count is not read back; the gather's bounds check of its
    computed rows still reads their min and max)."""
    dv = np.arange(1.0, 8.0)
    got, _, f = run_case(csm_grad_path, fmt, [dv])
    np.testing.assert_allclose(got[1].numpy(), 3 * dv ** 2, rtol=1e-12)
    assert "CSMGrad" not in ops_of(f) and "SparseFromDense" not in ops_of(f)
    assert [r.split("(")[0] for r in f.linked.host_reads] == ["AdvancedSubtensor"]


def csm_grad_mismatch(pt, sp, fmt):
    out = sp.CSMGrad()(pt.as_tensor_variable(np.array([1.0, 2, 3])), np.array([0, 2, 1]),
                       np.array([0, 2, 3]), np.array([2, 3]),
                       pt.as_tensor_variable(np.array([7.0])), np.array([2]),
                       np.array([0, 1, 1]), np.array([2, 3]))
    return [], out


def csm_grad_duplicates(pt, sp, fmt):
    """A cotangent holding (1, 2) twice and x's entries out of order."""
    gd = pt.dvector("gd")
    out = sp.CSMGrad()(pt.as_tensor_variable(np.zeros(4)), np.array([2, 0, 1, 2]),
                       np.array([0, 2, 4]), np.array([2, 3]),
                       gd, np.array([2, 1, 2, 2]), np.array([0, 1, 4]), np.array([2, 3]))
    return [gd], out


def test_csm_grad_restores_zeros_in_x_order():
    """``test_csm_grad_pattern_mismatch_oracle``: gz sparser than x."""
    got, _, _ = run_case(csm_grad_mismatch, "csr", [], graph=False)
    np.testing.assert_array_equal(got[0].numpy(), [0.0, 7.0, 0.0])


def test_csm_grad_sums_duplicates_of_the_cotangent():
    got, _, _ = run_case(csm_grad_duplicates, "csr", [np.array([1.0, 2.0, 3.0, 4.0])])
    np.testing.assert_array_equal(got[0].numpy(), [1.0, 0.0, 2.0, 7.0])


def dense_roundtrip(pt, sp, fmt):
    d = pt.dmatrix("d")
    s = sp.csr_from_dense(d) if fmt == "csr" else sp.csc_from_dense(d)
    return [d], [s, sp.dense_from_sparse(s) + 1.0]


def from_dense(pt, sp, fmt):
    d = pt.dmatrix("d")
    s = sp.csr_from_dense(d) if fmt == "csr" else sp.csc_from_dense(d)
    return [d], [s, sp.sp_sum(s, axis=0)]


def to_dense(pt, sp, fmt):
    x = _s(sp, fmt)
    return [x], [sp.dense_from_sparse(x), x.toarray()]


@pytest.mark.parametrize("fmt", FORMATS)
def test_dense_conversions(fmt):
    """``test_dense_roundtrip`` and ``test_dense_from_sparse_round_trip_
    cancels``: the round trip rewrites to the identity, so only a
    ``SparseFromDense`` output reads back."""
    _, _, f = run_case(dense_roundtrip, fmt, [D45])
    assert "DenseFromSparse" not in ops_of(f)
    _, _, f = run_case(from_dense, fmt, [D45])
    assert [r.split("(")[0] for r in f.linked.host_reads] == [f"SparseFromDense{{format='{fmt}'}}"]
    _, _, f = run_case(to_dense, fmt, [A45[fmt]])
    assert f.linked.host_reads == []


def test_csr_from_dense_raises_under_jit_in_the_xla_path():
    """Reference behaviour: the XLA path's ``BCOO.fromdense`` needs a
    concrete count, so a lone ``csr_from_dense`` raises when jitted; the
    oracle and the port give its 8 entries."""
    ins, outs = build(JAX, lambda pt, sp, fmt: ([pt.dmatrix("d")], None), "csr")
    d = ins[0]
    with pytest.raises(Exception, match="Concretization|concrete"):
        jptt.function([d], jsparse_csm_data(d))(D45)
    t_ins, _ = build(PORT, lambda pt, sp, fmt: ([pt.dmatrix("d")], None), "csr")
    got = tptt.function(t_ins, tsparse.csm_data(tsparse.csr_from_dense(t_ins[0])),
                        device="cpu")(D45)
    assert got.shape == (np.count_nonzero(D45),)


def jsparse_csm_data(d):
    from pytensor_tpu import sparse

    return sparse.csm_data(sparse.csr_from_dense(d))


def csm_grad_same_pattern(pt, sp, fmt):
    """``sp_sum(structured_exp(CSM(d, ...)))``: the cotangent is rebuilt on
    the same ``indices`` and ``indptr`` variables once
    ``local_csm_properties_csm`` cancels, so ``CSMGrad`` reduces to its
    data."""
    pat = getattr(ssp, fmt + "_matrix")(np.array([[1.0, 0, 2], [0, 3, 0], [4, 5, 6], [0, 0, 7]]))
    d = pt.dvector("d")
    xs = sp.CSM(fmt)(d, pat.indices, pat.indptr, np.array(pat.shape))
    g = (jptt if pt.__name__.startswith("pytensor_tpu.") else tptt).grad(
        sp.sp_sum(sp.structured_exp(xs)), d)
    return [d], g


@pytest.mark.parametrize("fmt", FORMATS)
def test_csm_grad_same_pattern_fires_in_both_packages(fmt):
    """``local_csm_grad_same_pattern`` fires as often in both packages and
    leaves no ``CSMGrad``; the gradient is ``exp(d)``."""
    from tests.torch_math_probe import _fired

    dv = np.linspace(-1.0, 1.0, 7)
    got, _, f = run_case(csm_grad_same_pattern, fmt, [dv])
    counts, undo = _fired()
    try:
        for side, kw in ((JAX, {}), (PORT, {"device": "cpu"})):
            side[0].function(*build(side, csm_grad_same_pattern, fmt), **kw)
    finally:
        undo()
    name = "local_csm_grad_same_pattern"
    assert counts["torch"][name] == counts["jax"][name] > 0
    assert "CSMGrad" not in ops_of(f) and f.linked.host_reads == []
    np.testing.assert_allclose(got[0].numpy(), np.exp(dv), rtol=1e-12)


def test_csm_properties_of_csm_cancels():
    """``TestSparseStructuredOps.test_csm_properties_of_csm_cancels``."""
    outs = []
    for ptt, pt, sp in (JAX, PORT):
        x = sp.csr_matrix("x", dtype="float64")
        d, i, p, s = sp.basic.CSMProperties()(x)
        d2 = sp.basic.CSMProperties()(sp.CSM("csr")(d * 2.0, i, p, s))[0]
        f = ptt.function([x], d2, **({} if ptt is jptt else {"device": "cpu"}))
        assert "CSM" not in ops_of(f)
        outs.append(dense_of(f(A45["csr"])))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-12)
    np.testing.assert_allclose(outs[1], A45["csr"].data * 2.0, rtol=1e-12)


# --- products ------------------------------------------------------------------------------

def sdot_vec(pt, sp, fmt):
    x, b = _s(sp, fmt), pt.dvector("b")
    return [x, b], sp.structured_dot(x, b)


def sdot_mat(pt, sp, fmt):
    x, b = _s(sp, fmt), pt.dmatrix("b")
    return [x, b], [sp.structured_dot(x, b), x @ b]


def sdot_grad_dense(pt, sp, fmt):
    x, b = _s(sp, fmt), pt.dvector("b")
    loss = pt.sum(sp.structured_dot(x, b) ** 2)
    return [x, b], (jptt if pt.__name__.startswith("pytensor_tpu.") else tptt).grad(loss, b)


def sdot_grad_sparse(pt, sp, fmt):
    x, b = _s(sp, fmt), pt.dvector("b")
    g = (jptt if pt.__name__.startswith("pytensor_tpu.") else tptt).grad(
        pt.sum(sp.structured_dot(x, b)), x)
    return [x, b], [g, sp.dense_from_sparse(g)]


def dot_both_sides(pt, sp, fmt):
    x, b, c = _s(sp, fmt), pt.dmatrix("b"), pt.dmatrix("c")
    return [x, b, c], [sp.dot(x, b), sp.dot(c, x), sp.true_dot(x, b)]


def transposed(pt, sp, fmt):
    x = _s(sp, fmt)
    return [x], [sp.transpose(x), x.T, sp.dense_from_sparse(sp.transpose(sp.neg(x)))]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case,extra", [
    (sdot_vec, [V5]), (sdot_mat, [M53]), (sdot_grad_dense, [V5]), (sdot_grad_sparse, [V5]),
    (dot_both_sides, [M53, rng.standard_normal((2, 4))]), (transposed, []),
], ids=["structured_dot_vector", "structured_dot_matrix", "grad_wrt_dense",
        "grad_wrt_sparse", "dot", "transpose"])
def test_products(case, extra, fmt):
    """``TestStructuredDot`` (values, both gradients), ``TestSparse``'s
    ``test_structured_dot``/``test_grad_dense_side``, ``dot`` on either
    side and the transpose: none reads the device back."""
    _, _, f = run_case(case, fmt, [A45[fmt], *extra])
    assert f.linked.host_reads == []


def sampling(pt, sp, fmt):
    x, y, p = pt.dmatrix("x"), pt.dmatrix("y"), _s(sp, fmt, "p")
    s = sp.sampling_dot(x, y, p)
    return [x, y, p], [s, sp.dense_from_sparse(s)]


def usmm_direct(pt, sp, fmt):
    x, y, z = _s(sp, fmt), pt.dmatrix("y"), pt.dmatrix("z")
    return [x, y, z], sp.usmm(np.float64(2.0), x, y, z)


def usmm_rewrite(pt, sp, fmt):
    x, y, z = _s(sp, fmt), pt.dmatrix("y"), pt.dmatrix("z")
    return [x, y, z], sp.structured_dot(x, y) + z


@pytest.mark.parametrize("fmt", FORMATS)
def test_sampling_dot_and_usmm(fmt):
    """``TestUsmmSampling``: ``SamplingDot`` keeps p's pattern, ``Usmm``
    directly and through ``local_usmm`` (specialize), which fires in
    both packages."""
    P = rand_sparse(4, 3, fmt, seed=3)
    run_case(sampling, fmt, [rng.standard_normal((4, 5)), rng.standard_normal((3, 5)), P])
    yz = [A45[fmt], M53, rng.standard_normal((4, 3))]
    run_case(usmm_direct, fmt, yz)
    _, _, f = run_case(usmm_rewrite, fmt, yz)
    assert ops_of(f) == ["Usmm"]


# --- reductions and arithmetic -------------------------------------------------------------

def sums(pt, sp, fmt):
    x = _s(sp, fmt)
    return [x], [sp.sp_sum(x), sp.sp_sum(x, axis=0), sp.sp_sum(x, axis=1), x.sum()]


def sum_grad(pt, sp, fmt):
    x = _s(sp, fmt)
    g = (jptt if pt.__name__.startswith("pytensor_tpu.") else tptt).grad(sp.sp_sum(x) * 3.0, x)
    return [x], g


def add_sd(pt, sp, fmt):
    x, d = _s(sp, fmt), pt.dmatrix("d")
    return [x, d], [sp.add(x, d), sp.add(d, x), x + d]


def add_ss(pt, sp, fmt):
    x, y = _s(sp, fmt), _s(sp, fmt, "y")
    return [x, y], [sp.add(x, y), sp.add(x, x), x + y, sp.dense_from_sparse(sp.add(x, y))]


def mul_sv(pt, sp, fmt):
    x, v, c = _s(sp, fmt), pt.dvector("v"), pt.dscalar("c")
    return [x, v, c], [sp.mul(x, c), sp.mul(c, x), x * c]


def mul_ss(pt, sp, fmt):
    x, y = _s(sp, fmt), _s(sp, fmt, "y")
    return [x, y], [sp.mul(x, y), x * y, sp.dense_from_sparse(sp.mul(x, y))]


def stacks(pt, sp, fmt):
    x, y = _s(sp, fmt), _s(sp, fmt, "y")
    return [x, y], [sp.hstack([x, y], format=fmt), sp.vstack([x, y], format=fmt),
                    sp.hstack([x, y], format="csr" if fmt == "csc" else "csc")]


def item_scalar(pt, sp, fmt):
    x = _s(sp, fmt)
    return [x], [sp.get_item_scalar(x, 1, 2), sp.get_item_scalar(x, -1, -2), x[2, 0],
                 sp.get_item_scalar(x, 0, 0)]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case,extra,reads", [
    (sums, [], []), (sum_grad, [], []), (add_sd, [D45], []),
    (add_ss, [B45], ["AddSS"]), (mul_sv, [V5, np.float64(-1.5)], []),
    (mul_ss, [B45], ["MulSS"]), (stacks, [B45], []), (item_scalar, [], []),
], ids=["sp_sum", "sp_sum_grad", "add_s_d", "add_s_s", "mul_s_v", "mul_s_s", "hstack_vstack",
        "get_item_scalar"])
def test_arithmetic(case, extra, reads, fmt):
    """``TestElementwiseAndArith``, ``TestStructuralOps``'s sums, stacks
    and scalar lookups, and ``TestSparse.test_conversions_and_sum``: the
    oracle's structure (the union and intersection canonical, their zeros
    dropped); only ``AddSS`` and ``MulSS`` read their count back."""
    values = [A45[fmt]] + [v[fmt] if isinstance(v, dict) else v for v in extra]
    _, _, f = run_case(case, fmt, values)
    assert {r.split("(")[0] for r in f.linked.host_reads} == set(reads)


def test_add_and_mul_of_cancelling_matrices_drop_the_zeros():
    """``x + (-x)`` stores nothing and ``x * y`` of disjoint patterns
    nothing, as scipy (the oracle) gives."""
    A = A45["csr"]
    B = ssp.csr_matrix(np.where(A.toarray() == 0, 1.0, 0.0))
    for values in ([A, -A], [A, B]):
        run_case(add_ss, "csr", values)
        got, _, _ = run_case(mul_ss, "csr", values)
    assert scipy_of(got[0]).nnz == 0


# --- where the XLA path disagrees with the oracle -------------------------------------------

def _xla_and_port(case, values, fmt="csr"):
    ins, outs = build(JAX, case, fmt)
    xla = jptt.function(ins, outs)(*values)
    t_ins, t_outs = build(PORT, case, fmt)
    return xla[0], tptt.function(t_ins, t_outs, device="cpu")(*values)[0]


def nnz_of_add(pt, sp, fmt):
    x = _s(sp, fmt)
    return [x], sp.csm_data(sp.add(x, x))


def nnz_of_mul(pt, sp, fmt):
    x, y = _s(sp, fmt), _s(sp, fmt, "y")
    return [x, y], sp.csm_data(sp.mul(x, y))


def test_reference_behaviour_add_keeps_duplicates_in_the_xla_path():
    """``add(S, S)``: 16 stored entries in the XLA path (the two patterns
    concatenated), the oracle's 8 in the port."""
    S = ssp.random(4, 5, density=0.4, format="csr", random_state=1)
    xla, port = _xla_and_port(nnz_of_add, [S])
    assert (len(np.asarray(xla)), port.shape[0]) == (2 * S.nnz, S.nnz) == (16, 8)


def test_reference_behaviour_mul_keeps_the_first_pattern_in_the_xla_path():
    """``mul(S, T)`` with 3 entries in common: the XLA path stores S's 8
    (zeros where T has none), the oracle and the port the 3."""
    S = ssp.random(4, 5, density=0.4, format="csr", random_state=1)
    T = ssp.random(4, 5, density=0.4, format="csr", random_state=2)
    xla, port = _xla_and_port(nnz_of_mul, [S, T])
    assert (len(np.asarray(xla)), port.shape[0]) == (8, 3)
    np.testing.assert_allclose(np.sort(np.asarray(xla)[np.asarray(xla) != 0]),
                               np.sort(port.numpy()), rtol=1e-12)


def mul_by_vector(pt, sp, fmt):
    x, v = _s(sp, fmt), pt.dvector("v")
    return [x, v], sp.dense_from_sparse(sp.mul(x, v))


def test_reference_behaviour_mul_by_a_vector_is_ignored_in_the_xla_path():
    """``MulSV`` by a vector: the XLA path returns the matrix unscaled, the
    oracle (scipy's ``multiply``) and the port scale column j by v[j]."""
    A = A45["csr"]
    xla, port = _xla_and_port(mul_by_vector, [A, V5])
    np.testing.assert_allclose(np.asarray(xla), A.toarray(), rtol=1e-12)
    np.testing.assert_allclose(port.numpy(), A.toarray() * V5, rtol=1e-12)
    run_case(mul_by_vector, "csr", [A, V5])


def test_reference_behaviour_csm_grad_of_a_device_pattern_raises_in_the_xla_path():
    """The learned-edge-weights gradient (``models/sparse_learning.py``):
    its ``CSMGrad`` compares x's constant pattern with one computed on the
    device, which the XLA lowering must read as a concrete shape, so the
    jitted function raises; the port looks the cotangent up at the
    pattern and matches the oracle."""
    from pytensor_tpu_torch.models.sparse_learning import edge_pattern, edge_weight_graphs

    A, w, X, T = edge_pattern(60, 3, 2, seed=5)
    ins, outs = edge_weight_graphs(*JAX, A, 2)
    with pytest.raises(Exception, match="Tracer|concrete|Concretization"):
        jptt.function(ins, outs)(w, X, T)


# --- the types and the namespace --------------------------------------------------------------

def test_types_and_surface_aliases():
    """``TestCSMGradAndFormats.test_surface_aliases`` in both packages,
    the torch sparse filter, and ``bcoo``, which the port refuses by
    naming its own sparse value."""
    for _, pt, sp in (JAX, PORT):
        m = sp.bsr_matrix("m", dtype="float64")
        assert m.type.format == "bsr"
        s = sp.csr_matrix("s", dtype="float64")
        for fn in (sp.csm_data, sp.csm_indices, sp.csm_indptr, sp.csm_shape):
            assert fn(s).type.ndim == 1
        assert hasattr(sp.as_sparse_or_tensor_variable(np.eye(3)), "type")
        assert sp.as_sparse_or_tensor_variable(ssp.eye(3, format="csr")).type.format == "csr"
        assert sp.as_symbolic_sparse(ssp.eye(2, format="csc")).type.format == "csc"
        assert sp.csc_fmatrix().type.dtype == "float32" and sp.bsr_dmatrix().type.format == "bsr"
        t = sp.SparseTensorType("csr", "float64")
        assert t.values_eq_approx(ssp.eye(3, format="csr"), np.eye(3))
    with pytest.raises(ValueError, match="torch sparse"):
        tsparse.SparseTensorType("bcoo", "float64")
    t = tsparse.SparseTensorType("csr", "float32")
    v = t.filter(torch.eye(3, dtype=torch.float64).to_sparse_csr())
    assert v.layout == torch.sparse_csr and v.dtype == torch.float32
    with pytest.raises(TypeError):
        t.filter(torch.eye(3).to_sparse_csc(), strict=True)
    assert t.values_eq_approx(v, np.eye(3))


def test_bsr_is_the_logical_csr():
    """A bsr variable's device value is the logical CSR; it returns as a
    torch csr tensor with the matrix's values."""
    A = ssp.random(4, 6, density=0.5, format="bsr", random_state=7)
    x = tsparse.bsr_matrix("x", dtype="float64")
    f = tptt.function([x], [sp_out for sp_out in (x * 2.0, tsparse.sp_sum(x, axis=1))],
                      device="cpu")
    got = f(A)
    np.testing.assert_allclose(dense_of(got[0]), 2.0 * A.toarray(), rtol=1e-12)
    np.testing.assert_allclose(got[1].numpy(), A.toarray().sum(1), rtol=1e-12)


JAX_ONLY = set()


def test_namespace_matches_the_jax_package():
    """Every name of ``pytensor_tpu.sparse`` is in
    ``pytensor_tpu_torch.sparse`` (no jax-only name remains), and the port
    adds none."""
    import pytensor_tpu.sparse as j

    jn = {n for n in dir(j) if not n.startswith("__")}
    tn = {n for n in dir(tsparse) if not n.startswith("__")}
    assert jn - tn == JAX_ONLY
    assert tn - jn == set()


def test_every_op_has_a_lowering():
    """Every ``Op`` class of the port's sparse modules has a torch
    lowering."""
    import inspect

    from pytensor_tpu_torch.graph.op import Op
    from pytensor_tpu_torch.link.torch.dispatch import torch_funcify
    from pytensor_tpu_torch.sparse import basic, compat, linalg, structured

    ops = {cls for mod in (basic, structured, linalg, compat)
           for _, cls in inspect.getmembers(mod, inspect.isclass)
           if issubclass(cls, Op) and cls.__module__ == mod.__name__}
    ops.add(type(compat._MajorIds.build()))
    assert len(ops) == 28
    missing = [cls.__name__ for cls in ops
               if torch_funcify.dispatch(cls) is torch_funcify.dispatch(Op)]
    assert missing == []


def test_sparse_outputs_hold_in_each_format():
    """One output of each format from one function: each is a torch sparse
    tensor of its own layout."""
    x = tsparse.csr_matrix("x", dtype="float64")
    f = tptt.function([x], [x, x.T, tsparse.CSC(*tsparse.csm_properties(x.T))], device="cpu")
    out = f(A45["csr"])
    assert [o.layout for o in out] == [torch.sparse_csr, torch.sparse_csc, torch.sparse_csc]
    for o in out[1:]:
        np.testing.assert_array_equal(dense_of(o), A45["csr"].toarray().T)
    held(out[0], A45["csr"], x)

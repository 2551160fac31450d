"""The port's ``sparse/{structured,linalg,compat,variable}.py`` against the
JAX package's, on the CPU.

As ``test_torch_sparse_ops.py``: each case built in both packages in csr
and csc from seeded inputs, the port's values and structure held to the
JAX package's oracle (``FAST_COMPILE``) and its rewritten graph to the
JAX package's ``FAST_RUN`` graph op for op.  The cases are those of
``tests/test_subsystems.py``'s ``TestSparseCompat``,
``TestSparseStructuredGrads`` and ``TestSparseStructuredOps``, and of
``tests/test_sparse_grids.py``'s structured unary ops, comparisons,
casts, scales and cleanups, and one or more for each function of
``compat.py`` and each operator of ``variable.py``.  Where scipy would
sum repeated indices (``GetItemListGrad``, ``GetItem2ListsGrad``,
``ConstructSparseFromList``), the port keeps the entries apart: the
dense values are the oracle's, the structure is compared where no index
repeats.  ``remove0``'s zeros are the sixth reference behaviour of the
XLA path (pinned below).  Tolerances: ``rtol 1e-12``, the structure exact.
"""

import numpy as np
import pytest
import scipy.sparse as ssp

from tests.torch_sparse import (
    FORMATS,
    JAX,
    PORT,
    build,
    dense_of,
    jptt,
    ops_of,
    rand_sparse,
    run_case,
    scipy_of,
    tptt,
)

rng = np.random.default_rng(26)
X65 = {fmt: rand_sparse(6, 5, fmt, density=0.5, seed=3) for fmt in FORMATS}
Y65 = {fmt: rand_sparse(6, 5, fmt, density=0.5, seed=4) for fmt in FORMATS}
SQ = {fmt: rand_sparse(5, 5, fmt, density=0.6, seed=1) for fmt in FORMATS}


def _s(sp, fmt, name="x"):
    return sp.matrix(fmt, name, "float64")


def _grad(pt):
    return (jptt if pt.__name__.startswith("pytensor_tpu.") else tptt).grad


def _reads(f):
    return {r.split("(")[0] for r in f.linked.host_reads}


# --- structured.py --------------------------------------------------------------------------

IDX = np.array([1, 1, 4, 0], "int64")


def item_list(pt, sp, fmt):
    x = _s(sp, fmt)
    return [x], [sp.get_item_list(x, IDX), x[IDX], sp.get_item_list(x, np.array([-1, 2]))]


def item_list_grad(pt, sp, fmt):
    x = _s(sp, fmt)
    sel = sp.get_item_list(x, IDX)
    g = _grad(pt)(sp.sp_sum(sp.mul(sel, sel)), x)
    return [x], [g, sp.dense_from_sparse(g)]


def item_list_grad_op(pt, sp, fmt):
    x, gz = _s(sp, fmt), _s(sp, fmt, "gz")
    return [x, gz], sp.get_item_list_grad(x, np.array([3, 0, 5, 2]), gz)


@pytest.mark.parametrize("fmt", FORMATS)
def test_get_item_list_and_grad(fmt):
    """``test_get_item_list_with_repeats_both_backends`` and
    ``test_get_item_list_grad``: the selected rows with the oracle's
    structure (its count read back); the gradient's rows moved back with a
    static count, the repeated row's entries kept apart."""
    _, _, f = run_case(item_list, fmt, [X65[fmt]])
    assert _reads(f) == {"GetItemList"}
    run_case(item_list_grad, fmt, [X65[fmt]], structure=False)
    gz = rand_sparse(4, 5, fmt, density=0.5, seed=9)
    _, _, f = run_case(item_list_grad_op, fmt, [X65[fmt], gz])
    assert f.linked.host_reads == []


ROWS, COLS = np.array([0, 2, 5, -1], "int64"), np.array([1, 4, 0, -2], "int64")


def item_2lists(pt, sp, fmt):
    x = _s(sp, fmt)
    out = sp.get_item_2lists(x, ROWS[:3], COLS[:3])
    return [x], [out, sp.get_item_2lists(x, ROWS, COLS), _grad(pt)((out ** 2).sum(), x)]


def item_2lists_grad_op(pt, sp, fmt):
    x, gz = _s(sp, fmt), pt.dvector("gz")
    return [x, gz], sp.get_item_2lists_grad(x, np.array([5, 0, 2]), np.array([1, 3, 3]), gz)


@pytest.mark.parametrize("fmt", FORMATS)
def test_get_item_2lists_and_grad(fmt):
    """``test_get_item_2lists_and_grad``: lookups by binary search in the
    sorted keys (negative indices numpy's; the oracle's gradient refuses
    them), nothing read back."""
    _, _, f = run_case(item_2lists, fmt, [X65[fmt]])
    assert f.linked.host_reads == []
    run_case(item_2lists_grad_op, fmt, [X65[fmt], rng.standard_normal(3)])


def diagonal(pt, sp, fmt):
    x = _s(sp, fmt)
    d = sp.diag(x)
    return [x], [d, x.diagonal(), _grad(pt)((d ** 2).sum(), x)]


def construct(pt, sp, fmt):
    x = _s(sp, fmt)
    vals = pt.as_tensor_variable(np.arange(10, dtype="float64").reshape(2, 5))
    return [x], [sp.construct_sparse_from_list(x, vals, np.array([1, 1], "int64")),
                 sp.construct_sparse_from_list(x, vals, np.array([4, 0], "int64"))]


@pytest.mark.parametrize("fmt", FORMATS)
def test_diag_and_construct_sparse_from_list(fmt):
    """``test_diag_both_backends_and_grad`` (its gradient
    ``square_diagonal``) and ``test_construct_sparse_from_list``: rows
    given twice sum in the dense value, as the oracle's."""
    run_case(diagonal, fmt, [SQ[fmt]], structure=False)
    got, want, _ = run_case(construct, fmt, [X65[fmt]], structure=False)
    np.testing.assert_array_equal(scipy_of(got[1]).indptr, want[1].asformat("csr").indptr
                                  if fmt == "csr" else scipy_of(got[1]).indptr)
    expected = np.zeros((6, 5))
    expected[1] = np.arange(5) + (np.arange(5) + 5)
    np.testing.assert_array_equal(dense_of(got[0]), expected)


# --- linalg.py ------------------------------------------------------------------------------

def blocks(pt, sp, fmt):
    a, b = pt.dmatrix("a"), pt.dmatrix("b")
    out = sp.block_diag(a, b, format=fmt)
    return [a, b], [out, _grad(pt)(sp.sp_sum(sp.mul(out, out)), a)]


@pytest.mark.parametrize("fmt", FORMATS)
def test_block_diag_and_grad(fmt):
    """``test_block_diag``: every entry of each block stored (a zero
    too, as scipy's ``block_diag`` stores it), and the gradient."""
    av = np.arange(4.0).reshape(2, 2)
    bv = np.arange(9.0).reshape(3, 3) + 10
    got, _, f = run_case(blocks, fmt, [av, bv])
    np.testing.assert_allclose(got[1].numpy(), 2 * av, rtol=1e-12)
    assert scipy_of(got[0]).nnz == 13


# --- compat.py ------------------------------------------------------------------------------

UNARY = ["sin", "tan", "arcsin", "arcsinh", "arctan", "arctanh", "sinh", "tanh", "ceil",
         "floor", "rint", "sign", "sgn", "sqr", "sqrt", "log1p", "expm1", "deg2rad", "rad2deg",
         "trunc", "neg", "abs", "conj", "structured_exp", "structured_log",
         "structured_sigmoid", "structured_conjugate", "sp_ones_like", "sp_zeros_like"]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", UNARY)
def test_structured_unary(name, fmt):
    """``test_structured_unary``/``test_structured_unary_data_only``: the
    stored data only (``CSMProperties`` -> ``CSM``)."""
    def case(pt, sp, fmt):
        x = _s(sp, fmt)
        out = getattr(sp, name)(x)
        return [x], [out, sp.dense_from_sparse(out)]

    A = abs(X65[fmt]) * 0.9
    _, _, f = run_case(case, fmt, [A])
    assert f.linked.host_reads == []


def binary_structured(pt, sp, fmt):
    x, v = _s(sp, fmt), pt.dvector("v")
    return [x, v], [sp.structured_pow(x, 3.0), sp.structured_minimum(x, 0.3),
                    sp.structured_maximum(x, 0.3), sp.structured_add(x, 2.0),
                    sp.structured_add_s_v(x, v), sp.structured_elemwise(pt.exp, x)]


def casts(pt, sp, fmt):
    x = _s(sp, fmt)
    return [x], [sp.cast(x, "float32"), sp.cast(x, "int32"), sp.fcast(x), sp.dcast(x),
                 sp.icast(x * 10.0), sp.lcast(x * 10.0), sp.bcast(x * 10.0),
                 sp.wcast(x * 10.0), x.astype("float32"), sp.Cast("float32")(x)]


def compares(pt, sp, fmt):
    x, y, d = _s(sp, fmt), _s(sp, fmt, "y"), pt.dmatrix("d")
    return [x, y, d], [sp.eq(x, y), sp.neq(x, y), sp.lt(x, y), sp.le(x, d), sp.gt(x, d),
                       sp.ge(x, 0.5), sp.minimum(x, y), sp.EqualSS()(x, x),
                       sp.GreaterThanSD()(x, d)]


def subs(pt, sp, fmt):
    x, y, d = _s(sp, fmt), _s(sp, fmt, "y"), pt.dmatrix("d")
    return [x, y, d], [sp.sub(x, y), sp.sub(x, x), sp.subtract(x, d), x - y, x - d]


def scales(pt, sp, fmt):
    x, r, c = _s(sp, fmt), pt.dvector("r"), pt.dvector("c")
    return [x, r, c], [sp.row_scale(x, r), sp.col_scale(x, c), sp.RowScaleCSC()(x, r),
                       sp.ColScaleCSC()(x, c)]


def cleanups(pt, sp, fmt):
    x = _s(sp, fmt)
    return [x], [sp.remove0(x), sp.ensure_sorted_indices(x), sp.clean(x)]


def lookups(pt, sp, fmt):
    x, v = _s(sp, fmt), pt.dvector("v")
    return [x, v], [sp.get_item_2d(x, 2, 3), sp.GetItem2d()(x, 0, 1), sp.square_diagonal(v)]


def products(pt, sp, fmt):
    x, y, b, g = _s(sp, fmt), _s(sp, fmt, "y"), pt.dmatrix("b"), pt.dmatrix("g")
    return [x, y, b, g], [sp.add_s_s_data(x, x), sp.AddSSData()(x, sp.neg(x)),
                          sp.structured_dot_grad(x, b, g), sp.sdg_csr(x, b, g),
                          sp.StructuredDotGradCSC()(x, b, g), sp.TrueDot()(x, b),
                          sp.Dot()(x, b), sp.SparseDenseMultiply()(x, 2.0),
                          sp.StructuredAddSV()(x, b[:, 0] if fmt == "csr" else g[:, 0]),
                          sp.mul_s_d(x, 3.0)]


CASES = {
    # structured_add_s_v adds v at the minor indices: the columns of csr,
    # the rows of csc
    "structured_binary": (binary_structured, lambda f: [rng.standard_normal(5 if f == "csr"
                                                                          else 6)],
                          {"AdvancedSubtensor1"}),
    "casts": (casts, lambda f: [], set()),
    "comparisons": (compares, lambda f: [Y65[f], rng.standard_normal((6, 5))], set()),
    "sub": (subs, lambda f: [Y65[f], rng.standard_normal((6, 5))], {"AddSS"}),
    "row_col_scale": (scales, lambda f: [rng.standard_normal(6), rng.standard_normal(5)],
                      {"AdvancedSubtensor1"}),
    "cleanups": (cleanups, lambda f: [], {"Remove0"}),
    "cleanups_of_stored_zeros": (cleanups, lambda f: [], {"Remove0"}),
    "lookups": (lookups, lambda f: [rng.standard_normal(4)], set()),
    "products": (products, lambda f: [Y65[f], rng.standard_normal((5, 3)),
                                      rng.standard_normal((6, 3))], {"AdvancedSubtensor1"}),
}


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("name", sorted(CASES))
def test_compat(name, fmt):
    """``TestSparseCompat`` and the grids' comparisons, casts, scales and
    cleanups, with every function and compositional class of
    ``compat.py``: only ``AddSS`` (sparse ``sub``) and ``Remove0`` read
    their counts back; a vector indexed by the minor indices (a csr
    matrix's column scale, a csc matrix's row scale,
    ``structured_add_s_v``) has their bounds read, where the row ids of
    the major scale give theirs (``_MajorIds``)."""
    case, extra, reads = CASES[name]
    x = X65[fmt]
    if name == "cleanups_of_stored_zeros":
        # ``test_remove0_and_clean``: two stored zeros
        x = x.copy()
        x.data[[0, 3]] = 0.0
    _, _, f = run_case(case, fmt, [x, *extra(fmt)])
    assert _reads(f) == reads


def test_remove0_keeps_zeros_in_the_xla_path():
    """Reference behaviour: ``remove0`` of a matrix holding 2 stored zeros
    keeps all 8 entries in the XLA path (an identity on the device); the
    oracle and the port drop them."""
    S = ssp.random(4, 5, density=0.4, format="csr", random_state=1)
    S.data[[1, 4]] = 0.0

    def case(pt, sp, fmt):
        x = _s(sp, fmt)
        return [x], sp.csm_data(sp.remove0(x))

    ins, outs = build(JAX, case, "csr")
    xla = jptt.function(ins, outs)(S)[0]
    got, _, _ = run_case(case, "csr", [S])
    assert (len(np.asarray(xla)), got[0].shape[0]) == (8, 6)


def test_structured_exp_grad():
    """``TestSparseStructuredGrads``: the gradient of
    ``sp_sum(structured_exp(x))`` is ``exp`` at the pattern."""
    def case(pt, sp, fmt):
        x = sp.csr_matrix("x", dtype="float64")
        return [x], _grad(pt)(sp.sp_sum(sp.structured_exp(x)), x)

    got, _, f = run_case(case, "csr", [X65["csr"]])
    exp = X65["csr"].copy()
    exp.data = np.exp(exp.data)
    np.testing.assert_allclose(dense_of(got[0]), exp.toarray(), rtol=1e-12)
    assert f.linked.host_reads == []


# --- variable.py ----------------------------------------------------------------------------

def operators(pt, sp, fmt):
    x, y, d, v = _s(sp, fmt), _s(sp, fmt, "y"), pt.dmatrix("d"), pt.dvector("v")
    return [x, y, d, v], [x + y, x + d, x - y, x - d, x * y, x * 2.0, 2.0 * x, -x,
                          x @ v, x[1, 2], x[np.array([0, 3])], x.sum(), x.sum(axis=1),
                          x.toarray(), x.todense(), x.astype("float32"), x.T,
                          x.transpose(), x.shape, x.diagonal()]


@pytest.mark.parametrize("fmt", FORMATS)
def test_variable_operators(fmt):
    """Every operator of ``SparseVariable``, and ``dtype`` and
    ``format``."""
    _, _, f = run_case(operators, fmt, [X65[fmt], Y65[fmt], rng.standard_normal((6, 5)),
                                       rng.standard_normal(5)])
    assert _reads(f) == {"AddSS", "MulSS", "GetItemList"}
    _, pt, sp = PORT
    x = _s(sp, fmt)
    assert (x.dtype, x.format) == ("float64", fmt)


def test_square_diagonal_of_a_shared_free_vector():
    """``test_diag_square_diagonal``/``test_diag_square_diagonal_getitem``:
    ``square_diagonal`` of a constant vector and of an input."""
    v = rng.standard_normal(4)

    def case(pt, sp, fmt):
        d = pt.dvector("d")
        return [d], [sp.square_diagonal(d), sp.dense_from_sparse(sp.square_diagonal(d)),
                     sp.square_diagonal(pt.as_tensor_variable(v))]

    got, _, _ = run_case(case, "csr", [v])
    np.testing.assert_allclose(dense_of(got[1]), np.diag(v), rtol=1e-12)


def test_ops_on_a_csm_with_an_unsorted_row_and_a_duplicate():
    """The ops that look entries up or combine patterns on a triple kept
    as ``CSM`` got it (columns out of order, one given twice): their dense
    values are the oracle's."""
    data = rng.standard_normal(6)
    indices = np.array([2, 0, 3, 1, 3, 0], "int32")
    indptr = np.array([0, 2, 5, 6], "int32")

    def case(pt, sp, fmt):
        d, y = pt.dvector("d"), sp.csr_matrix("y", dtype="float64")
        x = sp.CSM("csr")(d, indices, indptr, np.array([3, 4]))
        return [d, y], [sp.get_item_scalar(x, 1, 3), sp.get_item_2lists(x, [1, 0, 2], [3, 2, 0]),
                        sp.dense_from_sparse(sp.mul(x, y)), sp.dense_from_sparse(sp.add(x, y)),
                        sp.diag(x), sp.dense_from_sparse(sp.ensure_sorted_indices(x)),
                        sp.dense_from_sparse(sp.remove0(x)),
                        sp.dense_from_sparse(sp.get_item_list(x, [1, 1]))]

    Y = ssp.csr_matrix(np.array([[1.0, 0, 2, 0], [0, 3, 0, 4], [5, 0, 0, 6]]))
    run_case(case, "csr", [data, Y])


def test_plain_format_helpers_and_sparse_formats():
    for _, _, sp in (JAX, PORT):
        assert sp.sparse_formats == ["csr", "csc"]
        assert sp.csr_dmatrix().type.dtype == "float64"
        assert sp.csc_fmatrix().type.format == "csc"
        assert "float32" in sp.float_dtypes and "int8" in sp.discrete_dtypes
    assert ops_of(tptt.function([], PORT[2].sp_sum(PORT[2].square_diagonal(
        PORT[1].as_tensor_variable(np.ones(3)))), device="cpu")) == []


def test_row_scale_by_a_short_vector_raises_without_a_read():
    """The major scale's row ids give the host their bounds when they are
    computed (their lowering's ``bounded`` port), so its gather reads
    nothing back and still raises on a vector shorter than the rows, as
    the JAX package's oracle does."""
    fns = []
    for (ptt, pt, sp), kw in ((PORT, {"device": "cpu"}), (JAX, {"mode": "FAST_COMPILE"})):
        x, v = _s(sp, "csr"), pt.vector("v", dtype="float64")
        fns.append(ptt.function([x, v], sp.row_scale(x, v), **kw))
    f, oracle = fns
    assert f.linked.host_reads == []
    full = rng.standard_normal(6)
    np.testing.assert_allclose(scipy_of(f(X65["csr"], full)).toarray(),
                               scipy_of(oracle(X65["csr"], full)).toarray(), rtol=1e-12)
    with pytest.raises(IndexError):
        oracle(X65["csr"], full[:4])
    with pytest.raises(IndexError):
        f(X65["csr"], full[:4])

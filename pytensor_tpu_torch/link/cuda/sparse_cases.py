"""The rows of the sparse slice's path on the card: one function for each
sparse op that paths (a) and (b) of ``models/sparse_learning.py`` do not
run, at sizes taken from them.

Each row is ``Row(name, op, build, args, reference, reads)``: ``build(pt,
sparse, data)`` builds ``(inputs, outputs)`` from a package's tensor and
sparse namespaces; ``args(data)`` gives the input values (scipy matrices
and numpy arrays, float32); ``reference(data)`` the outputs in float64
scipy/NumPy; ``reads`` the op whose count of stored entries the row reads
back (its plan then runs eagerly), or None where the plan may be
captured.  ``make_data(sizes, seed)`` makes the matrices from one seed:
(a)'s pattern (``benchsuite.py:160``, 65,536², ten a row), (b)'s tf-idf
matrix (11,314 x 130,107, ~158 a row), MovieLens-1M's pattern (6,040
users x 3,706 movies, 1,000,209 ratings of 1-5, drawn uniformly), a
4,096² dense matrix at 1 % density and 256 dense 64 x 64 blocks.
``FULL`` are the card's sizes, ``SMALL`` the CPU tests'.
``output(value)`` turns a row's output into what the comparison reads:
a dense array, or a sparse value's triple as stored; ``held`` compares
two, the structure as stored where the reference's is canonical.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np

FULL = {"edge_n": 65536, "edge_row": 10, "width": 16, "docs": 11314, "terms": 130107,
        "per_doc": 158, "users": 6040, "movies": 3706, "ratings": 1000209, "rank": 64,
        "side": 4096, "density": 0.01, "picks": 1024, "blocks": 256, "block": 64,
        "dense_rows": 256}
# a few dozen rows of each: the CPU tests', and the graphs whose K1 kernels
# phase 2 builds (the graphs and sources do not depend on the sizes)
SMALL = dict(FULL, edge_n=256, docs=64, terms=512, per_doc=8, users=32, movies=24, ratings=100,
             side=64, picks=16, blocks=4, dense_rows=8)


class Row(NamedTuple):
    name: str
    op: str
    build: Callable
    args: Callable
    reference: Callable
    reads: str | None


def make_data(sizes=FULL, seed=0):
    """The rows' matrices and operands, float32, from ``seed``: (a)'s
    pattern ``A`` with its values ``w`` and operands ``Y``, ``Z``, (b)'s
    matrix ``X``, and the rest."""
    import scipy.sparse as sp

    from pytensor_tpu_torch.models.sparse_learning import edge_pattern, tfidf_matrix

    s = sizes
    A, w, Y16, Z16 = edge_pattern(s["edge_n"], s["edge_row"], s["width"], seed)
    X, _ = tfidf_matrix(s["docs"], s["terms"], s["per_doc"], seed=seed + 1)
    rng = np.random.default_rng(seed + 2)
    n_cells = s["users"] * s["movies"]
    cells = np.sort(rng.choice(n_cells, size=s["ratings"], replace=False))
    ratings = sp.csr_matrix((rng.integers(1, 6, s["ratings"]).astype("float32"),
                             (cells // s["movies"], cells % s["movies"])),
                            shape=(s["users"], s["movies"]))
    dense = (rng.standard_normal((s["side"], s["side"]))
             * (rng.random((s["side"], s["side"])) < s["density"])).astype("float32")
    zeroed = A.copy()
    zeroed.data[rng.random(A.nnz) < 0.1] = 0.0
    n = A.shape[0]
    stored = rng.choice(A.nnz, s["picks"] // 2, replace=False)
    rows_of = np.repeat(np.arange(n), np.diff(A.indptr))
    return {
        "A": A, "w": w, "AT": (A + A.T).tocsr().astype("float32"), "zeroed": zeroed,
        "Y": Y16, "Z": Z16, "v": rng.standard_normal(n).astype("float32"),
        "X": X, "D": rng.standard_normal((s["dense_rows"], s["terms"])).astype("float32"),
        "ratings": ratings,
        "U": rng.standard_normal((s["users"], s["rank"])).astype("float32"),
        "M": rng.standard_normal((s["movies"], s["rank"])).astype("float32"),
        "dense": dense,
        "pick_rows": rng.choice(s["docs"], s["picks"]).astype("int64"),
        "pair_rows": np.concatenate([rows_of[stored], rng.integers(0, n, s["picks"] // 2)]),
        "pair_cols": np.concatenate([A.indices[stored], rng.integers(0, n, s["picks"] // 2)]),
        "item": (int(rows_of[stored[0]]), int(A.indices[stored[0]])),
        "blocks": rng.standard_normal((s["blocks"], s["block"], s["block"])).astype("float32"),
        "dense_rows": s["dense_rows"],
    }


def _csr(sparse, name):
    return sparse.csr_matrix(name, dtype="float32")


def _sampling_dot(pt, sparse, d):
    x, y = pt.matrix("x", dtype="float32"), pt.matrix("y", dtype="float32")
    p = _csr(sparse, "p")
    return [x, y, p], [sparse.sampling_dot(x, y, p)]


def _sampling_ref(d):
    p = d["ratings"]
    rows = np.repeat(np.arange(p.shape[0]), np.diff(p.indptr))
    vals = np.einsum("ij,ij->i", d["U"][rows].astype("float64"),
                     d["M"][p.indices].astype("float64"))
    import scipy.sparse as sp

    return [sp.csr_matrix((vals, p.indices, p.indptr), shape=p.shape)]


def _usmm(pt, sparse, d):
    s, y, z = _csr(sparse, "s"), pt.matrix("y", dtype="float32"), pt.matrix("z", dtype="float32")
    return [s, y, z], [sparse.structured_dot(s, y) + z]


def _add_sd(pt, sparse, d):
    s, x = _csr(sparse, "s"), pt.matrix("x", dtype="float32")
    return [s, x], [sparse.add(s, x)]


def _binary(fn):
    def build(pt, sparse, d):
        s, t = _csr(sparse, "s"), _csr(sparse, "t")
        return [s, t], [getattr(sparse, fn)(s, t)]

    return build


def _mul_sv(pt, sparse, d):
    s, v = _csr(sparse, "s"), pt.vector("v", dtype="float32")
    return [s, v], [sparse.mul(s, v), sparse.mul(s, np.float32(0.5))]


def _stack(fn):
    def build(pt, sparse, d):
        s, t = _csr(sparse, "s"), _csr(sparse, "t")
        return [s, t], [getattr(sparse, fn)([s, t], format="csr")]

    return build


def _halves(d, axis):
    X = d["X"]
    if axis == 1:
        k = X.shape[1] // 2
        return [X[:, :k].tocsr(), X[:, k:].tocsr()]
    k = X.shape[0] // 2
    return [X[:k], X[k:]]


def _from_dense(pt, sparse, d):
    x = pt.matrix("x", dtype="float32")
    return [x], [sparse.csr_from_dense(x)]


def _unary(fn):
    def build(pt, sparse, d):
        s = _csr(sparse, "s")
        return [s], [getattr(sparse, fn)(s)]

    return build


def _get_item_list(pt, sparse, d):
    s, idx = _csr(sparse, "s"), pt.vector("idx", dtype="int64")
    return [s, idx], [sparse.get_item_list(s, idx)]


def _get_item_2lists(pt, sparse, d):
    s = _csr(sparse, "s")
    r, c = pt.vector("r", dtype="int64"), pt.vector("c", dtype="int64")
    return [s, r, c], [sparse.get_item_2lists(s, r, c)]


def _get_item_scalar(pt, sparse, d):
    s, i, j = _csr(sparse, "s"), pt.scalar("i", dtype="int64"), pt.scalar("j", dtype="int64")
    return [s, i, j], [sparse.get_item_scalar(s, i, j)]


def _block_diag(pt, sparse, d):
    blocks = [pt.matrix(f"b{k}", dtype="float32") for k in range(len(d["blocks"]))]
    return blocks, [sparse.block_diag(*blocks, format="csr")]


def _f64(M):
    return M.astype("float64")


ROWS = [
    Row("sampling_dot MovieLens-1M rank 64", "SamplingDot", _sampling_dot,
        lambda d: [d["U"], d["M"], d["ratings"]], _sampling_ref, None),
    Row("usmm (a)'s A, width 16", "Usmm", _usmm, lambda d: [d["A"], d["Y"], d["Z"]],
        lambda d: [_f64(d["A"]) @ _f64(d["Y"]) + d["Z"]], None),
    Row("add_s_d (b)'s rows, dense", "AddSD", _add_sd,
        lambda d: [d["X"][:d["dense_rows"]], d["D"]],
        lambda d: [_f64(d["X"][:d["dense_rows"]]).toarray() + d["D"]], None),
    Row("add_s_s A + (A + A^T)", "AddSS", _binary("add"), lambda d: [d["A"], d["AT"]],
        lambda d: [(_f64(d["A"]) + _f64(d["AT"])).tocsr()], "AddSS"),
    Row("mul_s_v A by a vector and by 0.5", "MulSV", _mul_sv, lambda d: [d["A"], d["v"]],
        lambda d: [_f64(d["A"]).multiply(d["v"].astype("float64")).tocsr(),
                   _f64(d["A"]) * 0.5], None),
    Row("mul_s_s A * (A + A^T)", "MulSS", _binary("mul"), lambda d: [d["A"], d["AT"]],
        lambda d: [_f64(d["A"]).multiply(_f64(d["AT"])).tocsr()], "MulSS"),
    Row("hstack (b)'s column halves", "HStack", _stack("hstack"),
        lambda d: _halves(d, 1), lambda d: [d["X"].astype("float64")], None),
    Row("vstack (b)'s row halves", "VStack", _stack("vstack"),
        lambda d: _halves(d, 0), lambda d: [d["X"].astype("float64")], None),
    Row("csr_from_dense 4,096^2 at 1 %", "SparseFromDense", _from_dense,
        lambda d: [d["dense"]], lambda d: [_sparse_of(d["dense"])],
        "SparseFromDense{format='csr'}"),
    Row("remove0 A with 10 % zeros", "Remove0", _unary("remove0"), lambda d: [d["zeroed"]],
        lambda d: [_eliminated(d["zeroed"])], "Remove0"),
    Row("get_item_list (b)'s rows", "GetItemList", _get_item_list,
        lambda d: [d["X"], d["pick_rows"]], lambda d: [_f64(d["X"])[d["pick_rows"]]],
        "GetItemList"),
    Row("get_item_2lists A", "GetItem2Lists", _get_item_2lists,
        lambda d: [d["A"], d["pair_rows"], d["pair_cols"]],
        lambda d: [np.asarray(_f64(d["A"])[d["pair_rows"], d["pair_cols"]]).ravel()], None),
    Row("get_item_scalar A", "GetItemScalar", _get_item_scalar,
        lambda d: [d["A"], np.int64(d["item"][0]), np.int64(d["item"][1])],
        lambda d: [np.float64(d["A"][d["item"]])], None),
    Row("diag A", "Diag", _unary("diag"), lambda d: [d["A"]],
        lambda d: [_f64(d["A"]).diagonal()], None),
    Row("block_diag 256 x 64^2", "SparseBlockDiagonal", _block_diag,
        lambda d: list(d["blocks"]), lambda d: [_block_ref(d["blocks"])], None),
]


def _sparse_of(dense):
    import scipy.sparse as sp

    return sp.csr_matrix(dense.astype("float64"))


def _eliminated(A):
    out = _f64(A).tocsr()
    out.eliminate_zeros()
    return out


def _block_ref(blocks):
    import scipy.sparse as sp

    return sp.block_diag([b.astype("float64") for b in blocks], format="csr")


def output(value):
    """A row's output as what the comparison reads: a dense numpy array,
    or for a sparse value (a torch sparse tensor or a scipy matrix) its
    compressed triple as stored, ``(format, indptr, indices, data,
    shape)``, duplicates and column order as they are."""
    import scipy.sparse as sp

    if sp.issparse(value):
        m = value if value.format in ("csr", "csc") else value.tocsr()
        return (m.format, m.indptr.astype("int64"), m.indices.astype("int64"), m.data, m.shape)
    import torch

    if isinstance(value, torch.Tensor):
        if value.layout == torch.strided:
            return value.detach().cpu().numpy()
        csr = value.layout == torch.sparse_csr
        ptr, idx = ((value.crow_indices(), value.col_indices()) if csr
                    else (value.ccol_indices(), value.row_indices()))
        return ("csr" if csr else "csc", ptr.cpu().numpy().astype("int64"),
                idx.cpu().numpy().astype("int64"), value.values().cpu().numpy(),
                tuple(value.shape))
    return np.asarray(value)


def _matrix(triple):
    import scipy.sparse as sp

    fmt, indptr, indices, data, shape = triple
    return (sp.csr_matrix if fmt == "csr" else sp.csc_matrix)((data, indices, indptr),
                                                             shape=shape)


def held(got, want):
    """The largest error of ``got`` against ``want`` (both from ``output``)
    over ``max(1, max|want|)``, with the structure: a sparse pair must
    have the same format, shape, pointers and indices, else the error is
    inf.  Where ``want`` is canonical (no duplicates, indices sorted) the
    triple of ``got`` is held as stored; where it is not, both are summed
    and sorted first."""
    if isinstance(want, tuple):
        if not isinstance(got, tuple) or got[0] != want[0] or tuple(got[4]) != tuple(want[4]):
            return float("inf")
        if not _matrix(want).has_canonical_format:
            got, want = (output(_canonical(_matrix(t))) for t in (got, want))
        if not (np.array_equal(got[1], want[1]) and np.array_equal(got[2], want[2])):
            return float("inf")
        got, want = got[3], want[3]
    got, want = np.asarray(got, "float64"), np.asarray(want, "float64")
    if got.shape != want.shape:
        return float("inf")
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    return float(np.abs(got - want).max(initial=0.0)) / scale


def _canonical(m):
    m = m.copy()
    m.sum_duplicates()
    m.sort_indices()
    return m


def row_function(row, data, device):
    """The port's function of ``row`` on ``device``."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch import sparse

    ins, outs = row.build(pt, sparse, data)
    return ptt.function(ins, outs, device=device, name=row.name)

"""The sparse slice's two paths (``models/sparse_learning.py``) at small
size, in both packages, on the CPU.

(a) Learned edge weights on ``benchsuite.py:160``'s pattern (300 rows,
five stored entries a row, width 4, float32): the rewritten graph op for
op the JAX package's ``FAST_RUN`` graph, the same rewrites firing as often
(``local_csm_grad_same_pattern`` in neither: the cotangent's pattern is
computed, x's a constant), the plan captured (no host read), and the
loss and gradient against the JAX package's oracle and float64 scipy.
The JAX package's XLA path raises on this graph (pinned in
``test_torch_sparse_ops.py``).

(b) The tf-idf softmax-regression step (240 documents, 1,200 terms, 5
classes, ~20 terms a document, float32): op for op, captured, and two
SGD steps (loss, ``W``, ``b``) against the JAX package's oracle and the
float64 NumPy step.

(c) Each row of ``link/cuda/sparse_cases.py`` (``chip_smoke.py`` phase 25's
one function an op) at a few dozen rows in both packages, and phase 25
itself rehearsed on the CPU.

Tolerances (float32): the loss ``rtol 2e-6``, the gradient and the
parameters ``2e-6`` of their largest magnitude, against the oracle and
the float64 reference alike.
"""

import numpy as np
import pytest
import torch

from pytensor_tpu_torch.link.cuda import sparse_cases
from pytensor_tpu_torch.models import sparse_learning as sl
from tests.torch_math_probe import _fired
from tests.torch_sparse import JAX, PORT, dense_of, jptt, ops_of, tptt

TOL = 2e-6


def _close(got, want, tol=TOL):
    got, want = np.asarray(got, "float64"), np.asarray(want, "float64")
    scale = max(1.0, float(np.abs(want).max(initial=0.0)))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def test_edge_weights_match_the_jax_package():
    A, w, X, T = sl.edge_pattern(300, 5, 4, seed=1)
    counts, undo = _fired()
    try:
        fns = []
        for side in (JAX, PORT):
            ins, outs = sl.edge_weight_graphs(*side, A, 4)
            fns.append(side[0].function(ins, outs, **({} if side is JAX else
                                                        {"device": "cpu"})))
    finally:
        undo()
    jf, tf = fns
    assert ops_of(tf) == ops_of(jf) == sorted(
        ["CAReduce", "CSM", "CSMGrad", "CSMProperties", "Elemwise", "Elemwise", "Elemwise",
         "Elemwise", "StructuredDot", "StructuredDotGrad"])
    for name in ("local_csm_grad_same_pattern", "local_csm_properties_csm"):
        assert counts["torch"][name] == counts["jax"][name] == 0
    assert tf.linked.host_reads == []
    ins, outs = sl.edge_weight_graphs(*JAX, A, 4)
    oracle = jptt.function(ins, outs, mode="FAST_COMPILE")(w, X, T)
    loss, grad = tf(w, X, T)
    ref_loss, ref_grad = sl.edge_weights_reference(A, w, X, T)
    np.testing.assert_allclose(float(loss), float(oracle[0]), rtol=TOL)
    np.testing.assert_allclose(float(loss), ref_loss, rtol=TOL)
    _close(grad.numpy(), dense_of(oracle[1]))
    _close(grad.numpy(), ref_grad)


def test_edge_weights_gradient_is_the_plain_autograd_gradient():
    """The port's gradient against torch's autograd of the same loss,
    written with torch's own sparse product, in float64."""
    A, w, X, T = sl.edge_pattern(200, 4, 3, seed=2)
    f = sl.make_edge_weights(A, 3, device="cpu")
    _, grad = f(w.astype("float32"), X, T)
    wt = torch.tensor(w, dtype=torch.float64, requires_grad=True)
    W = torch.sparse_csr_tensor(torch.from_numpy(A.indptr.astype("int64")),
                                torch.from_numpy(A.indices.astype("int64")), wt, A.shape)
    loss = ((W @ torch.from_numpy(X).double() - torch.from_numpy(T).double()) ** 2).sum()
    loss.backward()
    _close(grad.numpy(), wt.grad.numpy())


@pytest.mark.parametrize("steps", [1, 2])
def test_tfidf_step_matches_the_jax_package(steps):
    X, Y = sl.tfidf_matrix(240, 1200, 20, 5, seed=3)
    results, fns = [], []
    for side, mode in ((JAX, "FAST_COMPILE"), (PORT, None)):
        ptt, pt, sparse = side
        kw = {} if side is JAX else {"device": "cpu"}
        W = ptt.shared(np.zeros((1200, 5), "float32"), name="W", **kw)
        b = ptt.shared(np.zeros(5, "float32"), name="b", **kw)
        ins, loss, updates = sl.tfidf_graphs(ptt, pt, sparse, W, b, 5)
        f = ptt.function(ins, loss, updates=updates, **({"mode": mode} if mode else kw))
        fns.append(ptt.function(ins, loss, updates=updates, **kw))
        for _ in range(steps):
            out = f(X, Y)
        results.append((float(dense_of(out)), dense_of(W.get_value()), dense_of(b.get_value())))
    assert ops_of(fns[1]) == ops_of(fns[0])
    assert fns[1].linked.host_reads == []
    W, b = np.zeros((1200, 5), "float32"), np.zeros(5, "float32")
    for _ in range(steps):
        loss, W, b = sl.tfidf_reference(X, Y, W, b)
    (t_loss, tW, tb), (j_loss, jW, jb) = results[1], results[0]
    np.testing.assert_allclose(t_loss, j_loss, rtol=TOL)
    np.testing.assert_allclose(t_loss, loss, rtol=TOL)
    for got, want in ((tW, jW), (tW, W), (tb, jb), (tb, b)):
        _close(got, want)


def test_tfidf_step_runs_the_slice_ops():
    """The step's graph holds ``SpSum``, ``MajorIds``, ``CSMProperties``,
    ``CSM``, a ``StructuredDot`` of a 2-d operand and ``Transpose`` (the
    gradient), and its row scale's gather reads nothing back (the row ids'
    bounds come from their producer)."""
    W = tptt.shared(np.zeros((50, 3), "float32"), name="W", device="cpu")
    b = tptt.shared(np.zeros(3, "float32"), name="b", device="cpu")
    ins, loss, updates = sl.tfidf_graphs(*PORT, W, b, 3)
    f = tptt.function(ins, loss, updates=updates, device="cpu")
    ops = ops_of(f)
    for name in ("SpSum", "MajorIds", "CSMProperties", "CSM", "StructuredDot", "Transpose",
                 "AdvancedSubtensor1"):
        assert name in ops, name
    sdot = [nd for nd in f.fgraph.apply_nodes if type(nd.op).__name__ == "StructuredDot"]
    assert any(nd.inputs[1].type.ndim == 2 for nd in sdot)
    assert f.linked.host_reads == []


def test_tfidf_matrix_is_shaped_like_20newsgroups():
    """The full-size matrix's shape and its stored entries a row (its
    values positive, canonical), without building a function."""
    X, Y = sl.tfidf_matrix(seed=0)
    assert X.shape == (11314, 130107) and Y.shape == (11314, 20)
    assert 150 < X.nnz / X.shape[0] < 160
    assert X.has_canonical_format and (X.data > 0).all()
    A, w, Xe, Te = sl.edge_pattern(seed=0)
    assert A.shape == (65536, 65536) and abs(A.nnz - 655360) < 100
    assert Xe.shape == Te.shape == (65536, 16)


# --- the rows of chip_smoke.py phase 25 (c), and the phase itself, at small size ----------

SMALL = sparse_cases.SMALL
_DATA = {}


def _small_data():
    if not _DATA:
        _DATA.update(sparse_cases.make_data(SMALL, 3))
    return _DATA


@pytest.mark.parametrize("row", sparse_cases.ROWS, ids=[r.op for r in sparse_cases.ROWS])
def test_sparse_rows_match_the_jax_package(row):
    """Each row of ``link/cuda/sparse_cases.py``: the port's graph op for op
    the JAX package's ``FAST_RUN`` graph, no fused node (so phase 2 builds
    no K1 kernel for it), the read the row declares, and its outputs
    against the JAX package's oracle and float64 scipy (float32: ``TOL``
    of the largest magnitude; the structure exact)."""
    d = _small_data()
    j_ins, j_outs = row.build(JAX[1], JAX[2], d)
    jf = jptt.function(j_ins, j_outs)
    oracle = jptt.function(j_ins, j_outs, mode="FAST_COMPILE")(*row.args(d))
    f = sparse_cases.row_function(row, d, "cpu")
    assert ops_of(f) == ops_of(jf)
    assert "FusedElemwise" not in ops_of(f)
    assert sorted({r.split("(")[0] for r in f.linked.host_reads}) == (
        [row.reads] if row.reads else [])
    out = f(*row.args(d))
    out = out if isinstance(out, list) else [out]
    for got, want, ref in zip(out, oracle, row.reference(d)):
        got = sparse_cases.output(got)
        assert sparse_cases.held(got, sparse_cases.output(want)) <= TOL
        assert sparse_cases.held(got, sparse_cases.output(ref)) <= TOL


def test_held_reads_the_structure_as_stored():
    """``sparse_cases.held`` holds a sparse output's triple as stored
    against a canonical reference: a row's columns out of order, or a
    stored entry split in two, fail it with the same dense value; against
    a reference that keeps duplicates both are summed and sorted first."""
    import scipy.sparse as ssp

    want = ssp.csr_matrix(np.array([[1.0, 0.0, 2.0], [0.0, 3.0, 0.0]]))
    ok = torch.sparse_csr_tensor(torch.tensor([0, 2, 3]), torch.tensor([0, 2, 1]),
                                 torch.tensor([1.0, 2.0, 3.0]), (2, 3))
    unsorted = torch.sparse_csr_tensor(torch.tensor([0, 2, 3]), torch.tensor([2, 0, 1]),
                                       torch.tensor([2.0, 1.0, 3.0]), (2, 3))
    split = torch.sparse_csr_tensor(torch.tensor([0, 3, 4]), torch.tensor([0, 0, 2, 1]),
                                    torch.tensor([0.5, 0.5, 2.0, 3.0]), (2, 3))
    ref = sparse_cases.output(want)
    assert sparse_cases.held(sparse_cases.output(ok), ref) == 0.0
    for bad in (unsorted, split):
        assert sparse_cases.held(sparse_cases.output(bad), ref) == float("inf")
    dup = ssp.csr_matrix((np.array([0.5, 0.5, 2.0, 3.0]), np.array([0, 0, 2, 1]),
                          np.array([0, 3, 4])), shape=(2, 3))
    assert sparse_cases.held(sparse_cases.output(ok), sparse_cases.output(dup)) == 0.0


def test_phase_25_rehearses_on_the_cpu():
    """``chip_smoke.py``'s phase 25 on the CPU at small size (values only:
    its times and traces are the card's), with its references."""
    import chip_smoke

    threads = torch.get_num_threads()
    try:
        ref = chip_smoke.sparse_cpu_reference(sizes=SMALL)
        launches, k1_abs, row = chip_smoke.phase_sparse(torch.device("cpu"), "cpu", ref)
    finally:
        torch.set_num_threads(threads)
    assert set(row["rows"]) == {r.name for r in sparse_cases.ROWS}
    assert row["edge_weights"]["captured"] and row["edge_weights"]["same_pattern_fired"] == 0
    assert row["tfidf_step"]["host_reads"] == []
    assert set(launches) == {"sparse edge weights", "sparse tf-idf step"} and k1_abs == 0.0

"""The port's sparse slice against the JAX package's, on the CPU.

The same scipy matrix and the same numpy ``x``, made from one seed, go
through both packages: ``structured_dot``, the routed rewrite
``local_structured_dot_to_routed``, the gradient graph, the
``train_loop`` power iteration of ``benchsuite.py:160 ours_sparse`` (at
1,500 rows) and the fallback ``StructuredDot`` lowering.  The JAX side
runs as ``tests/test_spmv_routed.py`` runs it: its routed SpMV on the
CPU, where ``lane_gather`` takes ``jnp.take_along_axis``.  The port's
``RoutedSpMV`` runs K4's plain version here.

By design the two ops differ in their inputs: the JAX op takes eight
routing tables of a TPU plan, the port's the canonical CSR of A
(``indptr``, ``indices``, ``data``).  Both take the operand first and
rewrite the same graphs.  Tolerances: ``atol 1e-4`` on float32 matvecs
as the JAX tests use, ``rtol 1e-4`` on the gradient graph, ``rtol
2e-4``/``atol 2e-5`` on three power-iteration steps as
``test_spmv_routed.py:214-221``, ``rtol 1e-12`` in float64.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
from pytensor_tpu import sparse as jsparse
from pytensor_tpu.config import config as jconfig
from pytensor_tpu.scan.op import Scan as JScan
from pytensor_tpu.sparse.spmv import plan_spmv as jplan_spmv

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch import sparse as tsparse
from pytensor_tpu_torch.config import config as tconfig
from pytensor_tpu_torch.link.torch.convert import CSR, sparse_as_torch
from pytensor_tpu_torch.link.torch.dispatch import torch_funcify
from pytensor_tpu_torch.scan.op import Scan as TScan
from pytensor_tpu_torch.sparse.spmv import plan_spmv as tplan_spmv

JAX = (jptt, jpt, jsparse, {})
PORT = (tptt, tpt, tsparse, {"device": "cpu"})


def _ops(fn):
    return sorted(type(nd.op).__name__ for nd in fn.fgraph.apply_nodes)


def _random(n_rows, n_cols, density, seed, dtype="float32"):
    rng = np.random.default_rng(seed)
    return sp.random(n_rows, n_cols, density=density, format="csr", random_state=rng,
                     dtype=dtype), rng


def _matvec(side, A, shape, dtype="float32"):
    ptt, pt, sparse, kw = side
    x = pt.tensor("x", dtype=dtype, shape=shape)
    return ptt.function([x], sparse.structured_dot(sparse.as_sparse_variable(A), x), **kw)


def _out(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


# --- (a) where the routed rewrite fires ---------------------------------------

@pytest.mark.parametrize("M,N,dens", [
    (300, 260, 0.05), (128, 128, 0.1), (1000, 700, 0.01), (64, 500, 0.02), (513, 513, 0.03),
])
def test_plan_gate_matches_jax(M, N, dens):
    """The cases of test_spmv_routed.py:82-85: the port's plan sizes are
    the JAX plan's, and both accept the matrix."""
    A, _ = _random(M, N, dens, M + N)
    jplan, tplan = jplan_spmv(A), tplan_spmv(A)
    assert jplan is not None and tplan is not None
    assert {k: tplan[k] for k in ("M", "N", "D2", "Kg", "K2", "K")} == \
        {k: jplan[k] for k in ("M", "N", "D2", "Kg", "K2", "K")}


def _long_row(n_long):
    """1,500 x 1,500 at density 0.005, float32, with row 0 holding
    ``n_long`` nonzeros."""
    A, _ = _random(1500, 1500, 0.005, 21)
    A = A.tolil()
    A[0, :] = 0
    A[0, :n_long] = np.arange(1, n_long + 1, dtype="float32")
    return A.tocsr()


def _wide_k():
    """129 output chunks of 128 rows with one row of 128 nonzeros: the
    plan's K2 = 129 * 128 passes 16,384."""
    A, _ = _random(129 * 128, 600, 5000 / (129 * 128 * 600), 22)
    A = A.tolil()
    A[5, :] = 0
    A[5, :128] = 1.0
    return A.tocsr()


ELIGIBILITY = {
    "fires": (lambda: _random(1500, 1500, 0.005, 5)[0], "float32", True, True),
    "fires_long_row_128": (lambda: _long_row(128), "float32", True, True),
    "under_4096_nnz": (lambda: _random(80, 80, 0.05, 10)[0], "float32", True, False),
    "float64": (lambda: _random(1500, 1500, 0.01, 11, "float64")[0], "float64", True, False),
    "flag_off": (lambda: _random(1500, 1500, 0.01, 12)[0], "float32", False, False),
    "row_of_200": (lambda: _long_row(200), "float32", True, False),
    "k_over_16384": (_wide_k, "float32", True, False),
}


@pytest.mark.parametrize("case", sorted(ELIGIBILITY))
def test_rewrite_fires_where_jax_fires(case):
    make, dtype, flag, fires = ELIGIBILITY[case]
    A = make()
    found = []
    for side, cfg in ((JAX, jconfig), (PORT, tconfig)):
        with cfg.change_flags(sparse__routed_spmv=flag):
            f = _matvec(side, A, (A.shape[1],), dtype)
        found.append("RoutedSpMV" in _ops(f))
    assert found == [fires, fires]
    assert (tplan_spmv(A) is not None) == (jplan_spmv(A) is not None)


# --- (b) values ----------------------------------------------------------------

@pytest.mark.parametrize("shape", ["vector", "column"])
def test_routed_values_match_jax(shape):
    A, rng = _random(1500, 1200, 0.005, 6)
    xshape = (1200,) if shape == "vector" else (1200, 1)
    xv = rng.standard_normal(xshape).astype("float32")
    outs = []
    for side in (JAX, PORT):
        f = _matvec(side, A, xshape)
        assert "RoutedSpMV" in _ops(f)
        outs.append(_out(f(xv)))
    assert outs[1].shape == outs[0].shape == (1500,) + xshape[1:]
    np.testing.assert_allclose(outs[1], outs[0], atol=1e-4)
    np.testing.assert_allclose(outs[1], A @ xv, atol=1e-4)


# --- (c) the gradient graph -----------------------------------------------------

def test_gradient_graph_matches_jax():
    A, rng = _random(1500, 1500, 0.005, 8)
    xv = rng.standard_normal(1500).astype("float32")
    fns, outs = [], []
    for ptt, pt, sparse, kw in (JAX, PORT):
        x = pt.tensor("x", dtype="float32", shape=(1500,))
        y = sparse.structured_dot(sparse.as_sparse_variable(A), x)
        cost = pt.sum(y * y)
        f = ptt.function([x], [cost, ptt.grad(cost, x)], **kw)
        fns.append(f)
        outs.append([_out(o) for o in f(xv)])
    assert _ops(fns[1]) == _ops(fns[0]) == sorted(
        ["RoutedSpMV", "RoutedSpMV", "Elemwise", "Elemwise", "CAReduce"])
    for t, j in zip(outs[1], outs[0]):
        np.testing.assert_allclose(t, j, rtol=1e-4)
    y64 = A.astype("float64") @ xv.astype("float64")
    np.testing.assert_allclose(outs[1][0], (y64 ** 2).sum(), rtol=1e-4)
    np.testing.assert_allclose(outs[1][1], 2 * (A.T.astype("float64") @ y64), rtol=1e-4,
                               atol=1e-4 * np.abs(2 * A.T @ y64).max())


# --- (d) the train_loop power iteration ------------------------------------------

def _power_iteration(side, A, x0, n_steps):
    ptt, pt, sparse, kw = side
    xsh = ptt.shared(x0.copy(), name="x", **kw)
    y = sparse.structured_dot(sparse.as_sparse_variable(A), xsh)
    g = ptt.train_loop([], pt.sum(y), {xsh: y / (pt.max(pt.abs(y)) + 1e-9)},
                       n_steps=n_steps, **kw)
    return g, xsh


def _inner_ops(fn, scan_type):
    node = next(nd for nd in fn.fgraph.apply_nodes if isinstance(nd.op, scan_type))
    return sorted(type(nd.op).__name__ for nd in node.op.fgraph.apply_nodes)


def test_train_loop_power_iteration_matches_jax():
    A, rng = _random(1500, 1500, 0.005, 13)
    x0 = rng.standard_normal((1500, 1)).astype("float32")
    (jg, jx), (tg, tx) = (_power_iteration(side, A, x0, 3) for side in (JAX, PORT))
    assert _ops(tg) == _ops(jg) == ["Scan", "SpecifyShape", "Subtensor"]
    assert _inner_ops(tg, TScan) == _inner_ops(jg, JScan) == sorted(
        ["RoutedSpMV", "Reshape", "Elemwise", "CAReduce", "Elemwise", "Elemwise", "CAReduce"])
    # RoutedSpMV is not an op of the whole-loop scan kernel in either
    # package: the loop runs step by step
    from pytensor_tpu.link.pallas.scan_pallas import pallas_scan_eligible
    from pytensor_tpu_torch.link.cuda.scan_kernel import scan_kernel_eligible

    for fn, scan_type, eligible in ((jg, JScan, pallas_scan_eligible),
                                    (tg, TScan, scan_kernel_eligible)):
        node = next(nd for nd in fn.fgraph.apply_nodes if isinstance(nd.op, scan_type))
        assert not eligible(node.op, node)
    j_out, t_out = float(np.asarray(jg())), float(tg())
    v = x0
    for _ in range(3):
        yv = A @ v
        v = yv / (np.max(np.abs(yv)) + 1e-9)
    np.testing.assert_allclose(t_out, j_out, rtol=2e-4)
    np.testing.assert_allclose(t_out, float(yv.sum()), rtol=2e-4)
    np.testing.assert_allclose(tx.get_value().numpy(), np.asarray(jx.get_value()), atol=2e-5)
    np.testing.assert_allclose(tx.get_value().numpy(), v, atol=2e-5)


# --- (e) the fallback StructuredDot lowering -------------------------------------

FALLBACK = {
    "small_float32": (80, 80, 0.05, "float32", (80,)),
    "float64": (300, 200, 0.02, "float64", (200,)),
    "float64_matrix_operand": (300, 200, 0.02, "float64", (200, 3)),
    "float32_matrix_operand": (300, 200, 0.1, "float32", (200, 3)),
}


@pytest.mark.parametrize("case", sorted(FALLBACK))
def test_fallback_structured_dot_matches_jax(case):
    M, N, dens, dtype, xshape = FALLBACK[case]
    A, rng = _random(M, N, dens, 30 + M)
    xv = rng.standard_normal(xshape).astype(dtype)
    outs = []
    for side in (JAX, PORT):
        f = _matvec(side, A, xshape, dtype)
        assert _ops(f) == ["StructuredDot"]
        outs.append(_out(f(xv)))
    tol = {"rtol": 1e-12} if dtype == "float64" else {"atol": 1e-4}
    np.testing.assert_allclose(outs[1], outs[0], **tol)
    np.testing.assert_allclose(outs[1], A @ xv, **tol)


def test_sparse_input_transpose_matches_jax():
    """A sparse input, not a constant: ``A.T @ x`` keeps ``Transpose`` and
    sums by rows (``index_add_``) on a value that came in as scipy."""
    A, rng = _random(60, 40, 0.1, 40, "float64")
    xv = rng.standard_normal(60)
    outs = []
    for ptt, pt, sparse, kw in (JAX, PORT):
        a = sparse.SparseTensorType("csr", "float64", (60, 40))("a")
        x = pt.tensor("x", dtype="float64", shape=(60,))
        f = ptt.function([a, x], sparse.structured_dot(a.T, x), **kw)
        assert _ops(f) == ["StructuredDot", "Transpose"]
        outs.append(_out(f(A, xv)))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-12)
    np.testing.assert_allclose(outs[1], A.T @ xv, rtol=1e-12)


def test_structured_dot_grad_lowering_matches_jax():
    """The gradient wrt the sparse operand at its pattern: the port's
    lowering against the JAX op's own evaluation."""
    A, rng = _random(50, 30, 0.2, 41, "float64")
    b, gz = rng.standard_normal((30, 2)), rng.standard_normal((50, 2))
    outs = []
    for ptt, pt, sparse, kw in (JAX, PORT):
        node = sparse.StructuredDotGrad()(
            sparse.as_sparse_variable(A), pt.as_tensor_variable(b),
            pt.as_tensor_variable(gz)).owner
        if kw:
            fn = torch_funcify(node.op, node=node, device="cpu")
            res = fn(sparse_as_torch(A, "cpu"), torch.from_numpy(b), torch.from_numpy(gz))
            assert isinstance(res, CSR)
            outs.append(sp.csr_matrix((res.data.numpy(), res.indices.numpy(),
                                       res.indptr.numpy()), shape=res.shape))
        else:
            storage = [[None]]
            node.op.perform(node, [A, b, gz], storage)
            outs.append(storage[0][0].tocsr())
    np.testing.assert_allclose(outs[1].toarray(), outs[0].toarray(), rtol=1e-12)


# --- (f) abs and max ------------------------------------------------------------------

@pytest.mark.parametrize("axis", [None, 0, 1])
def test_abs_and_max_match_jax(axis):
    rng = np.random.default_rng(50)
    xv = rng.standard_normal((6, 5))
    xv[2, 3] = -0.0
    outs = []
    for ptt, pt, _, kw in (JAX, PORT):
        x = pt.tensor("x", dtype="float64", shape=(6, 5))
        m = pt.max(pt.abs(x), axis=axis)
        f = ptt.function([x], [pt.abs(x), m, ptt.grad(pt.sum(m), x)], **kw)
        outs.append([_out(o) for o in f(xv)])
    for t, j in zip(outs[1], outs[0]):
        assert t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=1e-12)
    assert not np.signbit(outs[1][0][2, 3])


# --- (g) sparse_as_torch ---------------------------------------------------------------

def test_sparse_as_torch_makes_canonical_csr():
    """Duplicates summed, the columns of each row sorted, int32 indices,
    whatever the scipy format."""
    rows = np.array([2, 0, 2, 1, 0, 2, 2])
    cols = np.array([4, 3, 1, 0, 3, 4, 0])
    vals = np.arange(1.0, 8.0, dtype="float32")
    coo = sp.coo_matrix((vals, (rows, cols)), shape=(4, 5))
    order = np.argsort(rows, kind="stable")
    csr = sp.csr_matrix((vals[order], cols[order], np.array([0, 2, 3, 7, 7])), shape=(4, 5))
    assert not csr.has_canonical_format
    for A in (coo, csr, coo.tocsc()):
        c = sparse_as_torch(A, "cpu")
        assert c.indptr.dtype == c.indices.dtype == torch.int32
        assert c.shape == (4, 5)
        np.testing.assert_array_equal(c.indptr.numpy(), [0, 1, 2, 5, 5])
        np.testing.assert_array_equal(c.indices.numpy(), [3, 0, 0, 1, 4])
        back = sp.csr_matrix((c.data.numpy(), c.indices.numpy(), c.indptr.numpy()), shape=c.shape)
        np.testing.assert_array_equal(back.toarray(), A.toarray())
    assert sparse_as_torch(csr, "cpu", "float64").data.dtype == torch.float64


# --- (h) train_loop semantics -------------------------------------------------------------

@pytest.mark.parametrize("routed", [True, False], ids=["routed", "segment_sum"])
def test_train_loop_equals_repeated_calls(routed):
    """``g()`` equals K calls of ``function(..., updates=...)``: the same
    output and the same shared state."""
    n, dens = (1500, 0.005) if routed else (200, 0.02)
    A, rng = _random(n, n, dens, 60)
    x0 = rng.standard_normal(n).astype("float32")
    k_steps = 4
    results = []
    for use_loop in (True, False):
        xsh = tptt.shared(x0.copy(), name="x", device="cpu")
        y = tsparse.structured_dot(tsparse.as_sparse_variable(A), xsh)
        out, upd = tpt.sum(y), {xsh: y / (tpt.max(tpt.abs(y)) + 1e-9)}
        if use_loop:
            g = tptt.train_loop([], out, upd, n_steps=k_steps, device="cpu")
            assert ("RoutedSpMV" in _inner_ops(g, TScan)) == routed
            res = g()
        else:
            f = tptt.function([], out, updates=upd, device="cpu")
            for _ in range(k_steps):
                res = f()
        results.append((float(res), xsh.get_value().numpy()))
    assert results[0][0] == results[1][0]
    np.testing.assert_array_equal(results[0][1], results[1][1])


def test_train_loop_needs_updates_of_shared_variables():
    x = tpt.tensor("x", dtype="float32", shape=(3,))
    with pytest.raises(ValueError, match="updates"):
        tptt.train_loop([x], x.sum(), None, n_steps=2, device="cpu")
    with pytest.raises(TypeError, match="shared"):
        tptt.train_loop([x], x.sum(), {x: x + 1}, n_steps=2, device="cpu")

"""Harness of the sparse parity tests (``tests/test_torch_sparse_*.py``).

A case builds its graph from a package's namespaces (``pt`` the tensor
module, ``sp`` the sparse module) and a format; its inputs are made from
a seed with numpy.  ``run_case`` evaluates it in the JAX package's oracle
(``mode="FAST_COMPILE"``: scipy ``perform``s) and in the port
(``FAST_RUN``, linked for the CPU), and rewrites the JAX package's
``FAST_RUN`` graph, whose ops the port's graph must have one for one.

Values: dense outputs within ``RTOL``/``ATOL`` of the oracle's (float64
inputs; the port sums in other orders); a sparse output (a torch sparse
tensor in the port, a scipy matrix in the oracle) by its dense value, and
by its triple (pointers, indices, data) where its structure is the
oracle's and canonical, which the ops with a static count give where no
index repeats.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as ssp
import torch

import pytensor_tpu as jptt
import pytensor_tpu.sparse as jsparse
import pytensor_tpu.tensor as jpt

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.sparse as tsparse
import pytensor_tpu_torch.tensor as tpt

JAX = (jptt, jpt, jsparse)
PORT = (tptt, tpt, tsparse)
RTOL, ATOL = 1e-12, 1e-14
FORMATS = ("csr", "csc")


def rand_sparse(m, n, fmt="csr", density=0.4, seed=0, dtype="float64"):
    """A canonical scipy matrix of the format from a seeded generator."""
    A = ssp.random(m, n, density=density, format=fmt, dtype=dtype,
                   random_state=np.random.default_rng(seed))
    A.sort_indices()
    return A


def scipy_of(value):
    """A torch sparse tensor (csr or csc) as the scipy matrix of its
    triple; a scipy matrix as it is."""
    if ssp.issparse(value):
        return value
    if value.layout == torch.sparse_csr:
        return ssp.csr_matrix((value.values().numpy(), value.col_indices().numpy(),
                               value.crow_indices().numpy()), shape=tuple(value.shape))
    assert value.layout == torch.sparse_csc, value.layout
    return ssp.csc_matrix((value.values().numpy(), value.row_indices().numpy(),
                           value.ccol_indices().numpy()), shape=tuple(value.shape))


def dense_of(value):
    """Any output of either package as a numpy array."""
    if ssp.issparse(value):
        return value.toarray()
    if isinstance(value, torch.Tensor):
        if value.layout != torch.strided:
            return value.to_dense().numpy()
        return value.numpy()
    if hasattr(value, "todense"):  # a BCOO of the JAX package's XLA path
        return np.asarray(value.todense())
    return np.asarray(value)


def ops_of(f):
    return sorted(type(n.op).__name__ for n in f.fgraph.apply_nodes)


def build(side, case, fmt):
    """``(inputs, outputs)`` of ``case`` in one package."""
    _, pt, sp = side
    ins, outs = case(pt, sp, fmt)
    return ins, outs if isinstance(outs, (list, tuple)) else [outs]


def run_case(case, fmt, values, structure=None, rtol=RTOL, atol=ATOL, graph=True):
    """Evaluate ``case`` in both packages on ``values`` and hold the port's
    outputs to the oracle's; returns ``(port outputs, oracle outputs, port
    function)``."""
    ins, outs = build(JAX, case, fmt)
    want = jptt.function(ins, outs, mode="FAST_COMPILE", on_unused_input="ignore")(*values)
    t_ins, t_outs = build(PORT, case, fmt)
    f = tptt.function(t_ins, t_outs, device="cpu", on_unused_input="ignore")
    got = f(*values)
    if graph:
        jf = jptt.function(ins, outs, on_unused_input="ignore")
        assert ops_of(f) == ops_of(jf)
    for g, w, o in zip(got, want, t_outs):
        held(g, w, o, structure, rtol, atol)
    return got, want, f


def held(got, want, var, structure=None, rtol=RTOL, atol=ATOL):
    """One port output against the oracle's; a sparse one's triple too
    where ``structure`` is True, or, by default, where the oracle's is
    canonical (sorted, no duplicates)."""
    if isinstance(var.type, tsparse.SparseTensorType):
        assert isinstance(got, torch.Tensor)
        assert got.layout == {"csr": torch.sparse_csr, "csc": torch.sparse_csc,
                              "bsr": torch.sparse_csr}[var.type.format]
        g = scipy_of(got)
        assert g.shape == want.shape and str(g.dtype) == var.type.dtype
        w = want.asformat(g.format)
        if structure or (structure is None and w.has_canonical_format):
            np.testing.assert_array_equal(g.indptr, w.indptr)
            np.testing.assert_array_equal(g.indices, w.indices)
            np.testing.assert_allclose(g.data, w.data, rtol=rtol, atol=atol)
    g, w = dense_of(got), dense_of(want)
    assert g.shape == w.shape, (g.shape, w.shape)
    assert str(g.dtype) == var.type.dtype
    if g.dtype == bool:
        np.testing.assert_array_equal(g, w)
    else:
        np.testing.assert_allclose(g, w.astype(g.dtype), rtol=rtol, atol=atol)

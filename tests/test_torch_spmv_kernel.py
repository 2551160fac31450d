"""K4's CUDA source, run on the CPU under a host emulation.

There is no nvcc here, so K4 (``pytensor_tpu_torch/csrc/spmv_csr.cu``)
cannot be compiled for the card; but its source is C++ apart from a few
CUDA features.  With ``tests/k4_host.h`` in place of ``<cuda_runtime.h>``
(the grid's blocks in turn, each block as real threads, warp shuffles
with a width through a per-warp buffer, an occupancy query of a stated
card), g++ compiles the source and runs it on CPU tensors.  Each launch is
held bit for bit against the lane order that the source's note states
(``k4_host_reference`` in the header: ``G`` lane sums by ``fmaf``, then the
tree, in plain C; ``fmaf`` is exact on the host too), and per row within
``4 * D2 * 2**-24 * sum_j |a_ij x_j|`` of the plain version (float32 sums
of at most ``D2``, the longest row, terms in two orders).  The cases:
every lane count the source takes, rows of 0 and of 128 nonzeros, rows
of every length up to 2G + 1 (a lane's pairs and its last single), a row
count that is not a multiple of a block's rows, several blocks, and data
and indices that start off a 16-byte boundary.  What this cannot show is
that nvcc accepts the source, or the card's rounding:
``tests/test_torch_cuda.py`` and ``chip_smoke.py`` show those on the card.
Libraries go to the gitignored ``build/k4_host/``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from pytensor_tpu_torch.link.cuda import spmv_kernel
from pytensor_tpu_torch.link.torch.convert import sparse_as_torch

BUILD = Path(__file__).resolve().parents[1] / "build" / "k4_host"
HEADER = Path(__file__).resolve().parent / "k4_host.h"


@pytest.fixture(scope="module")
def k4_host():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile K4's source for the host")
    source = spmv_kernel.SOURCE.read_text()
    assert "#include <cuda_runtime.h>" in source
    src = source.replace("#include <cuda_runtime.h>", f'#include "{HEADER}"')
    key = hashlib.sha256(src.encode() + HEADER.read_bytes()).hexdigest()[:16]
    lib = BUILD / f"libk4_host_{key}.so"
    if not lib.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        cpp = BUILD / f"k4_host_{key}.{os.getpid()}.cpp"
        cpp.write_text(src)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-shared", "-fPIC", "-pthread",
                               "-o", str(tmp), str(cpp)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[:4000]
        os.replace(tmp, lib)
    handle = ctypes.CDLL(str(lib))
    p, i = ctypes.c_void_p, ctypes.c_int
    handle.spmv_csr.argtypes = [p, p, p, p, p, i, i, p]
    handle.spmv_csr.restype = i
    handle.spmv_csr_plan.argtypes = [i, i, p]
    handle.spmv_csr_plan.restype = i
    handle.k4_host_reference.argtypes = [p, p, p, p, p, i, i]
    handle.k4_host_set_card.argtypes = [i, i]
    handle.k4_host_blocks.restype = i
    return handle


def _matrix(seed, n_rows=40, n_cols=50, lengths=(0, 1, 3, 7, 12, 33, 70)):
    """Rows of the given lengths at random (the first two 0 and the
    longest), each of distinct random columns where ``n_cols`` allows, else
    with duplicate entries, which the conversion sums."""
    rng = np.random.default_rng(seed)
    row_len = rng.choice(lengths, size=n_rows)
    row_len[:2] = (0, max(lengths))
    rows = np.repeat(np.arange(n_rows), row_len)
    cols = np.concatenate([rng.choice(n_cols, size=n, replace=n > n_cols) for n in row_len])
    vals = rng.standard_normal(rows.size).astype("float32")
    return sp.coo_matrix((vals, (rows, cols)), shape=(n_rows, n_cols)).tocsr()


def _offset(t, k):
    """``t``'s values in a tensor that starts ``k`` elements past a 16-byte
    boundary."""
    buf = torch.empty(t.numel() + 8, dtype=t.dtype)
    base = (-(buf.data_ptr() // t.element_size())) % 4
    out = buf[base + k: base + k + t.numel()]
    out.copy_(t)
    assert out.data_ptr() % 16 == 4 * k
    return out


def _host_run(lib, csr, x, G):
    """K4's launch through the host build, in the blocks its plan says."""
    M = csr.indptr.shape[0] - 1
    y = torch.full((M,), np.nan, dtype=torch.float32)
    err = lib.spmv_csr(csr.indptr.data_ptr(), csr.indices.data_ptr(), csr.data.data_ptr(),
                       x.data_ptr(), y.data_ptr(), M, G, None)
    assert err == 0
    plan = (ctypes.c_int * 4)()
    assert lib.spmv_csr_plan(M, G, plan) == 0
    assert lib.k4_host_blocks() == plan[1]
    return y


def _reference(lib, csr, x, G):
    M = csr.indptr.shape[0] - 1
    y = torch.full((M,), np.nan, dtype=torch.float32)
    lib.k4_host_reference(csr.indptr.data_ptr(), csr.indices.data_ptr(), csr.data.data_ptr(),
                          x.data_ptr(), y.data_ptr(), M, G)
    return y


def _row_bound(A, x):
    d2 = int(np.diff(A.indptr).max())
    return 4 * d2 * 2.0 ** -24 * (abs(A) @ np.abs(x.astype("float64")))


def _held(lib, A, csr, x, G):
    """K4 bit for bit the lane-order reference, and within the per-row
    bound of the plain version; empty rows give +0.0."""
    got = _host_run(lib, csr, x, G)
    want = _reference(lib, csr, x, G)
    assert not torch.isnan(got).any()
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    plain = spmv_kernel.plain(csr.indptr, csr.indices, csr.data, x)
    assert np.all(np.abs(got.numpy() - plain.numpy()) <= _row_bound(A, x.numpy()))
    empty = np.diff(A.indptr) == 0
    assert np.all(got.numpy()[empty] == 0)
    assert not torch.signbit(got[torch.from_numpy(empty)]).any()
    return got


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_k4_source_matches_plain(k4_host, G):
    A = _matrix(G)
    csr = sparse_as_torch(A, "cpu", "float32")
    x = torch.from_numpy(np.random.default_rng(100 + G).standard_normal(50).astype("float32"))
    got = _held(k4_host, A, csr, x, G)
    assert got[0] == 0.0
    # a fixed order: the same launch gives the same bits
    assert torch.equal(got, _host_run(k4_host, csr, x, G))


# case -> (matrix, lanes)
_CASES = {
    # rows of 0 and of 128 nonzeros, the longest the routed plan takes
    "rows_of_0_and_128": (lambda: _matrix(1, 60, 300, (0, 128)), 8),
    # rows of every length from 0 to 2G + 1 = 17: no pair, pairs, a last
    # single after them
    "rows_of_every_length_to_2G_plus_1": (lambda: _matrix(2, 90, 50, tuple(range(18))), 8),
    # 37 rows at 16 rows a block: the last block holds 5
    "rows_not_a_multiple_of_a_block": (lambda: _matrix(3, 37, 50), 16),
    # 700 rows at 64 rows a block: 11 blocks
    "several_blocks": (lambda: _matrix(4, 700, 90, (0, 2, 5, 9, 14)), 4),
}


@pytest.mark.parametrize("case", sorted(_CASES))
def test_k4_source_lane_order_cases(k4_host, case):
    build, G = _CASES[case]
    A = build()
    csr = sparse_as_torch(A, "cpu", "float32")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(A.shape[1]).astype("float32"))
    if case == "rows_of_0_and_128":
        assert set(np.diff(A.indptr)) == {0, 128}
    _held(k4_host, A, csr, x, G)


@pytest.mark.parametrize("k_data,k_indices", [(1, 3), (2, 0), (3, 1), (0, 2)])
def test_k4_source_ranges_off_a_16_byte_boundary(k4_host, k_data, k_indices):
    """data and indices each start k elements past a 16-byte boundary, each
    at its own offset: the kernel reads them element by element, from any
    4-byte boundary."""
    A = _matrix(20 + k_data, 90, 50)
    csr = sparse_as_torch(A, "cpu", "float32")
    csr = type(csr)(csr.indptr, _offset(csr.indices, k_indices), _offset(csr.data, k_data),
                    csr.shape)
    x = torch.from_numpy(np.random.default_rng(8).standard_normal(50).astype("float32"))
    _held(k4_host, A, csr, x, 8)


def test_k4_plan(k4_host, monkeypatch):
    """The wrapper's plan through the host build, on a card of 132 SMs of 8
    blocks: the 65,536-row matrix at 8 lanes a row is 32 rows a block, 2,048
    blocks, two waves of 1,056; 40 rows at 32 lanes are 8 rows a block, 5
    blocks, one wave."""
    monkeypatch.setattr(spmv_kernel, "build", lambda: k4_host)
    k4_host.k4_host_set_card(132, 8)
    assert spmv_kernel.plan(65536, 8) == {"rows": 32, "blocks": 2048, "resident": 1056,
                                          "waves": 2}
    assert spmv_kernel.plan(40, 32) == {"rows": 8, "blocks": 5, "resident": 1056, "waves": 1}


def test_k4_source_asks_the_card(k4_host):
    """The plan gives rows a block, blocks, and from the occupancy query the
    blocks an SM and the SMs; it refuses a lane count the source lacks."""
    out = (ctypes.c_int * 4)()
    k4_host.k4_host_set_card(132, 6)
    assert k4_host.spmv_csr_plan(65536, 8, out) == 0 and list(out) == [32, 2048, 6, 132]
    k4_host.k4_host_set_card(132, 8)
    assert k4_host.spmv_csr_plan(40, 3, out) != 0


def test_k4_source_refuses_a_lane_count(k4_host):
    csr = sparse_as_torch(_matrix(0), "cpu", "float32")
    y = torch.empty(40)
    x = torch.zeros(50)
    assert k4_host.spmv_csr(csr.indptr.data_ptr(), csr.indices.data_ptr(), csr.data.data_ptr(),
                            x.data_ptr(), y.data_ptr(), 40, 3, None) != 0

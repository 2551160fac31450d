"""K4's CUDA source, run on the CPU under a host emulation.

There is no nvcc here, so K4 (``pytensor_tpu_torch/csrc/spmv_csr.cu``)
cannot be compiled for the card; but its source is C++ apart from a few
CUDA features.  With ``tests/k4_host.h`` in place of ``<cuda_runtime.h>``
(a grid of blocks run in turn, each block as real threads, warp shuffles
with a width through a per-warp buffer), g++ compiles the source and runs
it on CPU tensors, so its row mapping, its lane groups and its shuffle
tree are held here against the plain version, for every lane count the
source instantiates, on rows that are empty, shorter and longer than a
group.  What this cannot show is that nvcc accepts the source, or the
card's rounding: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` show
those on the card.  Tolerance, per row: ``4 * D2 * 2**-24 * sum_j |a_ij
x_j|``, float32 sums of at most ``D2`` (the longest row) terms in two
orders.  Libraries go to the gitignored ``build/k4_host/``.
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
LAUNCH = ("spmv_csr_kernel<G><<<blocks, SPMV_THREADS, 0, stream>>>"
          "(indptr, indices, data, x, y, M);")
HOST_LAUNCH = ("k4_host_launch(blocks, SPMV_THREADS, [&] "
               "{ spmv_csr_kernel<G>(indptr, indices, data, x, y, M); });")


@pytest.fixture(scope="module")
def k4_host():
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile K4's source for the host")
    source = spmv_kernel.SOURCE.read_text()
    assert LAUNCH in source
    src = source.replace("#include <cuda_runtime.h>", f'#include "{HEADER}"')
    src = src.replace(LAUNCH, HOST_LAUNCH)
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
    return handle


def _matrix(seed, n_rows=40, n_cols=50):
    """Rows of 0 to 70 nonzeros: empty rows, rows shorter and longer than
    every lane group, and duplicate entries to be summed."""
    rng = np.random.default_rng(seed)
    lengths = rng.choice([0, 1, 3, 7, 12, 33, 70], size=n_rows)
    lengths[:2] = (0, 70)
    rows = np.repeat(np.arange(n_rows), lengths)
    cols = rng.integers(0, n_cols, size=rows.size)
    vals = rng.standard_normal(rows.size).astype("float32")
    return sp.coo_matrix((vals, (rows, cols)), shape=(n_rows, n_cols)).tocsr()


def _host_run(lib, csr, x, G):
    y = torch.full((csr.indptr.shape[0] - 1,), np.nan, dtype=torch.float32)
    err = lib.spmv_csr(csr.indptr.data_ptr(), csr.indices.data_ptr(), csr.data.data_ptr(),
                       x.data_ptr(), y.data_ptr(), y.shape[0], G, None)
    assert err == 0
    return y


def _row_bound(A, x):
    d2 = int(np.diff(A.indptr).max())
    return 4 * d2 * 2.0 ** -24 * (abs(A) @ np.abs(x.astype("float64")))


@pytest.mark.parametrize("G", [1, 2, 4, 8, 16, 32])
def test_k4_source_matches_plain(k4_host, G):
    A = _matrix(G)
    csr = sparse_as_torch(A, "cpu", "float32")
    x = torch.from_numpy(np.random.default_rng(100 + G).standard_normal(50).astype("float32"))
    got = _host_run(k4_host, csr, x, G)
    want = spmv_kernel.plain(csr.indptr, csr.indices, csr.data, x)
    bound = _row_bound(A, x.numpy())
    assert np.all(np.abs(got.numpy() - want.numpy()) <= bound)
    assert got[0] == 0.0 and not torch.isnan(got).any()
    # a fixed order: the same launch gives the same bits
    assert torch.equal(got, _host_run(k4_host, csr, x, G))


def test_k4_source_refuses_a_lane_count(k4_host):
    csr = sparse_as_torch(_matrix(0), "cpu", "float32")
    y = torch.empty(40)
    x = torch.zeros(50)
    assert k4_host.spmv_csr(csr.indptr.data_ptr(), csr.indices.data_ptr(), csr.data.data_ptr(),
                            x.data_ptr(), y.data_ptr(), 40, 3, None) != 0

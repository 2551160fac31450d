"""K4: the CSR matvec kernel behind RoutedSpMV, and its plain version.

Counterpart of ``pytensor_tpu/link/pallas/route.py`` (``lane_gather:194``
and the routed permutation built from it), which the JAX package's routed
SpMV composes into ``y = A x`` (``sparse/spmv.py:143 build_spmv_fn``).
The CUDA kernel (``csrc/spmv_csr.cu``) is that whole function: the gather
``x[indices[k]]``, the multiply by ``data[k]`` and the row sum, a group
of ``G`` lanes a row; its source says what bounds it and how.  ``plan``
says how a launch fills the card.

The kernel is built by ``link/cuda/build.py`` (nvcc for sm_90a into the
gitignored ``build/kernels/``) at first use and called through
``ctypes`` on torch's current stream.  ``spmv`` takes the plain version
for CPU tensors only; on CUDA tensors it launches the kernel or raises.
The plain version is ``index_add_`` of the products into their rows.
"""

from __future__ import annotations

import ctypes
import math
from pathlib import Path

import torch

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "spmv_csr.cu"

# launches of the kernel since the count was last set to 0
LAUNCHES = 0

_LIB = None
BUILD_LOG = ""


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (once per source hash) and load the K4 shared library.

    With ``verbose`` the compiler's register and spill report
    (``-Xptxas -v``) is kept in ``BUILD_LOG``.
    """
    from pytensor_tpu_torch.link.cuda.build import build_library

    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    lib, BUILD_LOG = build_library(SOURCE.read_text(), "spmv_csr", SOURCE, verbose)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spmv_csr.argtypes = [p, p, p, p, p, i, i, p]
    lib.spmv_csr.restype = i
    lib.spmv_csr_plan.argtypes = [i, i, p]
    lib.spmv_csr_plan.restype = i
    _LIB = lib
    return lib


def group_size(n_rows: int, nnz: int) -> int:
    """Lanes a row: the mean row length rounded to a power of two, in
    [1, 32] (8 for the 65,536^2 matrix of ten nonzeros a row)."""
    mean = nnz / max(n_rows, 1)
    if mean <= 1:
        return 1
    return min(32, 2 ** round(math.log2(mean)))


def plan(n_rows: int, G: int) -> dict:
    """How a launch for ``n_rows`` rows with ``G`` lanes a row fills the
    current card: rows a block, blocks, the blocks the card holds at once
    (its SMs times the blocks an SM holds) and the waves they take."""
    out = (ctypes.c_int * 4)()
    err = build().spmv_csr_plan(int(n_rows), int(G), out)
    if err != 0:
        raise RuntimeError(f"K4 occupancy query failed: CUDA error {err}")
    rows, blocks, resident = out[0], out[1], out[2] * out[3]
    return {"rows": rows, "blocks": blocks, "resident": resident,
            "waves": -(-blocks // max(resident, 1))}


def _check(indptr, indices, data, x):
    dev = x.device
    for name, t, dtype in (("indptr", indptr, torch.int32), ("indices", indices, torch.int32),
                           ("data", data, torch.float32), ("x", x, torch.float32)):
        if t.device != dev:
            raise ValueError(f"K4: {name} is on {t.device}, x on {dev}")
        if t.dtype != dtype or t.ndim != 1 or not t.is_contiguous():
            raise ValueError(f"K4 takes contiguous 1-d {dtype} tensors; {name} is "
                             f"{t.dtype} of shape {tuple(t.shape)}")
    if indptr.shape[0] < 1 or indices.shape[0] != data.shape[0]:
        raise ValueError(f"K4: indptr of {indptr.shape[0]} entries, indices of "
                         f"{indices.shape[0]}, data of {data.shape[0]}")


def launch(indptr, indices, data, x, G=None):
    """``y = A x`` on CUDA tensors, with ``A`` the CSR ``(indptr, indices,
    data)`` of ``len(indptr) - 1`` rows; ``G`` lanes a row, by default
    ``group_size``."""
    global LAUNCHES
    _check(indptr, indices, data, x)
    if x.device.type != "cuda":
        raise ValueError(f"K4 runs on CUDA tensors; x is on {x.device}")
    M = indptr.shape[0] - 1
    if G is None:
        G = group_size(M, indices.shape[0])
    lib = build()
    y = torch.empty(M, dtype=torch.float32, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.spmv_csr(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), x.data_ptr(),
                       y.data_ptr(), M, int(G), stream)
    if err != 0:
        raise RuntimeError(f"K4 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return y


def plain(indptr, indices, data, x):
    """The same product in torch ops, on any device."""
    M = indptr.shape[0] - 1
    counts = (indptr[1:] - indptr[:-1]).long()
    rows = torch.repeat_interleave(torch.arange(M, device=x.device), counts)
    return torch.zeros(M, dtype=x.dtype, device=x.device).index_add_(
        0, rows, data * x[indices.long()])


def spmv(indptr, indices, data, x):
    """``plain`` on CPU tensors, else ``launch``."""
    if x.device.type == "cpu":
        _check(indptr, indices, data, x)
        return plain(indptr, indices, data, x)
    return launch(indptr, indices, data, x)

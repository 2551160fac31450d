"""Matmul speed probe (PyTensor's misc/check_blas.py).

Counterpart of ``pytensor_tpu/misc/check_blas.py``.  PyTensor's script
times gemm through its BLAS bindings to validate the host BLAS install;
here, as in the JAX package, a large matmul runs through a linked
``function`` (a shared ``C`` updated with ``0.4 * C + 0.8 * dot(A, B)``,
the constants in the matrices' dtype)
and the probe reports GFLOP/s.  On the card the product is cuBLAS's, as
the JAX package's is XLA's, outside any hand-written kernel.  Run:
``python -m pytensor_tpu_torch.misc.check_blas``.
"""

from __future__ import annotations

import time

import numpy as np


def execute(N=2048, iters=10, dtype="float32", verbose=True, device="cuda"):
    """GFLOP/s of ``iters`` calls of the N x N update (2 N^3 flops each)
    after one call that links, captures and warms up; ``device`` is the
    port's (the card unless the caller names the CPU)."""
    import torch

    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.link.torch.convert import resolve_device
    from pytensor_tpu_torch.utils import np_dtype

    dev = resolve_device(device)
    A = ptt.shared(np.random.default_rng(0).standard_normal((N, N)).astype(np_dtype(dtype)),
                   device=dev)
    B = ptt.shared(np.random.default_rng(1).standard_normal((N, N)).astype(np_dtype(dtype)),
                   device=dev)
    C = ptt.shared(np.zeros((N, N), dtype=np_dtype(dtype)), device=dev)
    # the constants in the matrices' dtype, so that a bfloat16 update stays
    # bfloat16 (a python float would make it float32)
    a, b = (pt.constant(np.asarray(v, np_dtype(dtype))) for v in (0.4, 0.8))
    f = ptt.function([], [], updates={C: a * C + b * pt.dot(A, B)},
                     name="check_blas_gemm", device=dev)
    f()  # link, capture and warm up
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        f()
    sync()
    dt = time.perf_counter() - t0
    gflops = 2.0 * N * N * N * iters / dt / 1e9
    if verbose:
        name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
        print(f"device: {name}")
        print(f"gemm {N}x{N} {dtype}: {dt / iters * 1000:.3f} ms/call, {gflops:.1f} GFLOP/s")
    return gflops


if __name__ == "__main__":
    execute()

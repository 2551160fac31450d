"""The threefry2x32 kernel behind the port's random draws, and its plain version.

No Pallas kernel is its counterpart: the JAX package draws through
``jax.random``, whose threefry2x32 XLA runs (``jax/_src/prng.py:883``).
The CUDA kernel (``csrc/threefry.cu``) hashes the counters ``0..n-1``
(or ``first..first+n-1``) under a key held on the card and writes, by
mode, the 32- or 64-bit bits, the keys of a split, or jax's float64 or
float32 uniforms and float64 normals; its source says what bounds it and
how.

The kernel is built by ``link/cuda/build.py`` (nvcc for sm_90a into the
gitignored ``build/kernels/``) at first use and called through ``ctypes``
on torch's current stream.  ``draw`` takes the plain version for a key on
the CPU only; for a key on the card it launches the kernel or raises.
The plain version is ``tensor/random/threefry.py``'s int64 torch hash.
"""

from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "threefry.cu"
# the hash and the draws of its bits, which the loop samplers' kernels share
HEADER = SOURCE.with_suffix(".cuh")

BITS32, BITS64, KEYS, UNIFORM64, NORMAL64, UNIFORM32 = range(6)
# the dtype each mode writes (KEYS two values a draw)
_OUT = {BITS32: torch.int64, BITS64: torch.int64, KEYS: torch.int64, UNIFORM64: torch.float64,
        NORMAL64: torch.float64, UNIFORM32: torch.float32}
NORMAL_LO = float(np.nextafter(-1.0, 0.0))

# launches of the kernel since the count was last set to 0
LAUNCHES = 0

_LIB = None
BUILD_LOG = ""


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (once per source hash) and load the threefry library; with
    ``verbose`` the compiler's ``-Xptxas -v`` report is kept in
    ``BUILD_LOG``."""
    from pytensor_tpu_torch.link.cuda.build import build_csrc

    global _LIB, BUILD_LOG
    if _LIB is not None:
        return _LIB
    lib, BUILD_LOG = build_csrc("threefry", (HEADER.name,), verbose)
    p = ctypes.c_void_p
    lib.threefry2x32_draw.argtypes = [p, ctypes.c_ulonglong, ctypes.c_longlong, ctypes.c_int,
                                      p, ctypes.c_double, ctypes.c_double, p]
    lib.threefry2x32_draw.restype = ctypes.c_int
    _LIB = lib
    return lib


def _check(key, n, mode):
    if key.dtype != torch.int64 or tuple(key.shape) != (2,) or not key.is_contiguous():
        raise ValueError(f"threefry takes a key of 2 contiguous int64 (each a uint32), got "
                         f"{key.dtype} of shape {tuple(key.shape)}")
    if mode not in _OUT:
        raise ValueError(f"threefry has no mode {mode}")
    if n < 0:
        raise ValueError(f"threefry of {n} draws")


def _shape(n, mode):
    return (n, 2) if mode == KEYS else (n,)


def launch(key, n, mode, lo=0.0, hi=1.0, first=0):
    """The ``n`` draws of ``mode`` under ``key`` (a CUDA tensor) at the
    counters ``first, first + 1, ...`` (``first`` below 2**64; jax's draws
    count from 0), by the kernel; ``lo`` and ``hi`` bound the uniform
    modes."""
    global LAUNCHES
    _check(key, n, mode)
    if key.device.type != "cuda":
        raise ValueError(f"the threefry kernel runs on CUDA tensors; the key is on {key.device}")
    lib = build()
    out = torch.empty(_shape(n, mode), dtype=_OUT[mode], device=key.device)
    stream = torch.cuda.current_stream(key.device).cuda_stream
    err = lib.threefry2x32_draw(key.data_ptr(), int(first) % 2 ** 64, int(n), int(mode),
                                out.data_ptr(), float(lo), float(hi), stream)
    if err != 0:
        raise RuntimeError(f"threefry launch failed: CUDA error {err}")
    LAUNCHES += 1
    return out


def plain(key, n, mode, lo=0.0, hi=1.0, first=0):
    """The same draws in int64 torch ops, on any device."""
    from pytensor_tpu_torch.tensor.random import threefry as tf

    _check(key, n, mode)
    first = int(first) % 2 ** 64
    # the counters as int64 of their 64 bits, wrapping as the kernel's do
    c = torch.arange(n, dtype=torch.int64, device=key.device) + (
        first - 2 ** 64 if first >= 2 ** 63 else first)
    b1, b2 = tf.hash_counts(key, (c >> 32) & tf.MASK, c & tf.MASK)
    if mode == KEYS:
        return torch.stack([b1, b2], dim=-1)
    if mode == BITS32:
        return b1 ^ b2
    if mode == UNIFORM32:
        return tf.uniform32_from_bits(b1 ^ b2, lo, hi)
    bits = (b1 << 32) | b2
    if mode == BITS64:
        return bits
    if mode == UNIFORM64:
        return tf.uniform64_from_bits(bits, lo, hi)
    return tf.SQRT2 * torch.erfinv(tf.uniform64_from_bits(bits, NORMAL_LO, 1.0))


def draw(key, n, mode, lo=0.0, hi=1.0):
    """The draws of a sampler (counted from 0): ``plain`` for a key on the
    CPU, else ``launch``."""
    if key.device.type == "cpu":
        return plain(key, n, mode, lo, hi)
    return launch(key, n, mode, lo, hi)

"""The Poisson kernel behind the port's Poisson draws, and its plain
version.

No Pallas kernel is its counterpart: the JAX package draws poisson
through ``jax.random``, whose ``_poisson`` XLA runs as Knuth's and
Hormann's (PTRS) ``while_loop``s over the whole array, in float32
(``jax/_src/random.py:1547-1631``).  The CUDA kernel (``csrc/poisson.cu``)
keeps jax's whole-array semantics in two launches: pass 1 runs each
element to its first PTRS accept (and Knuth's elements to their end) and
takes the array's pass count N on the card, pass 2 runs the PTRS elements
on to N and keeps their last accept; its source says what bounds it and
how.

Built by ``link/cuda/build.py`` (nvcc for sm_90a, ``-fmad=false``) at
first use and called through ``ctypes`` on torch's current stream.
``draw`` takes the plain version (``tensor/random/samplers.py
poisson_loops``) for a key on the CPU only; for a key on the card it
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches, two a
draw.
"""

from __future__ import annotations

import ctypes

import torch

from pytensor_tpu_torch.link.cuda.build import CSRC

SOURCE = CSRC / "poisson.cu"
HEADERS = ("threefry.cuh", "loops.cuh")
FLAGS = ("-fmad=false",)
PASS1, PASS2 = 1, 2

# launches of the kernel's passes since the count was last set to 0
LAUNCHES = 0

_LIB = None
BUILD_LOG = ""


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (once per source hash) and load the Poisson library."""
    from pytensor_tpu_torch.link.cuda.build import build_csrc

    global _LIB, BUILD_LOG
    if _LIB is None:
        lib, BUILD_LOG = build_csrc("poisson", HEADERS, verbose, FLAGS)
        p = ctypes.c_void_p
        lib.poisson_draw.argtypes = [p, p, ctypes.c_longlong, p, p, ctypes.c_int, p]
        lib.poisson_draw.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(key, lam):
    if key.dtype != torch.int64 or tuple(key.shape) != (2,) or not key.is_contiguous():
        raise ValueError(f"the Poisson kernel takes a key of 2 contiguous int64, got "
                         f"{key.dtype} of shape {tuple(key.shape)}")
    if lam.dtype != torch.float32 or lam.ndim != 1 or not lam.is_contiguous():
        raise ValueError(f"the Poisson kernel takes a flat contiguous float32 lam, got "
                         f"{lam.dtype} of shape {tuple(lam.shape)}")
    if lam.device != key.device:
        raise ValueError(f"the key is on {key.device}, lam on {lam.device}")


def run_passes(key, lam, out, scratch, passes):
    """Launch the kernel's ``passes`` (``PASS1``, ``PASS2`` or both) on
    ``out`` (int64, n) and ``scratch`` (int32, n + 1) as pass 1 left them."""
    global LAUNCHES
    if key.device.type != "cuda":
        raise ValueError(f"the Poisson kernel runs on CUDA tensors; the key is on {key.device}")
    err = build().poisson_draw(key.data_ptr(), lam.data_ptr(), lam.numel(), out.data_ptr(),
                               scratch.data_ptr(), int(passes),
                               torch.cuda.current_stream(key.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"Poisson launch failed: CUDA error {err}")
    if lam.numel():
        LAUNCHES += bool(passes & PASS1) + bool(passes & PASS2)


def launch(key, lam):
    """jax's Poisson draws (int64) of ``lam`` under ``key``, by the kernel."""
    _check(key, lam)
    out = torch.empty(lam.shape, dtype=torch.int64, device=lam.device)
    scratch = torch.empty(lam.numel() + 1, dtype=torch.int32, device=lam.device)
    run_passes(key, lam, out, scratch, PASS1 | PASS2)
    return out


def plain(key, lam, tally=None):
    """The same draws in torch ops, on any device; with ``tally`` (a
    list), the threefry hashes the draw needs are added to it
    (``samplers.py``)."""
    from pytensor_tpu_torch.tensor.random.samplers import poisson_loops

    _check(key, lam)
    return poisson_loops(key, lam, tally)


def draw(key, lam):
    """``plain`` for a key on the CPU, else ``launch``."""
    if key.device.type == "cpu":
        return plain(key, lam)
    return launch(key, lam)

"""The binomial kernel behind the port's binomial and multinomial draws,
and its plain version.

No Pallas kernel is its counterpart: the JAX package draws binomial,
betabinom and multinomial through ``jax.random``, whose ``_binomial`` XLA
runs as the inversion and BTRS ``while_loop``s over the whole array, in
the probability's dtype (``jax/_src/random.py:2681-2838``).  The CUDA
kernel (``csrc/binomial.cu``) keeps jax's whole-array semantics in two
launches: pass 1 runs each element to its first BTRS accept (and the
inversion elements to their end) and takes the array's pass count N on
the card, pass 2 runs the BTRS elements on to N, keeps their last accept
and applies jax's edges; its source says what bounds it and how.

Built by ``link/cuda/build.py`` (nvcc for sm_90a, ``-fmad=false``) at
first use and called through ``ctypes`` on torch's current stream.
``draw`` takes the plain version (``tensor/random/samplers.py
binomial_loops``) for a key on the CPU only; for a key on the card it
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches, two a
draw.
"""

from __future__ import annotations

import ctypes

import torch

from pytensor_tpu_torch.link.cuda.build import CSRC

SOURCE = CSRC / "binomial.cu"
HEADERS = ("threefry.cuh", "loops.cuh")
FLAGS = ("-fmad=false",)
PASS1, PASS2 = 1, 2
# the kernel's out_kind of each draw dtype
OUT_KINDS = {torch.float32: 0, torch.float64: 1, torch.int64: 2}

# launches of the kernel's passes since the count was last set to 0
LAUNCHES = 0

_LIB = None
BUILD_LOG = ""


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (once per source hash) and load the binomial library."""
    from pytensor_tpu_torch.link.cuda.build import build_csrc

    global _LIB, BUILD_LOG
    if _LIB is None:
        lib, BUILD_LOG = build_csrc("binomial", HEADERS, verbose, FLAGS)
        p = ctypes.c_void_p
        lib.binomial_draw.argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                      p, p, ctypes.c_int, p]
        lib.binomial_draw.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(key, count, prob, dtype):
    if key.dtype != torch.int64 or tuple(key.shape) != (2,) or not key.is_contiguous():
        raise ValueError(f"the binomial kernel takes a key of 2 contiguous int64, got "
                         f"{key.dtype} of shape {tuple(key.shape)}")
    if prob.dtype not in (torch.float32, torch.float64) or count.dtype != prob.dtype:
        raise ValueError(f"the binomial kernel takes a float32 or float64 count and "
                         f"probability of one dtype, got {count.dtype} and {prob.dtype}")
    if dtype not in (prob.dtype, torch.float64, torch.int64):
        raise ValueError(f"the binomial kernel draws in float64, int64 or the probability's "
                         f"dtype, not {dtype}")
    for x in (count, prob):
        if x.ndim != 1 or not x.is_contiguous() or x.shape != prob.shape:
            raise ValueError("the binomial kernel takes a flat contiguous count and "
                             "probability of one length")
        if x.device != key.device:
            raise ValueError(f"the key is on {key.device}, a parameter on {x.device}")


def run_passes(key, count, prob, out, scratch, passes):
    """Launch the kernel's ``passes`` (``PASS1``, ``PASS2`` or both) on
    ``out`` (n draws) and ``scratch`` (int32, n + 1) as pass 1 left them."""
    global LAUNCHES
    if key.device.type != "cuda":
        raise ValueError(f"the binomial kernel runs on CUDA tensors; the key is on {key.device}")
    err = build().binomial_draw(
        key.data_ptr(), count.data_ptr(), prob.data_ptr(), prob.numel(),
        int(prob.dtype == torch.float64), OUT_KINDS[out.dtype], out.data_ptr(),
        scratch.data_ptr(), int(passes), torch.cuda.current_stream(key.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"binomial launch failed: CUDA error {err}")
    if prob.numel():
        LAUNCHES += bool(passes & PASS1) + bool(passes & PASS2)


def launch(key, count, prob, dtype=torch.float64):
    """jax's binomial draws of ``count`` trials of ``prob`` under ``key``
    in ``dtype`` (int64: the float64 draws cast as XLA casts them), by the
    kernel."""
    _check(key, count, prob, dtype)
    out = torch.empty(prob.shape, dtype=dtype, device=prob.device)
    scratch = torch.empty(prob.numel() + 1, dtype=torch.int32, device=prob.device)
    run_passes(key, count, prob, out, scratch, PASS1 | PASS2)
    return out


def plain(key, count, prob, dtype=torch.float64, tally=None):
    """The same draws in torch ops, on any device; with ``tally`` (a
    list), the threefry hashes the draw needs are added to it
    (``samplers.py``)."""
    from pytensor_tpu_torch.tensor.random.samplers import binomial_loops

    _check(key, count, prob, dtype)
    return binomial_loops(key, count, prob, dtype, tally)


def draw(key, count, prob, dtype=torch.float64):
    """``plain`` for a key on the CPU, else ``launch``."""
    if key.device.type == "cpu":
        return plain(key, count, prob, dtype)
    return launch(key, count, prob, dtype)

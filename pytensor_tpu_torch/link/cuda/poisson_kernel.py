"""The Poisson kernel behind the port's Poisson draws, and its plain
version.

No Pallas kernel is its counterpart: the JAX package draws poisson
through ``jax.random``, whose ``_poisson`` XLA runs as Knuth's and
Hormann's (PTRS) ``while_loop``s over the whole array, in float32
(``jax/_src/random.py:1547-1631``).  The CUDA kernel (``csrc/poisson.cu``)
keeps jax's whole-array semantics in one cooperative launch of the three
phases of ``csrc/loops.cuh`` (``loop_state``): Knuth's elements to their
end and the PTRS elements to their first accept, then, only where a PTRS
element is, the dummy lam's first accepts into the pass count N (where
they can raise it) and each PTRS element's last accept before N,
searched down from N - 1.  N stays on the card.  A block shares the key chain's pass
keys in shared memory, queues its elements by branch and drains each
queue, a thread taking the next element when its own ends; the source
says what bounds the kernel and how the design meets it.

Built by ``link/cuda/build.py`` (nvcc for sm_90a, ``-fmad=false``) at
first use and called through ``ctypes`` on torch's current stream.
``draw`` takes the plain version (``tensor/random/samplers.py
poisson_loops``) for a key on the CPU only; for a key on the card it
launches the kernel or raises.  ``LAUNCHES`` counts kernel launches: one
a draw.
"""

from __future__ import annotations

import ctypes

import torch

from pytensor_tpu_torch.link.cuda import threefry_kernel as tk
from pytensor_tpu_torch.link.cuda.build import CSRC
from pytensor_tpu_torch.link.cuda.loop_state import STATE_WORDS

SOURCE = CSRC / "poisson.cu"
HEADERS = ("threefry.cuh", "loops.cuh")
FLAGS = ("-fmad=false",)

# launches of the kernel since the count was last set to 0
LAUNCHES = 0

_LIB = None
BUILD_LOG = ""


def bind(lib):
    """Give ``lib``'s C entry its argument types."""
    p = ctypes.c_void_p
    lib.poisson_draw.argtypes = [p, p, p, ctypes.c_longlong, p, p, p]
    lib.poisson_draw.restype = ctypes.c_int
    return lib


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (once per source hash) and load the Poisson library."""
    from pytensor_tpu_torch.link.cuda.build import build_csrc

    global _LIB, BUILD_LOG
    if _LIB is None:
        lib, BUILD_LOG = build_csrc("poisson", HEADERS, verbose, FLAGS)
        _LIB = bind(lib)
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


def run(key, lam, out, state, lib=None, split=None):
    """Draw into ``out`` (int64, n) with ``state`` (``STATE_WORDS`` int32)
    as scratch; ``lib``, a build of the source other than the kernel's
    (the stamped variant), launches uncounted; with ``split`` (a (2, 2)
    int64 tensor) the draw is under ``split(key)[1]`` and the launch writes
    ``split(key)`` into it."""
    global LAUNCHES
    if key.device.type != "cuda":
        raise ValueError(f"the Poisson kernel runs on CUDA tensors; the key is on {key.device}")
    err = (lib or build()).poisson_draw(
        key.data_ptr(), None if split is None else split.data_ptr(), lam.data_ptr(),
        lam.numel(), out.data_ptr(), state.data_ptr(),
        torch.cuda.current_stream(key.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"Poisson launch failed: CUDA error {err}")
    if lam.numel() and lib is None:
        LAUNCHES += 1


def launch(key, lam, split=None):
    """jax's Poisson draws (int64) of ``lam`` under ``key``, by the kernel;
    with ``split``, under ``split(key)[1]``, the launch writing
    ``split(key)`` into ``split``."""
    _check(key, lam)
    out = torch.empty(lam.shape, dtype=torch.int64, device=lam.device)
    state = torch.empty(STATE_WORDS, dtype=torch.int32, device=lam.device)
    run(key, lam, out, state, split=split)
    return out


def plain(key, lam, tally=None, split=None):
    """The same draws in torch ops, on any device (with ``split`` the
    plain split written into it first); with ``tally`` (a list), the
    threefry hashes the draw needs are added to it (``samplers.py``)."""
    from pytensor_tpu_torch.tensor.random.samplers import poisson_loops

    _check(key, lam)
    return poisson_loops(tk.split_into(key, split), lam, tally)


def draw(key, lam, split=None):
    """``plain`` for a key on the CPU, else ``launch``."""
    return (plain if key.device.type == "cpu" else launch)(key, lam, split=split)

"""The gamma kernel behind the port's gamma draws, and its plain version.

No Pallas kernel is its counterpart: the JAX package draws gamma,
loggamma and the distributions built on them through ``jax.random``,
whose ``_gamma_one`` XLA runs as a vmapped ``while_loop``
(``jax/_src/random.py:1298, :1398``).  The CUDA kernel
(``csrc/gamma.cu``) runs on the blocks the card holds: each lane runs one
step of its element's loops an iteration, hashing in registers only the
keys that step reads, and takes the block's next element when its own is
done; a warp's boosted draws run their tails 32 at a time.  Its source
says what bounds it and how.

Built by ``link/cuda/build.py`` (nvcc for sm_90a, into the gitignored
``build/kernels/``) at first use and called through ``ctypes`` on torch's
current stream.  ``draw`` takes the plain version
(``tensor/random/samplers.py gamma_loops``) for a key on the CPU only; for
a key on the card it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

from pytensor_tpu_torch.link.cuda import threefry_kernel as tk
from pytensor_tpu_torch.link.cuda.build import CSRC

SOURCE = CSRC / "gamma.cu"
HEADERS = ("threefry.cuh", "loops.cuh")
# nvcc's default contraction: the kernel's own multiplies, adds and divides
# are __dmul_rn, __dadd_rn and __ddiv_rn, which nvcc never fuses, so each
# is rounded as the plain version's torch op; and CUDA's pow is then
# compiled as in torch's own build (with -fmad=false its bits differ from
# torch.pow's in some draws by a few ulps)
FLAGS = ()

# launches of the kernel since the count was last set to 0
LAUNCHES = 0

_LIB = None
BUILD_LOG = ""


def bind(lib):
    """Give ``lib``'s C entries their argument types (the stamped
    variant's also ``gamma_serial_draw``, the first design's draw)."""
    p = ctypes.c_void_p
    for name in ("gamma_draw", "gamma_serial_draw"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = [p, p, p, ctypes.c_longlong, ctypes.c_int, p, p]
            getattr(lib, name).restype = ctypes.c_int
    return lib


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (once per source hash) and load the gamma library."""
    from pytensor_tpu_torch.link.cuda.build import build_csrc

    global _LIB, BUILD_LOG
    if _LIB is None:
        lib, BUILD_LOG = build_csrc("gamma", HEADERS, verbose, FLAGS)
        _LIB = bind(lib)
    return _LIB


def _check(key, alpha):
    if key.dtype != torch.int64 or tuple(key.shape) != (2,) or not key.is_contiguous():
        raise ValueError(f"the gamma kernel takes a key of 2 contiguous int64, got {key.dtype} "
                         f"of shape {tuple(key.shape)}")
    if alpha.dtype != torch.float64 or alpha.ndim != 1 or not alpha.is_contiguous():
        raise ValueError(f"the gamma kernel takes a flat contiguous float64 alpha, got "
                         f"{alpha.dtype} of shape {tuple(alpha.shape)}")
    if alpha.device != key.device:
        raise ValueError(f"the key is on {key.device}, alpha on {alpha.device}")


def run(key, alpha, out, log_space=False, lib=None, entry="gamma_draw", split=None):
    """Draw into ``out`` (float64, n); ``lib``, a build of the source other
    than the kernel's (the stamped variant), launches ``entry`` uncounted;
    with ``split`` (a (2, 2) int64 tensor) the draw is under
    ``split(key)[1]`` and the launch writes ``split(key)`` into it."""
    global LAUNCHES
    if key.device.type != "cuda":
        raise ValueError(f"the gamma kernel runs on CUDA tensors; the key is on {key.device}")
    err = getattr(lib or build(), entry)(
        key.data_ptr(), None if split is None else split.data_ptr(), alpha.data_ptr(),
        alpha.numel(), int(bool(log_space)), out.data_ptr(),
        torch.cuda.current_stream(key.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gamma launch failed: CUDA error {err}")
    if alpha.numel() and lib is None:
        LAUNCHES += 1


def launch(key, alpha, log_space=False, split=None):
    """jax's standard gamma (``loggamma`` with ``log_space``) of each
    element of ``alpha`` under ``split(key, n)[i]``, by the kernel; with
    ``split``, under ``split(key)[1]``, the launch writing ``split(key)``
    into ``split``."""
    _check(key, alpha)
    out = torch.empty_like(alpha)
    run(key, alpha, out, log_space, split=split)
    return out


def plain(key, alpha, log_space=False, tally=None, passes=None, split=None):
    """The same draws in torch ops, on any device (with ``split`` the
    plain split written into it first); with ``tally`` (a list), the
    threefry hashes the draw needs are added to it, and with ``passes`` (a
    dict) its outer and inner passes and boosted draws (``samplers.py``)."""
    from pytensor_tpu_torch.tensor.random.samplers import gamma_loops

    _check(key, alpha)
    return gamma_loops(tk.split_into(key, split), alpha, log_space, tally, passes)


def draw(key, alpha, log_space=False, split=None):
    """``plain`` for a key on the CPU, else ``launch``."""
    return (plain if key.device.type == "cpu" else launch)(key, alpha, log_space, split=split)

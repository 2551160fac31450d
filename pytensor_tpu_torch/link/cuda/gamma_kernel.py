"""The gamma kernel behind the port's gamma draws, and its plain version.

No Pallas kernel is its counterpart: the JAX package draws gamma,
loggamma and the distributions built on them through ``jax.random``,
whose ``_gamma_one`` XLA runs as a vmapped ``while_loop``
(``jax/_src/random.py:1298, :1398``).  The CUDA kernel
(``csrc/gamma.cu``) runs each element's two loops in one thread, its keys
hashed in registers; its source says what bounds it and how.

Built by ``link/cuda/build.py`` (nvcc for sm_90a, into the gitignored
``build/kernels/``) at first use and called through ``ctypes`` on torch's
current stream.  ``draw`` takes the plain version
(``tensor/random/samplers.py gamma_loops``) for a key on the CPU only; for
a key on the card it launches the kernel or raises.
"""

from __future__ import annotations

import ctypes

import torch

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


def build(verbose: bool = False) -> ctypes.CDLL:
    """Compile (once per source hash) and load the gamma library."""
    from pytensor_tpu_torch.link.cuda.build import build_csrc

    global _LIB, BUILD_LOG
    if _LIB is None:
        lib, BUILD_LOG = build_csrc("gamma", HEADERS, verbose, FLAGS)
        p = ctypes.c_void_p
        lib.gamma_draw.argtypes = [p, p, ctypes.c_longlong, ctypes.c_int, p, p]
        lib.gamma_draw.restype = ctypes.c_int
        _LIB = lib
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


def launch(key, alpha, log_space=False):
    """jax's standard gamma (``loggamma`` with ``log_space``) of each
    element of ``alpha`` under ``split(key, n)[i]``, by the kernel."""
    global LAUNCHES
    _check(key, alpha)
    if key.device.type != "cuda":
        raise ValueError(f"the gamma kernel runs on CUDA tensors; the key is on {key.device}")
    lib = build()
    out = torch.empty_like(alpha)
    err = lib.gamma_draw(key.data_ptr(), alpha.data_ptr(), alpha.numel(), int(bool(log_space)),
                         out.data_ptr(), torch.cuda.current_stream(key.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gamma launch failed: CUDA error {err}")
    if alpha.numel():
        LAUNCHES += 1
    return out


def plain(key, alpha, log_space=False, tally=None):
    """The same draws in torch ops, on any device; with ``tally`` (a
    list), the threefry hashes the draw needs are added to it
    (``samplers.py``)."""
    from pytensor_tpu_torch.tensor.random.samplers import gamma_loops

    _check(key, alpha)
    return gamma_loops(key, alpha, log_space, tally)


def draw(key, alpha, log_space=False):
    """``plain`` for a key on the CPU, else ``launch``."""
    if key.device.type == "cpu":
        return plain(key, alpha, log_space)
    return launch(key, alpha, log_space)

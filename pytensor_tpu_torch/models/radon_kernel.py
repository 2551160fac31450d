"""K3: the hand-written radon leapfrog chain, and its plain version.

Counterpart of ``pytensor_tpu/models/radon_pallas.py``.  The CUDA kernel
(``csrc/radon_leapfrog.cu``) runs ``n_steps`` leapfrog steps with the
analytic ``dlogp`` of ``models/radon.py`` and the ``logp`` of the final
``theta``, one block per chain; its source says what bounds it and how.

The kernel is built by ``link/cuda/build.py`` (nvcc for sm_90a into the
gitignored ``build/kernels/``, keyed by a hash of the source) at first
use and called through ``ctypes``.  Its C entry returns
``cudaGetLastError()`` and the wrapper raises on a non-zero code.  The
plain version is the same analytic leapfrog in torch ops, with
``a[county]`` and ``index_add_``; the wrapper takes it for CPU tensors
only.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from pytensor_tpu_torch.models.radon import LOG_2PI, radon_synthetic_data

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "radon_leapfrog.cu"

# launches of the kernel since the count was last set to 0
LAUNCHES = 0

# the steps whose clock64() stamps the stamped variant records
# (K3_STAMP_FROM, K3_STAMP_STEPS in the source)
STAMP_FROM, STAMP_STEPS = 16, 16

# the nvcc flags of the stamped variant
STAMPED = ("-DK3_STAMPS",)

_LIBS: dict = {}
# the compiler's output of each build, by its extra nvcc flags
BUILD_LOGS: dict = {}


def build(verbose: bool = False, flags=()) -> ctypes.CDLL:
    """Compile (once per source hash and flags) and load the K3 library.

    ``flags`` are added to nvcc's: ``STAMPED`` builds the measurement
    variant, whose thread 0 records ``clock64()`` after each part of a
    step; ``-DK3_ROW_CAP=0`` keeps every county's rows in shared memory.
    With ``verbose`` the compiler's register and shared-memory report
    (``-Xptxas -v``) is kept in ``BUILD_LOGS[flags]``.
    """
    from pytensor_tpu_torch.link.cuda.build import build_library

    flags = tuple(flags)
    lib = _LIBS.get(flags)
    if lib is not None:
        return lib
    lib, BUILD_LOGS[flags] = build_library(SOURCE.read_text(), "radon_leapfrog", SOURCE,
                                           verbose, flags=flags)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.radon_leapfrog.argtypes = [p, p, p, p, p, p, p, p, i, i, i, i, i, ctypes.c_float, i,
                                   p, p]
    lib.radon_leapfrog.restype = i
    lib.radon_leapfrog_smem_bytes.argtypes = [i, i]
    lib.radon_leapfrog_smem_bytes.restype = ctypes.c_size_t
    lib.radon_leapfrog_threads.argtypes = [i]
    lib.radon_leapfrog_threads.restype = i
    lib.radon_leapfrog_stamp_labels.restype = ctypes.c_char_p
    _LIBS[flags] = lib
    return lib


def stamp_labels() -> list[str]:
    """The stamped variant's stamps of a step, in order; stamp 0 opens it."""
    return build(flags=STAMPED).radon_leapfrog_stamp_labels().decode().split("|")


def csr_layout(county, floor, y, n_counties):
    """Observations sorted by county, and each county's [start, end)."""
    order = np.argsort(county, kind="stable")
    ptr = np.zeros(n_counties + 1, dtype=np.int32)
    ptr[1:] = np.cumsum(np.bincount(county, minlength=n_counties))
    return (np.ascontiguousarray(floor[order], dtype=np.float32),
            np.ascontiguousarray(y[order], dtype=np.float32), ptr)


@dataclass
class RadonData:
    """The radon observations on one device, in both layouts."""

    county: torch.Tensor    # int64, observation order (plain version)
    floor: torch.Tensor
    y: torch.Tensor
    floor_sorted: torch.Tensor  # float32, sorted by county (kernel)
    y_sorted: torch.Tensor
    county_ptr: torch.Tensor    # int32 CSR offsets, n_counties + 1
    max_rows: int               # the largest county's count of observations

    @property
    def n_counties(self):
        return self.county_ptr.shape[0] - 1

    @classmethod
    def from_layout(cls, county, floor, y, n_counties, device):
        from pytensor_tpu_torch.link.torch.convert import as_torch

        floor_s, y_s, ptr = csr_layout(county, floor, y, n_counties)
        return cls(*(as_torch(v, device) for v in (county, floor, y, floor_s, y_s, ptr)),
                   int(np.diff(ptr).max(initial=0)))


def leapfrog_launch(theta, m, data, n_steps, eps, stamps=None, flags=()):
    """Run K3 on CUDA tensors ``theta``, ``m`` of shape (n_params,) or
    (chains, n_params); returns ``(theta', m', logp')``.  ``stamps``, an
    int64 CUDA tensor of ``(STAMP_STEPS, len(stamp_labels()))``, runs the
    stamped variant and receives its readings (block 0's thread 0);
    ``flags`` picks a build (``build``)."""
    global LAUNCHES
    n_counties = data.n_counties
    n_params = n_counties + 4
    for name, t in (("theta", theta), ("m", m)):
        if t.device.type != "cuda" or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(f"K3 takes contiguous float32 CUDA tensors; {name} is "
                             f"{t.dtype} on {t.device}")
        if t.shape[-1] != n_params or t.ndim not in (1, 2):
            raise ValueError(f"K3: {name} has shape {tuple(t.shape)}, expected (..., {n_params})")
    if theta.shape != m.shape or data.y_sorted.device != theta.device:
        raise ValueError("K3: theta, m and the data must match in shape and device")
    n_chains = 1 if theta.ndim == 1 else theta.shape[0]
    if stamps is not None:
        if (stamps.dtype != torch.int64 or stamps.device != theta.device
                or stamps.numel() != STAMP_STEPS * len(stamp_labels())):
            raise ValueError("K3: stamps must be an int64 tensor of STAMP_STEPS x the stamps a "
                             "step on the chain's device")
        flags = STAMPED + tuple(flags)
    lib = build(flags=flags)
    theta_out = torch.empty_like(theta)
    m_out = torch.empty_like(m)
    logp_out = torch.empty(theta.shape[:-1], dtype=torch.float32, device=theta.device)
    stream = torch.cuda.current_stream(theta.device).cuda_stream
    err = lib.radon_leapfrog(theta.data_ptr(), m.data_ptr(), theta_out.data_ptr(),
                             m_out.data_ptr(), logp_out.data_ptr(), data.y_sorted.data_ptr(),
                             data.floor_sorted.data_ptr(), data.county_ptr.data_ptr(),
                             data.y_sorted.shape[0], n_counties, data.max_rows,
                             n_chains, int(n_steps), float(eps), 0,
                             None if stamps is None else stamps.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"K3 launch failed: CUDA error {err}")
    LAUNCHES += 1
    return theta_out, m_out, logp_out


def leapfrog_plain(theta, m, data, n_steps, eps):
    """The same chain in torch ops, on any device."""
    county, floor, y = data.county, data.floor, data.y
    nc = data.n_counties
    th = theta.reshape(-1, nc + 4).clone()
    mm = m.reshape(-1, nc + 4).clone()
    n_obs = y.shape[0]

    def parts(t):
        a_raw = t[:, :nc]
        mu, lsa, b, lsy = t[:, nc], t[:, nc + 1], t[:, nc + 2], t[:, nc + 3]
        sig_a, inv_sy = torch.exp(lsa), torch.exp(-lsy)
        a = mu[:, None] + sig_a[:, None] * a_raw
        r = (y - a[:, county] - b[:, None] * floor) * inv_sy[:, None]
        return a_raw, mu, lsa, b, lsy, sig_a, inv_sy, r

    def dlogp(t):
        a_raw, mu, lsa, b, lsy, sig_a, inv_sy, r = parts(t)
        rs = r * inv_sy[:, None]
        seg = torch.zeros_like(a_raw).index_add_(1, county, rs)
        g = torch.empty_like(t)
        g[:, :nc] = sig_a[:, None] * seg - a_raw
        g[:, nc] = seg.sum(1) - mu / 100
        g[:, nc + 1] = sig_a * (a_raw * seg).sum(1) - lsa / 4 + 1
        g[:, nc + 2] = (rs * floor).sum(1) - b / 100
        g[:, nc + 3] = (r * r).sum(1) - n_obs - lsy / 4 + 1
        return g

    half = eps / 2
    g = dlogp(th)
    for _ in range(n_steps):
        mm = mm + half * g
        th = th + eps * mm
        g = dlogp(th)
        mm = mm + half * g
    a_raw, mu, lsa, b, lsy, sig_a, inv_sy, r = parts(th)
    c = 0.5 * LOG_2PI
    lp = (-0.5 * (r * r).sum(1) - n_obs * (lsy + c) - 0.5 * (a_raw * a_raw).sum(1) - nc * c
          - 0.5 * (mu / 10) ** 2 - float(np.log(10.0)) - c
          - 0.5 * (b / 10) ** 2 - float(np.log(10.0)) - c
          - 0.5 * (lsa / 2) ** 2 - float(np.log(2.0)) - c
          - 0.5 * (lsy / 2) ** 2 - float(np.log(2.0)) - c
          + lsa + lsy)
    shape = theta.shape
    return th.reshape(shape), mm.reshape(shape), lp.reshape(shape[:-1])


def make_radon_leapfrog_kernel(n_steps=1024, n_obs=919, n_counties=85,
                               eps=1e-3, seed=0, device="cuda"):
    """Return ``(fn, theta0, m0, n_params)``: ``fn(theta, m) -> (theta', m',
    logp')`` runs ``n_steps`` leapfrog steps, on CUDA tensors with K3 and
    on CPU tensors with the plain version.  ``theta0`` and ``m0`` are the
    start the JAX package's Pallas kernel uses, as numpy arrays."""
    from pytensor_tpu_torch.link.torch.convert import as_torch, resolve_device

    device = resolve_device(device)
    county, floor, y = radon_synthetic_data(n_obs, n_counties, seed, "float32")
    data = RadonData.from_layout(county, floor, y, n_counties, device)

    def fn(theta, m):
        theta = as_torch(theta, device) if not isinstance(theta, torch.Tensor) else theta
        m = as_torch(m, device) if not isinstance(m, torch.Tensor) else m
        if theta.device.type == "cpu" and m.device.type == "cpu":
            return leapfrog_plain(theta, m, data, n_steps, eps)
        return leapfrog_launch(theta, m, data, n_steps, eps)

    fn.data = data
    n_params = n_counties + 4
    rng = np.random.default_rng(0)
    theta0 = np.zeros(n_params, np.float32)
    theta0[n_counties + 1] = -0.3
    theta0[n_counties + 3] = -0.3
    m0 = rng.standard_normal(n_params).astype(np.float32)
    return fn, theta0, m0, n_params

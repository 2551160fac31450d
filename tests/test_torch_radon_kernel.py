"""K3, the radon leapfrog chain: its plain version against the JAX
package's Pallas kernel, and the host side of the CUDA wrapper.

The JAX side runs ``make_radon_leapfrog_pallas(..., interpret=True)``, as
``tests/test_benchmarks.py:185`` runs it on the CPU.  Both are float32 and
start from the same numpy ``theta0``, ``m0``.  Tolerance: ``rtol 1e-5``
with ``atol 1e-5`` for theta and m, ``rtol 1e-6`` for logp; the two sum
the observations in different orders.

There is no nvcc here, but K3's source (``csrc/radon_leapfrog.cu``) is C++
apart from a few CUDA features: with ``tests/k3_host.h`` in place of
``<cuda_runtime.h>`` (a grid of blocks run in turn, each block as real
threads with a block barrier, warp shuffles through a per-warp buffer),
g++ compiles it into the gitignored ``build/k3_host/`` and runs it on CPU
tensors.  So its county ownership, its one barrier a step, its
double-buffered reduction and its registers are held here against the
plain version (to ``1e-5`` of ``max(1, max|plain|)`` after 8 steps: float32
sums in other orders), and its bits against its variants: the stamped one,
the shared-memory walk and other block sizes.  What this cannot show is
that nvcc accepts the source, or the card's rounding (nvcc contracts
multiply-adds, g++ here does not): ``tests/test_torch_cuda.py`` and
``chip_smoke.py`` show those.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from pytensor_tpu.models.radon_pallas import make_radon_leapfrog_pallas

from pytensor_tpu_torch.models import radon_kernel
from pytensor_tpu_torch.models.radon import radon_synthetic_data


def _both(n_steps, n_obs, n_counties):
    jrun, jth0, jm0, jn = make_radon_leapfrog_pallas(
        n_steps=n_steps, n_obs=n_obs, n_counties=n_counties, interpret=True)
    tfn, tth0, tm0, tn = radon_kernel.make_radon_leapfrog_kernel(
        n_steps=n_steps, n_obs=n_obs, n_counties=n_counties, device="cpu")
    assert jn == tn
    np.testing.assert_array_equal(jth0, tth0)
    np.testing.assert_array_equal(jm0, tm0)
    return jrun, tfn, tth0, tm0


def _check(jout, tout):
    (jt, jm, jlp), (tt, tm, tlp) = [np.asarray(v) for v in jout], [v.numpy() for v in tout]
    assert tt.dtype == tm.dtype == tlp.dtype == np.float32
    np.testing.assert_allclose(tt, jt, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tlp), float(jlp), rtol=1e-6)


@pytest.mark.parametrize("n_steps,n_obs,n_counties", [(8, 120, 11), (3, 919, 85)],
                         ids=["small", "full_width"])
def test_plain_matches_pallas_interpret(n_steps, n_obs, n_counties):
    jrun, tfn, th0, m0 = _both(n_steps, n_obs, n_counties)
    before = radon_kernel.LAUNCHES
    _check(jrun(th0, m0), tfn(th0, m0))
    assert radon_kernel.LAUNCHES == before  # CPU tensors take the plain version


def test_chains_are_independent():
    """A (chains, n_params) batch runs each chain as the single-chain call."""
    tfn, th0, m0, n = radon_kernel.make_radon_leapfrog_kernel(
        n_steps=5, n_obs=120, n_counties=11, device="cpu")
    rng = np.random.default_rng(0)
    th = (th0 + 0.1 * rng.standard_normal((3, n))).astype(np.float32)
    m = rng.standard_normal((3, n)).astype(np.float32)
    bt, bm, blp = tfn(th, m)
    assert tuple(bt.shape) == (3, n) and tuple(blp.shape) == (3,)
    for k in range(3):
        st, sm, slp = tfn(th[k], m[k])
        np.testing.assert_allclose(bt[k].numpy(), st.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(blp[k]), float(slp), rtol=1e-6)


def test_csr_layout_groups_each_county():
    county, floor, y = radon_synthetic_data(919, 85, 0, "float32")
    floor_s, y_s, ptr = radon_kernel.csr_layout(county, floor, y, 85)
    assert ptr.dtype == np.int32 and ptr[0] == 0 and ptr[-1] == 919
    for c in range(85):
        rows = np.flatnonzero(county == c)   # stable order within a county
        np.testing.assert_array_equal(y_s[ptr[c]:ptr[c + 1]], y[rows])
        np.testing.assert_array_equal(floor_s[ptr[c]:ptr[c + 1]], floor[rows])


def test_launch_refuses_cpu_tensors():
    tfn, th0, m0, n = radon_kernel.make_radon_leapfrog_kernel(
        n_steps=1, n_obs=120, n_counties=11, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        radon_kernel.leapfrog_launch(torch.from_numpy(th0), torch.from_numpy(m0),
                                     tfn.data, 1, 1e-3)


# --- the CUDA source, compiled for the host --------------------------------------

BUILD = Path(__file__).resolve().parents[1] / "build" / "k3_host"
HEADER = Path(__file__).resolve().parent / "k3_host.h"
# the builds: the kernel, its stamped variant, every county in shared memory
_VARIANTS = {"k3": (), "stamped": ("-DK3_STAMPS",), "shared": ("-DK3_ROW_CAP=0",)}


@pytest.fixture(scope="module")
def k3_host():
    """K3's source built with g++ against tests/k3_host.h, one library per
    variant of ``_VARIANTS``."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile K3's source for the host")
    src = radon_kernel.SOURCE.read_text().replace("#include <cuda_runtime.h>",
                                                  f'#include "{HEADER}"')
    libs = {}
    for name, flags in _VARIANTS.items():
        key = hashlib.sha256(src.encode() + HEADER.read_bytes()
                             + " ".join(flags).encode()).hexdigest()[:16]
        lib = BUILD / f"libk3_host_{key}.so"
        if not lib.exists():
            BUILD.mkdir(parents=True, exist_ok=True)
            cpp = BUILD / f"k3_host_{key}.{os.getpid()}.cpp"
            cpp.write_text(src)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-shared", "-fPIC", "-pthread",
                                   *flags, "-o", str(tmp), str(cpp)],
                                  capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr[:4000]
            os.replace(tmp, lib)
        handle = ctypes.CDLL(str(lib))
        p, i = ctypes.c_void_p, ctypes.c_int
        handle.radon_leapfrog.argtypes = [p] * 8 + [i] * 5 + [ctypes.c_float, i, p, p]
        handle.radon_leapfrog.restype = i
        libs[name] = handle
    return libs


def _host_run(lib, data, th, m, n_steps, threads=0, stamps=None):
    """``leapfrog_launch`` on CPU tensors through a host build."""
    outs = torch.empty_like(th), torch.empty_like(m), torch.empty(th.shape[:-1])
    err = lib.radon_leapfrog(th.data_ptr(), m.data_ptr(), *[o.data_ptr() for o in outs],
                             data.y_sorted.data_ptr(), data.floor_sorted.data_ptr(),
                             data.county_ptr.data_ptr(), data.y_sorted.shape[0],
                             data.n_counties, data.max_rows, 1 if th.ndim == 1 else th.shape[0],
                             n_steps, 1e-3, threads,
                             None if stamps is None else stamps.data_ptr(), None)
    assert err == 0
    return outs


def _start(n_obs, n_counties, chains, seed=0):
    county, floor, y = radon_synthetic_data(n_obs, n_counties, seed, "float32")
    data = radon_kernel.RadonData.from_layout(county, floor, y, n_counties, "cpu")
    rng = np.random.default_rng(seed)
    shape = (chains, n_counties + 4) if chains else (n_counties + 4,)
    th = torch.from_numpy((0.1 * rng.standard_normal(shape)).astype("float32"))
    m = torch.from_numpy(rng.standard_normal(shape).astype("float32"))
    return data, th, m


def _near_plain(got, data, th, m, n_steps):
    for g, w in zip(got, radon_kernel.leapfrog_plain(th, m, data, n_steps, 1e-3)):
        assert g.shape == w.shape and bool(torch.isfinite(g).all())
        assert float((g - w).abs().max()) / max(1.0, float(w.abs().max())) <= 1e-5


@pytest.mark.parametrize("chains", [None, 3], ids=["one_chain", "three_chains"])
def test_k3_source_matches_plain(k3_host, chains):
    """919 observations, 85 counties: a block of 96 threads, every county's
    rows in registers (the largest county has 20 rows)."""
    data, th, m = _start(919, 85, chains)
    assert data.max_rows <= 24
    _near_plain(_host_run(k3_host["k3"], data, th, m, 8), data, th, m, 8)


def test_k3_source_with_two_counties_a_thread(k3_host):
    """300 counties over a block of 256 threads: threads 0-43 own two
    counties, so the walk reads them from shared memory."""
    data, th, m = _start(2400, 300, 2)
    got = _host_run(k3_host["k3"], data, th, m, 6)
    _near_plain(got, data, th, m, 6)
    # the same bits as every county in shared memory, and as a block of 256
    for again in (_host_run(k3_host["shared"], data, th, m, 6),
                  _host_run(k3_host["k3"], data, th, m, 6, threads=256)):
        assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_k3_stamped_variant_gives_the_same_bits(k3_host):
    data, th, m = _start(919, 85, None)
    n = 20  # stamps record steps 16-19 of these
    k3_host["stamped"].radon_leapfrog_stamp_labels.restype = ctypes.c_char_p
    labels = k3_host["stamped"].radon_leapfrog_stamp_labels().decode().split("|")
    stamps = torch.zeros((radon_kernel.STAMP_STEPS, len(labels)), dtype=torch.int64)
    got = _host_run(k3_host["stamped"], data, th, m, n, stamps=stamps)
    want = _host_run(k3_host["k3"], data, th, m, n)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    rec = stamps[: n - radon_kernel.STAMP_FROM]
    assert bool((rec > 0).all()) and bool((rec.diff(dim=1) >= 0).all())
    assert not stamps[n - radon_kernel.STAMP_FROM:].any()


@pytest.mark.parametrize("threads", [96, 256])
def test_k3_block_size_and_registers_keep_the_bits(k3_host, threads):
    """A block of 96 threads (the default at 85 counties) and one of 256
    give the same bits: a thread's counties are the same, and the second
    level of the reduction pads the missing warps with 0.f where 256
    threads sum warps of zeros.  So does the walk from shared memory."""
    data, th, m = _start(919, 85, 2)
    want = _host_run(k3_host["shared"], data, th, m, 10, threads=256)
    got = _host_run(k3_host["k3"], data, th, m, 10, threads=threads)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_k3_source_refuses_a_block_size(k3_host):
    data, th, m = _start(120, 11, None)
    out = torch.empty_like(th)
    for threads in (100, 288):
        assert k3_host["k3"].radon_leapfrog(
            th.data_ptr(), m.data_ptr(), out.data_ptr(), out.data_ptr(), out.data_ptr(),
            data.y_sorted.data_ptr(), data.floor_sorted.data_ptr(), data.county_ptr.data_ptr(),
            120, 11, data.max_rows, 1, 2, 1e-3, threads, None, None) != 0

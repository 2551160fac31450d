"""The loop samplers' kernel sources (``csrc/gamma.cu``, ``csrc/poisson.cu``,
``csrc/binomial.cu``) compiled by g++ against ``tests/loops_host.h`` and
held against their plain versions (``tensor/random/samplers.py``) on the
CPU: the gamma loops, and pass 1 and pass 2 of the Poisson and binomial
kernels, on the grids of ``tests/torch_random_loops.py``.

- gamma: within 1e-12 of max(1, |draw|) (the host's erfinv, log and pow
  are glibc's and ``tests/k1_host.h``'s, not torch's);
- Poisson: pass 1 finishes Knuth's elements (-1 in the scratch) and leaves
  each PTRS element at its first accept, with the array's pass count N
  that the plain loop runs; after pass 2 the draws are the plain
  version's, but where glibc's float32 ``logf``/``lgammaf`` and torch's
  move a PTRS accept test across its threshold (each such element shown
  within rounding, pass by pass);
- binomial: both passes bit for bit in each of the kernel's dtypes
  (float32 and float64 probabilities; float64, int64 or the probability's
  draws), on the edge grid, a BTRS-heavy grid and the Gibbs chain's
  binomial(1, p).

The plain versions' tally of the threefry hashes a draw needs (the
kernels' bound in chip_smoke.py) is held against the same count made from
each element's first accept (the dummy parameters' too), the array's pass
count N and each Knuth or inversion element's draw.
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

from pytensor_tpu_torch.link.cuda import binomial_kernel as bk
from pytensor_tpu_torch.link.cuda import gamma_kernel as gk
from pytensor_tpu_torch.link.cuda import poisson_kernel as pk
from pytensor_tpu_torch.link.cuda.build import CSRC
from tests.torch_random_loops import GAMMA_ALPHA, LAM, NP, ptrs_near_threshold, ptrs_passes

BUILD = Path(__file__).resolve().parents[1] / "build" / "loops_host"
HOST = Path(__file__).resolve().parent / "loops_host.h"
HEADERS = [HOST, HOST.parent / "threefry_host.h", HOST.parent / "k1_host.h",
           CSRC / "threefry.cuh", CSRC / "loops.cuh"]
KEY = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64)
P = ctypes.c_void_p


def _build(stem):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the loop kernels' sources for the host")
    source = (CSRC / f"{stem}.cu").read_text()
    assert "#include <cuda_runtime.h>" in source
    src = source.replace("#include <cuda_runtime.h>", f'#include "{HOST}"')
    key = hashlib.sha256(src.encode() + b"".join(h.read_bytes() for h in HEADERS)).hexdigest()[:16]
    lib = BUILD / f"lib{stem}_host_{key}.so"
    if not lib.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        cpp = BUILD / f"{stem}_host_{key}.{os.getpid()}.cpp"
        cpp.write_text(src)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx, "-std=c++17", "-O1", "-w", "-ffp-contract=off", "-shared",
                               "-fPIC", f"-I{HOST.parent}", f"-I{CSRC}", "-o", str(tmp),
                               str(cpp)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[:4000]
        os.replace(tmp, lib)
    return ctypes.CDLL(str(lib))


@pytest.fixture(scope="module")
def host():
    libs = {stem: _build(stem) for stem in ("gamma", "poisson", "binomial")}
    libs["gamma"].gamma_draw.argtypes = [P, P, ctypes.c_longlong, ctypes.c_int, P, P]
    libs["poisson"].poisson_draw.argtypes = [P, P, ctypes.c_longlong, P, P, ctypes.c_int, P]
    libs["binomial"].binomial_draw.argtypes = [P, P, P, ctypes.c_longlong, ctypes.c_int,
                                               ctypes.c_int, P, P, ctypes.c_int, P]
    for lib in libs.values():
        for fn in ("gamma_draw", "poisson_draw", "binomial_draw"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = ctypes.c_int
    return libs


def _tile(vals, n, dtype):
    return torch.tensor(np.resize(np.asarray(vals, dtype="float64"), n), dtype=dtype)


@pytest.mark.parametrize("log_space", [False, True], ids=["gamma", "loggamma"])
@pytest.mark.parametrize("alpha", [GAMMA_ALPHA, [2.5], [1e-3]], ids=["grid", "2.5", "1e-3"])
def test_gamma_source_against_plain(host, alpha, log_space):
    a = _tile(alpha, 4096, torch.float64)
    out = torch.empty_like(a)
    assert host["gamma"].gamma_draw(KEY.data_ptr(), a.data_ptr(), a.numel(), int(log_space),
                                    out.data_ptr(), None) == 0
    tally = []
    want = gk.plain(KEY, a, log_space, tally)
    # each element's key and its two and the final uniform, and where alpha
    # is not NaN at least one pass of each loop (4 + 3 hashes)
    assert int(sum(tally)) >= 4 * a.numel() + 7 * int((~torch.isnan(a)).sum())
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    ok = ~torch.isnan(want) & (out != want)
    err = (out[ok] - want[ok]).abs() / want[ok].abs().clamp_min(1.0)
    assert (float(err.max()) if err.numel() else 0.0) <= 1e-12, err


@pytest.mark.parametrize("lam", [LAM, [3.0], [50.0], [1e4]], ids=["grid", "3", "50", "1e4"])
def test_poisson_source_passes_against_plain(host, lam):
    n = 4096
    lv = _tile(lam, n, torch.float32)
    out = torch.empty(n, dtype=torch.int64)
    scratch = torch.empty(n + 1, dtype=torch.int32)
    lib = host["poisson"]
    assert lib.poisson_draw(KEY.data_ptr(), lv.data_ptr(), n, out.data_ptr(), scratch.data_ptr(),
                            pk.PASS1, None) == 0
    want = pk.plain(KEY, lv)
    knuth = torch.isnan(lv) | (lv < 10)
    assert torch.equal(scratch[:n][knuth], torch.full_like(scratch[:n][knuth], -1))
    assert bool((scratch[:n][~knuth] >= 0).all())
    assert torch.equal(out[knuth], want[knuth])
    assert int(scratch[n]) == len(list(ptrs_passes(KEY, lv)))
    assert lib.poisson_draw(KEY.data_ptr(), lv.data_ptr(), n, out.data_ptr(), scratch.data_ptr(),
                            pk.PASS2, None) == 0
    for i in (out != want).nonzero()[:, 0].tolist():
        draws = (int(out[i]), int(want[i]))
        assert ptrs_near_threshold(KEY, lv.numpy(), i, draws), (i, draws)


BINOMIAL_GRIDS = {"edges": NP, "btrs": [(100, 0.4), (1e4, 0.3), (50, 0.9), (12, 0.95)],
                  "gibbs": [(1, p) for p in np.linspace(0.01, 0.99, 37)]}


@pytest.mark.parametrize("grid", list(BINOMIAL_GRIDS))
@pytest.mark.parametrize("dtype,out_dtype", [(torch.float32, torch.float32),
                                             (torch.float32, torch.float64),
                                             (torch.float64, torch.float64),
                                             (torch.float32, torch.int64),
                                             (torch.float64, torch.int64)],
                         ids=["f32", "f32-to-f64", "f64", "f32-to-i64", "f64-to-i64"])
def test_binomial_source_passes_against_plain(host, grid, dtype, out_dtype):
    n = 4096
    pairs = BINOMIAL_GRIDS[grid]
    count = _tile([c for c, _ in pairs], n, dtype)
    prob = _tile([p for _, p in pairs], n, dtype)
    out = torch.empty(n, dtype=out_dtype)
    scratch = torch.empty(n + 1, dtype=torch.int32)
    lib = host["binomial"]
    args = (KEY.data_ptr(), count.data_ptr(), prob.data_ptr(), n, int(dtype == torch.float64),
            bk.OUT_KINDS[out_dtype], out.data_ptr(), scratch.data_ptr())
    assert lib.binomial_draw(*args, bk.PASS1, None) == 0
    assert int(scratch[n]) >= 1
    assert lib.binomial_draw(*args, bk.PASS2, None) == 0
    tally = []
    want = bk.plain(KEY, count, prob, out_dtype, tally)
    # a BTRS pass at least (2 hashes, and the pass's 3 keys) for every element
    assert int(sum(tally)) >= 2 * n + 3
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.equal(out[ok], want[ok])


def test_binomial_source_refuses_a_narrowing_draw(host):
    x = torch.ones(4, dtype=torch.float64)
    out = torch.empty(4, dtype=torch.float32)
    scratch = torch.empty(5, dtype=torch.int32)
    assert host["binomial"].binomial_draw(KEY.data_ptr(), x.data_ptr(), x.data_ptr(), 4, 1, 0,
                                          out.data_ptr(), scratch.data_ptr(), 3, None) != 0


def test_poisson_tally_counts_what_the_draw_needs(host):
    n = 4096
    lv = _tile(LAM, n, torch.float32)
    tally = []
    draws = pk.plain(KEY, lv, tally)
    knuth = torch.isnan(lv) | (lv < 10)
    # each element's first PTRS accept in the plain version's arithmetic
    # (the host's lgammaf moves some), the Knuth elements' on jax's dummy
    # lam, which sets N as well
    first = torch.full((n,), -1, dtype=torch.int64)
    for N, (_, s, t, accept1, reject, _) in enumerate(ptrs_passes(KEY, lv), 1):
        accept = accept1 | (~reject & (s <= t))
        first = torch.where((first < 0) & accept, N - 1, first)
    own = torch.where(knuth & (lv != 0), draws + 1, 0)  # Knuth's passes; NaN's draw is -1
    want = (3 * N + 2 * int(own.max()) + 2 * N * int((~knuth).sum())
            + int((2 * (first + 1) + own)[knuth].sum()))
    assert int(sum(tally)) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_binomial_tally_counts_what_the_draw_needs(host, dtype):
    n = 4096
    pairs = [(c, q) for c in (0, 1, 10, 100, 1e4) for q in (1e-3, 0.3, 0.5, 0.7)]
    count = _tile([c for c, _ in pairs], n, dtype)
    prob = _tile([q for _, q in pairs], n, dtype)
    tally = []
    draws = bk.plain(KEY, count, prob, torch.float64, tally)
    q = torch.where(prob < 0.5, prob, 1 - prob)
    inversion = count * q <= 10
    # the inversion elements' BTRS on jax's dummy count and q
    c_btrs = torch.where(inversion, 1e4, count).to(dtype).contiguous()
    p_btrs = torch.where(inversion, 0.5, prob).to(dtype).contiguous()
    out = torch.empty(n, dtype=torch.float64)
    scratch = torch.empty(n + 1, dtype=torch.int32)
    assert host["binomial"].binomial_draw(
        KEY.data_ptr(), c_btrs.data_ptr(), p_btrs.data_ptr(), n, int(dtype == torch.float64), 1,
        out.data_ptr(), scratch.data_ptr(), bk.PASS1, None) == 0
    first, N = scratch[:n].long(), int(scratch[n])
    assert bool((first >= 0).all())
    k = torch.where(prob < 0.5, draws, count.double() - draws)
    own = torch.where(inversion, k + 1, 0).long()  # the inversion loop's passes
    want = (3 * N + 2 * int(own.max()) + 2 * N * int((~inversion).sum())
            + int((2 * (first + 1) + own)[inversion].sum()))
    assert int(sum(tally)) == want

"""The loop samplers' kernel sources (``csrc/gamma.cu``, ``csrc/poisson.cu``,
``csrc/binomial.cu``) compiled by g++ against ``tests/loops_host.h`` and
held against their plain versions (``tensor/random/samplers.py``) on the
CPU.  The host header runs a block's threads as fibers, so the kernels'
barriers, warp votes and shared memory run as written, and a cooperative
launch's blocks on threads of their own, one at a time, so its grid
barrier and a block that goes on from part of the others' work run as on
the card: the gamma loops; the Poisson and binomial kernels' draw (one
cooperative launch of three phases, ``csrc/loops.cuh``) on one block and
on several, on the grids of ``tests/torch_random_loops.py``:

- gamma: within 1e-12 of max(1, |draw|) (the host's erfinv, log and pow
  are glibc's and ``tests/k1_host.h``'s, not torch's) on one block and on
  a grid cut to 2, 3 and 5 blocks, on jax's edges, the timed alphas, a
  grid of boosted draws only (a warp's tail queue runs full many times)
  and one of alphas below 0 (many passes an element); and bit for bit the
  first design's
  draws (one element a thread, the stamped variant's
  ``gamma_serial_draw``) with the same math library, the stamped kernel's
  hashes and passes the plain loops' tally and passes;
- Poisson: Knuth's elements finished, the flag set where a PTRS element
  is, the array's pass count N that the plain loop runs (0 where no
  element takes PTRS: the dummy search is skipped), and the draws the
  plain version's, but where glibc's float32 ``logf``/``lgammaf`` and
  torch's move a PTRS accept test across its threshold (each such element
  shown within rounding, pass by pass);
- binomial: bit for bit in each of the kernel's dtypes (float32 and
  float64 probabilities; float64, int64 or the probability's draws), on
  the edge grid, a BTRS-heavy grid and the Gibbs chain's binomial(1, p)
  (no BTRS element: the flag and N stay 0);
- a lone PTRS or BTRS element among 4,095 of the other branch, whose draw
  reads N, which the dummy parameters' first accepts set, also where the
  block that holds it starts the dummy search from the N of its own
  phase A, below the array's;
- each kernel's folded draw (its entry given a ``split`` output: the draw
  under ``split(key)[1]``, the split written beside it) on one block and
  on 3:
  the split's keys, and the draws bit for bit those of the same source
  under ``split(key)[1]`` and the plain loops' under it;
- a block's table of pass keys (``PassKeys``, built by ``keys_extend``
  and read by ``keys_at``, which walks the chain on past what the table
  holds) against the key chain walked in torch, for each of the three
  chains, past the table's 128 passes.

The plain versions' tally of the threefry hashes a draw needs (the
kernels' bound in chip_smoke.py) is held against the same count made from
each element's first accept, each rejection element's last accept (the
dummy parameters' first accepts only where some element takes the
rejection branch), the array's pass count N and each Knuth or inversion
element's draw; gamma's against each element's passes walked alone.
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
from pytensor_tpu_torch.link.cuda import loop_state as ls
from pytensor_tpu_torch.link.cuda import poisson_kernel as pk
from pytensor_tpu_torch.link.cuda.build import CSRC
from pytensor_tpu_torch.tensor.random import samplers as S
from tests.torch_random_loops import (
    GAMMA_ALPHA,
    LAM,
    NP,
    btrs_accepts,
    ptrs_near_threshold,
    ptrs_passes,
)

BUILD = Path(__file__).resolve().parents[1] / "build" / "loops_host"
HOST = Path(__file__).resolve().parent / "loops_host.h"
HEADERS = [HOST, HOST.parent / "threefry_host.h", HOST.parent / "k1_host.h",
           CSRC / "threefry.cuh", CSRC / "loops.cuh"]
KEY = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64)
P = ctypes.c_void_p
N_DRAWS = 4096
# a block's table of pass keys built to pass `depth` (keys_start and
# keys_extend) and read by keys_at for passes 0 to upto - 1, those past the
# table walked on from its last key, for test_pass_key_table_against_the_chain
TABLE_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "threefry.cuh"
#include "loops.cuh"
__global__ void table_kernel(const long long* key, int next_at, int nsub, int s0, int s1,
                             int depth, int upto, uint32_t* read) {
  __shared__ PassKeys tab[1];
  if (threadIdx.x == 0)
    keys_init(tab[0], TfKey{(uint32_t)key[0], (uint32_t)key[1]}, next_at, nsub, s0, s1);
  __syncthreads();
  keys_start(tab, 1);
  if (threadIdx.x < 32) keys_extend(tab[0], depth);
  __syncthreads();
  if ((int)threadIdx.x < upto) {
    TfKey a, b;
    keys_at(tab[0], threadIdx.x, a, b);
    read[4 * threadIdx.x] = a.k0; read[4 * threadIdx.x + 1] = a.k1;
    read[4 * threadIdx.x + 2] = b.k0; read[4 * threadIdx.x + 3] = b.k1;
  }
}
extern "C" int table_keys(const long long* key, int next_at, int nsub, int s0, int s1,
                          int depth, int upto, uint32_t* read) {
  LOOP_LAUNCH(table_kernel, 1, nullptr, key, next_at, nsub, s0, s1, depth, upto, read);
  return 0;
}
"""


def _build(stem, source=None):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the loop kernels' sources for the host")
    source = source or (CSRC / f"{stem}.cu").read_text()
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
    # the stamped variant, which also holds the first design
    libs["gamma stamped"] = _build("gamma_stamped",
                                   "#define LOOP_STAMPS\n" + (CSRC / "gamma.cu").read_text())
    gk.bind(libs["gamma"])
    gk.bind(libs["gamma stamped"])
    libs["gamma stamped"].loop_stamps_at.argtypes = [P]
    pk.bind(libs["poisson"])
    bk.bind(libs["binomial"])
    for stem in ("gamma", "gamma stamped", "poisson", "binomial"):
        libs[stem].loops_host_set_grid.argtypes = [ctypes.c_uint]
    return libs


def _tile(vals, n, dtype):
    return torch.tensor(np.resize(np.asarray(vals, dtype="float64"), n), dtype=dtype)


LONE_AT = N_DRAWS // 2 + 7


def _lone(vals, dtype, lone):
    """``vals`` tiled to ``N_DRAWS``, with ``lone`` at ``LONE_AT``."""
    x = _tile(vals, N_DRAWS, dtype)
    x[LONE_AT] = lone
    return x


def _state():
    return torch.full((ls.STATE_WORDS,), -7, dtype=torch.int32)


def _gamma(host, a, log_space, blocks=1, lib="gamma", entry="gamma_draw"):
    """The host kernel's draws of ``a`` on at most ``blocks`` blocks (the
    first design's with ``entry`` ``gamma_serial_draw``)."""
    out = torch.full_like(a, -99.0)
    host[lib].loops_host_set_grid(blocks)
    assert getattr(host[lib], entry)(KEY.data_ptr(), None, a.data_ptr(), a.numel(),
                                     int(log_space), out.data_ptr(), None) == 0
    return out


def _gamma_held(a, out, log_space):
    """Within 1e-12 of max(1, |draw|) of the plain loops' (the host's
    erfinv, log, log1p and pow are glibc's and ``tests/k1_host.h``'s, not
    torch's), NaN where they are."""
    want = gk.plain(KEY, a, log_space)
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    ok = ~torch.isnan(want) & (out != want)
    err = (out[ok] - want[ok]).abs() / want[ok].abs().clamp_min(1.0)
    assert (float(err.max()) if err.numel() else 0.0) <= 1e-12, err


# gamma's grids: jax's edges (0 and NaN among them), the timed alphas, one
# alpha, the boosted alphas (every draw a tail: a warp's tail queue runs
# 32 at a time, many times a warp), and alphas below 0 (d under 1/3: many
# inner and outer passes, elements going on in their lanes while the
# other lanes take new ones)
GAMMA_GRIDS = {"grid": GAMMA_ALPHA, "2.5": [2.5], "1e-3": [1e-3], "typical": [0.5, 1, 2.5, 100],
               "boosted": [1e-3, 0.5], "retries": [-0.6, -0.3]}


@pytest.mark.parametrize("log_space", [False, True], ids=["gamma", "loggamma"])
@pytest.mark.parametrize("alpha", list(GAMMA_GRIDS))
def test_gamma_source_against_plain(host, alpha, log_space):
    # one block: 4,096 elements, ~16 a lane
    a = _tile(GAMMA_GRIDS[alpha], 4096, torch.float64)
    out = _gamma(host, a, log_space)
    tally = []
    gk.plain(KEY, a, log_space, tally)
    # each element's key and the loop's, the boost's subkey and uniform
    # where alpha is below 1 or NaN, and where alpha is not NaN at least one
    # pass of each loop (3 + 2 hashes)
    boosted = ~(a >= 1.0)
    assert int(sum(tally)) >= (2 * a.numel() + 2 * int(boosted.sum())
                               + 5 * int((~torch.isnan(a)).sum()))
    _gamma_held(a, out, log_space)


@pytest.mark.parametrize("log_space", [False, True], ids=["gamma", "loggamma"])
@pytest.mark.parametrize("alpha", ["grid", "typical", "boosted", "retries"])
@pytest.mark.parametrize("blocks,n", [(3, 4096), (2, 1500), (5, 777)], ids=lambda v: str(v))
def test_gamma_source_on_several_blocks(host, blocks, n, alpha, log_space):
    """The grid cut to ``blocks``: each block's share of ``n`` (4,096 on 3
    blocks: 1,366, ~5 elements a lane), a last block with less (777 on 5:
    156 and 153); the draws are those of one block."""
    a = _tile(GAMMA_GRIDS[alpha], n, torch.float64)
    out = _gamma(host, a, log_space, blocks)
    _gamma_held(a, out, log_space)
    assert torch.equal(out.view(torch.int64), _gamma(host, a, log_space).view(torch.int64))


GAMMA_SLOTS = ("setup", "outer", "inner", "test", "rest", "tail", "outer passes",
               "inner passes", "boosted", "hashes")


def _gamma_stamped(host, a, log_space, entry, blocks=1):
    """The stamped variant's draws and its rows' counts, summed."""
    rows = torch.zeros((-(-a.numel() // 256) * 256, len(GAMMA_SLOTS)), dtype=torch.int64)
    assert host["gamma stamped"].loop_stamps_at(rows.data_ptr()) == 0
    out = _gamma(host, a, log_space, blocks, "gamma stamped", entry)
    return out, dict(zip(GAMMA_SLOTS[6:], rows[:, 6:].sum(0).tolist()))


@pytest.mark.parametrize("log_space", [False, True], ids=["gamma", "loggamma"])
@pytest.mark.parametrize("alpha", list(GAMMA_GRIDS))
def test_gamma_source_is_the_first_design(host, alpha, log_space):
    """The first design (one element a thread, every key hashed as soon as
    it can be; the stamped variant's ``gamma_serial_draw``) and the lanes
    that take the next element give the same bits with the same math
    library, and the kernel's
    stamped counts are what the draw reads: its hashes the plain loops'
    tally, its passes theirs, a tail a boosted draw.  The first design
    made more hashes."""
    a = _tile(GAMMA_GRIDS[alpha], 4096, torch.float64)
    first, made_first = _gamma_stamped(host, a, log_space, "gamma_serial_draw")
    got, made = _gamma_stamped(host, a, log_space, "gamma_draw", blocks=3)
    assert torch.equal(got.view(torch.int64), first.view(torch.int64))
    assert torch.equal(got.view(torch.int64), _gamma(host, a, log_space).view(torch.int64))
    tally, passes = [], {}
    gk.plain(KEY, a, log_space, tally, passes)
    assert made == {"outer passes": passes["outer"], "inner passes": passes["inner"],
                    "boosted": passes["boosted"], "hashes": int(sum(tally))}
    assert made_first["hashes"] > made["hashes"]


def _poisson(host, lv, blocks=1):
    """The host kernel's draws of ``lv`` by a cooperative launch on at most
    ``blocks`` blocks, and the state it leaves."""
    out = torch.full((lv.numel(),), -99, dtype=torch.int64)
    state = _state()
    host["poisson"].loops_host_set_grid(blocks)
    assert host["poisson"].poisson_draw(KEY.data_ptr(), None, lv.data_ptr(), lv.numel(),
                                        out.data_ptr(), state.data_ptr(), None) == 0
    return out, state


def _poisson_held(lv, out):
    """The draws are the plain version's, but near a PTRS threshold."""
    want = pk.plain(KEY, lv)
    for i in (out != want).nonzero()[:, 0].tolist():
        draws = (int(out[i]), int(want[i]))
        assert ptrs_near_threshold(KEY, lv.numpy(), i, draws), (i, draws)


@pytest.mark.parametrize("lam", [LAM, [3.0], [50.0], [1e4]], ids=["grid", "3", "50", "1e4"])
def test_poisson_source_passes_against_plain(host, lam):
    lv = _tile(lam, N_DRAWS, torch.float32)
    out, state = _poisson(host, lv)
    knuth = torch.isnan(lv) | (lv < 10)
    # Knuth's elements, the flag set where a PTRS element is
    want = pk.plain(KEY, lv)
    assert torch.equal(out[knuth], want[knuth])
    ptrs = bool((~knuth).any())
    assert (int(state[ls.STATE_FLAG]) > 0) == ptrs
    # the plain loop's pass count N (the dummies' first accepts counted
    # only where a PTRS element reads N)
    assert int(state[ls.STATE_N]) == (len(list(ptrs_passes(KEY, lv))) if ptrs else 0)
    _poisson_held(lv, out)


POISSON_GRIDS = {"grid": (LAM, None), "all-knuth": ([1e-3, 3, 9.999, 0, np.nan], None),
                 "lone-ptrs": ([1e-3, 3, 9.999], 50.0)}


def _ptrs_first(passes, i):
    """Element ``i``'s first accepting pass of ``ptrs_passes``."""
    return next(t for t, (_, s, u, accept1, reject, _) in enumerate(passes)
                if accept1[i] or (not reject[i] and s[i] <= u[i]))


@pytest.mark.parametrize("blocks", [1, 3], ids=lambda b: f"{b}-blocks")
@pytest.mark.parametrize("grid", list(POISSON_GRIDS))
def test_poisson_source_phases(host, grid, blocks):
    vals, lone = POISSON_GRIDS[grid]
    lv = (_tile(vals, N_DRAWS, torch.float32) if lone is None
          else _lone(vals, torch.float32, lone))
    out, state = _poisson(host, lv, blocks)
    ptrs = ~(torch.isnan(lv) | (lv < 10))
    passes = list(ptrs_passes(KEY, lv)) if bool(ptrs.any()) else []
    assert int(state[ls.STATE_N]) == len(passes)
    assert (int(state[ls.STATE_FLAG]) > 0) == bool(passes)
    if lone is not None:
        # the lone PTRS element's draw reads N, which the 4,095 dummies set
        assert len(passes) - 1 > _ptrs_first(passes, LONE_AT)
    _poisson_held(lv, out)


BINOMIAL_GRIDS = {"edges": NP, "btrs": [(100, 0.4), (1e4, 0.3), (50, 0.9), (12, 0.95)],
                  "gibbs": [(1, p) for p in np.linspace(0.01, 0.99, 37)]}
DTYPES = [(torch.float32, torch.float32), (torch.float32, torch.float64),
          (torch.float64, torch.float64), (torch.float32, torch.int64),
          (torch.float64, torch.int64)]
DTYPE_IDS = ["f32", "f32-to-f64", "f64", "f32-to-i64", "f64-to-i64"]


def _binomial(host, count, prob, out_dtype, blocks=1):
    """The host kernel's draws by a cooperative launch on at most
    ``blocks`` blocks, and the state it leaves."""
    out = torch.empty(count.numel(), dtype=out_dtype)
    state = _state()
    host["binomial"].loops_host_set_grid(blocks)
    assert host["binomial"].binomial_draw(
        KEY.data_ptr(), None, count.data_ptr(), prob.data_ptr(), count.numel(),
        int(prob.dtype == torch.float64), bk.OUT_KINDS[out_dtype], out.data_ptr(),
        state.data_ptr(), None) == 0
    return out, state


def _binomial_held(count, prob, out, out_dtype):
    want = bk.plain(KEY, count, prob, out_dtype)
    if out_dtype.is_floating_point:
        assert torch.equal(torch.isnan(out), torch.isnan(want))
        out, want = out[~torch.isnan(want)], want[~torch.isnan(want)]
    assert torch.equal(out, want)


def _inversion(count, prob):
    q = torch.where(prob < 0.5, prob, 1 - prob)
    return torch.isnan(count) | (count < 0) | (count * torch.where(torch.isnan(q) | (q < 0),
                                                                   0.01, q) <= 10)


@pytest.mark.parametrize("grid", list(BINOMIAL_GRIDS))
@pytest.mark.parametrize("dtype,out_dtype", DTYPES, ids=DTYPE_IDS)
def test_binomial_source_passes_against_plain(host, grid, dtype, out_dtype):
    pairs = BINOMIAL_GRIDS[grid]
    count = _tile([c for c, _ in pairs], N_DRAWS, dtype)
    prob = _tile([p for _, p in pairs], N_DRAWS, dtype)
    out, state = _binomial(host, count, prob, out_dtype)
    btrs = bool((~_inversion(count, prob)).any())
    # the flag; N only where a BTRS element reads it
    assert (int(state[ls.STATE_FLAG]) > 0) == btrs
    assert (int(state[ls.STATE_N]) >= 1) == btrs
    tally = []
    bk.plain(KEY, count, prob, out_dtype, tally)
    # a pass at least (a BTRS pass's 2 hashes or an inversion pass's 1, and
    # its keys) for every element
    assert int(sum(tally)) >= (2 if btrs else 1) * N_DRAWS + 2
    _binomial_held(count, prob, out, out_dtype)


def _binomial_grid(grid, dtype):
    if grid == "lone-btrs":
        pairs = BINOMIAL_GRIDS["gibbs"]
        return (_lone([c for c, _ in pairs], dtype, 100.0),
                _lone([p for _, p in pairs], dtype, 0.4))
    pairs = BINOMIAL_GRIDS[grid]
    return (_tile([c for c, _ in pairs], N_DRAWS, dtype),
            _tile([p for _, p in pairs], N_DRAWS, dtype))


def _btrs_accepts(count, prob, dtype):
    """Each element's first and last BTRS accepts, the inversion elements
    on jax's dummy count and q, where some element takes BTRS."""
    inversion = _inversion(count, prob)
    q = torch.where(prob < 0.5, prob, 1 - prob)
    c_btrs = torch.where(inversion, 1e4, torch.floor(count)).to(dtype)
    q_btrs = torch.where(inversion, 0.5, torch.where(torch.isnan(q) | (q < 0), 0.01, q))
    return btrs_accepts(KEY, c_btrs, q_btrs.to(dtype))


@pytest.mark.parametrize("blocks", [1, 3], ids=lambda b: f"{b}-blocks")
@pytest.mark.parametrize("grid", ["edges", "gibbs", "lone-btrs"])
@pytest.mark.parametrize("dtype,out_dtype", DTYPES[2:], ids=DTYPE_IDS[2:])
def test_binomial_source_phases(host, grid, dtype, out_dtype, blocks):
    count, prob = _binomial_grid(grid, dtype)
    out, state = _binomial(host, count, prob, out_dtype, blocks)
    inversion = _inversion(count, prob)
    if bool((~inversion).any()):
        first, _ = _btrs_accepts(count, prob, dtype)
        N = int(first.max()) + 1
        if grid == "lone-btrs":
            # the lone BTRS element's draw reads N, which the dummies set
            assert N - 1 > int(first[~inversion].max())
    else:
        N = 0
    assert int(state[ls.STATE_N]) == N
    assert (int(state[ls.STATE_FLAG]) > 0) == (N > 0)
    _binomial_held(count, prob, out, out_dtype)


def test_binomial_source_refuses_a_narrowing_draw(host):
    x = torch.ones(4, dtype=torch.float64)
    out = torch.empty(4, dtype=torch.float32)
    assert host["binomial"].binomial_draw(KEY.data_ptr(), None, x.data_ptr(), x.data_ptr(), 4, 1,
                                          0, out.data_ptr(), _state().data_ptr(), None) != 0


# (next, subkeys) of each chain: binomial's inversion loop, Knuth's loop,
# and PTRS's and BTRS's
CHAINS = {"inversion": (1, (0,)), "knuth": (0, (1,)), "ptrs-btrs": (0, (1, 2))}


@pytest.mark.parametrize("chain", list(CHAINS))
@pytest.mark.parametrize("upto,depth", [(1, 2), (2, 2), (64, 64), (64, 16), (160, 160)],
                         ids=lambda v: str(v))
def test_pass_key_table_against_the_chain(chain, upto, depth):
    lib = _build("table_probe", TABLE_PROBE)
    lib.table_keys.argtypes = [P, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                               ctypes.c_int, ctypes.c_int, P]
    next_at, subs = CHAINS[chain]
    read = torch.zeros((upto, 2, 2), dtype=torch.int32)
    lib.table_keys(KEY.data_ptr(), next_at, len(subs), subs[0], subs[-1], depth, upto,
                   read.data_ptr())
    want, k = [], KEY
    for _ in range(upto):
        keys = S._split(k, 3)
        want.append(torch.stack([keys[subs[0]], keys[subs[-1]]]))
        k = keys[next_at]
    want = torch.stack(want)
    assert torch.equal(read.long()[:, : len(subs)] & 0xFFFFFFFF, want[:, : len(subs)])


def _gamma_walk(key, alpha):
    """Each element's outer and inner passes and draw, walked one element
    at a time (jax's ``_gamma_one``) in the plain loops' arithmetic."""
    keys = S._split(key, alpha.numel())
    passes, draws = [], []
    for j, a in enumerate(alpha.reshape(-1, 1)):
        ki = keys[j].reshape(2, 1)
        boost = a >= 1.0
        d = torch.where(boost, a, a + 1.0) - S.THIRD
        c = S.true_div(S.THIRD, torch.sqrt(d))
        kk = S._split_each(ki, 0)
        X, V, U = torch.zeros_like(a), torch.ones_like(a), torch.full_like(a, 2.0)
        outer = inner = 0
        while bool(S._gamma_cond(X, V, U, d)):
            outer += 1
            nk, xk, uk = (S._split_each(kk, t) for t in range(3))
            while True:
                inner += 1
                x = S._normal64_each(S._split_each(xk, 1))
                v = 1.0 + x * c
                xk = S._split_each(xk, 0)
                if not bool(v <= 0.0):
                    break
            X, V, U, kk = x * x, (v * v) * v, S._uniform64_each(uk), nk
        passes.append((outer, inner))
        boost_by = torch.where(boost, 1.0, torch.pow(1.0 - S._uniform64_each(
            S._split_each(ki, 1)), S.true_div(1.0, a)))
        draws.append(float((d * V) * boost_by))
    return passes, torch.tensor(draws, dtype=torch.float64)


def test_gamma_tally_counts_what_the_draw_needs():
    """The plain loops' tally against each element's passes, walked alone:
    its key and the loop's; 3 an outer pass, and 1 where another follows;
    2 an inner pass, and 1 where another follows in the same outer pass;
    the boost's subkey and uniform where alpha is below 1 or NaN."""
    a = _tile([1e-3, 0.5, 1, 2.5, 100, 0, np.nan, -0.6], 64, torch.float64)
    tally, counted = [], {}
    draws = gk.plain(KEY, a, False, tally, counted)
    passes, walked = _gamma_walk(KEY, a)
    assert torch.equal(torch.isnan(draws), torch.isnan(walked))
    assert torch.equal(draws[~torch.isnan(draws)], walked[~torch.isnan(walked)])
    boosted = ~(a >= 1.0)
    want = sum(2 + 2 * int(b) + 3 * o + max(o - 1, 0) + 2 * i + (i - o)
               for (o, i), b in zip(passes, boosted.tolist()))
    assert int(sum(tally)) == want
    assert counted == {"outer": sum(o for o, _ in passes), "inner": sum(i for _, i in passes),
                       "boosted": int(boosted.sum())}
    # the retries the grid holds: another outer pass, another inner pass
    assert any(o > 1 for o, _ in passes) and any(i > o for o, i in passes)


def test_poisson_tally_counts_what_the_draw_needs(host):
    n = N_DRAWS
    lv = _tile(LAM, n, torch.float32)
    tally = []
    draws = pk.plain(KEY, lv, tally)
    knuth = torch.isnan(lv) | (lv < 10)
    # each element's first and last PTRS accepts in the plain version's
    # arithmetic (the host's lgammaf moves some), the Knuth elements' on
    # jax's dummy lam, which set N as well
    first = torch.full((n,), -1, dtype=torch.int64)
    last = first.clone()
    for N, (_, s, t, accept1, reject, _) in enumerate(ptrs_passes(KEY, lv), 1):
        accept = accept1 | (~reject & (s <= t))
        first = torch.where((first < 0) & accept, N - 1, first)
        last = torch.where(accept, N - 1, last)
    own = torch.where(knuth & (lv != 0), draws + 1, 0)  # Knuth's passes; NaN's draw is -1
    # every element's passes up to its first accept, a PTRS element's from
    # its last accept to pass N - 1 (its draw), Knuth's to its end
    after = N - torch.maximum(last, first + 1)
    want = (3 * N + 2 * int(own.max()) + int((2 * (first + 1)).sum()) + int(own[knuth].sum())
            + 2 * int(after[~knuth].sum()))
    assert int(sum(tally)) == want


def test_poisson_tally_skips_the_dummy_search():
    # no element takes PTRS: nothing reads N, so the dummies' hashes are
    # not needed
    lv = _tile([1e-3, 3, 9.999, 0], N_DRAWS, torch.float32)
    tally = []
    draws = pk.plain(KEY, lv, tally)
    own = torch.where(lv != 0, draws + 1, 0)
    assert int(sum(tally)) == 2 * int(own.max()) + int(own.sum())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_binomial_tally_counts_what_the_draw_needs(host, dtype):
    n = N_DRAWS
    pairs = [(c, q) for c in (0, 1, 10, 100, 1e4) for q in (1e-3, 0.3, 0.5, 0.7)]
    count = _tile([c for c, _ in pairs], n, dtype)
    prob = _tile([q for _, q in pairs], n, dtype)
    tally = []
    draws = bk.plain(KEY, count, prob, torch.float64, tally)
    q = torch.where(prob < 0.5, prob, 1 - prob)
    inversion = count * q <= 10
    # the inversion elements' BTRS on jax's dummy count and q
    c_btrs = torch.where(inversion, 1e4, count).to(dtype).contiguous()
    p_btrs = torch.where(inversion, 0.5, q).to(dtype).contiguous()
    first, last = btrs_accepts(KEY, c_btrs, p_btrs)
    N = int(first.max()) + 1
    k = torch.where(prob < 0.5, draws, count.double() - draws)
    own = torch.where(inversion, k + 1, 0).long()  # the inversion loop's passes
    after = N - torch.maximum(last, first + 1)
    want = (3 * N + 2 * int(own.max()) + int((2 * (first + 1)).sum())
            + int(own[inversion].sum()) + 2 * int(after[~inversion].sum()))
    assert int(sum(tally)) == want


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_binomial_tally_skips_the_dummy_search(dtype):
    # the Gibbs chain's binomial(1, p): no element takes BTRS, so nothing
    # reads N and the dummies' hashes are not needed
    count = _tile([1.0], N_DRAWS, dtype)
    prob = _tile(np.linspace(0.01, 0.99, 37), N_DRAWS, dtype)
    tally = []
    draws = bk.plain(KEY, count, prob, torch.float64, tally)
    k = torch.where(prob < 0.5, draws, count.double() - draws)
    own = (k + 1).long()
    assert int(sum(tally)) == 2 * int(own.max()) + int(own.sum())


@pytest.mark.parametrize("blocks", [2, 4], ids=lambda b: f"{b}-blocks")
@pytest.mark.parametrize("kernel", ["poisson", "binomial"])
def test_dummy_search_from_a_partial_n(host, kernel, blocks):
    """A cooperative launch on several blocks, where the block that holds
    the lone rejection element (``LONE_AT``, in the third tile of 1,024)
    is the first to end phase A with the flag set (``loops_host.h`` runs a
    block until it waits on another): it starts the dummies' search with N
    known as its element's first accept + 1, below the array's N.  The
    accept1 sweep below that N, and the full search where it finds none,
    leave the array's N and the plain loops' draws."""
    if kernel == "poisson":
        lv = _lone([1e-3, 3, 9.999], torch.float32, 50.0)
        passes = list(ptrs_passes(KEY, lv))
        known, N = _ptrs_first(passes, LONE_AT) + 1, len(passes)
        out, state = _poisson(host, lv, blocks)
        _poisson_held(lv, out)
    else:
        count, prob = _binomial_grid("lone-btrs", torch.float64)
        first, _ = _btrs_accepts(count, prob, torch.float64)
        known, N = int(first[LONE_AT]) + 1, int(first.max()) + 1
        out, state = _binomial(host, count, prob, torch.int64, blocks)
        _binomial_held(count, prob, out, torch.int64)
    assert known < N
    assert int(state[ls.STATE_N]) == N and int(state[ls.STATE_FLAG]) > 0


# the folded entries on grids where the host's math gives the plain
# loops' draws bit for bit (Knuth's and the inversion loop, gamma within
# 1e-12): each kernel under split(KEY)[1], which it makes itself
FOLDED = {"gamma": [0.5, 1, 2.5, 100, 1e-3], "poisson": [1e-3, 3, 9.999, 0],
          "binomial": [(1, p) for p in np.linspace(0.01, 0.99, 37)]}


@pytest.mark.parametrize("blocks", [1, 3], ids=lambda b: f"{b}-blocks")
@pytest.mark.parametrize("kernel", list(FOLDED))
def test_folded_entry_draws_under_the_split(host, kernel, blocks):
    from pytensor_tpu_torch.tensor.random import threefry as tf

    keys = tf.split(KEY)
    sub = keys[1].contiguous()
    split = torch.full((2, 2), -1, dtype=torch.int64)
    lib = host[kernel]
    lib.loops_host_set_grid(blocks)
    if kernel == "gamma":
        a = _tile(FOLDED[kernel], N_DRAWS, torch.float64)
        out, alone = torch.full_like(a, -99.0), torch.full_like(a, -99.0)
        assert lib.gamma_draw(KEY.data_ptr(), split.data_ptr(), a.data_ptr(), a.numel(), 0,
                              out.data_ptr(), None) == 0
        assert lib.gamma_draw(sub.data_ptr(), None, a.data_ptr(), a.numel(), 0, alone.data_ptr(),
                              None) == 0
        want = gk.plain(sub, a)
        err = (out - want).abs() / want.abs().clamp_min(1.0)
        assert float(err.max()) <= 1e-12
    elif kernel == "poisson":
        lv = _tile(FOLDED[kernel], N_DRAWS, torch.float32)
        out, alone = (torch.full((N_DRAWS,), -99, dtype=torch.int64) for _ in range(2))
        assert lib.poisson_draw(KEY.data_ptr(), split.data_ptr(), lv.data_ptr(), N_DRAWS,
                                out.data_ptr(), _state().data_ptr(), None) == 0
        assert lib.poisson_draw(sub.data_ptr(), None, lv.data_ptr(), N_DRAWS, alone.data_ptr(),
                                _state().data_ptr(), None) == 0
        assert torch.equal(out, pk.plain(sub, lv))
    else:
        count = _tile([c for c, _ in FOLDED[kernel]], N_DRAWS, torch.float32)
        prob = _tile([q for _, q in FOLDED[kernel]], N_DRAWS, torch.float32)
        out, alone = (torch.full((N_DRAWS,), -99, dtype=torch.int64) for _ in range(2))
        for k, o, folds in ((KEY, out, split.data_ptr()), (sub, alone, None)):
            assert lib.binomial_draw(k.data_ptr(), folds, count.data_ptr(), prob.data_ptr(),
                                     N_DRAWS, 0, bk.OUT_KINDS[torch.int64], o.data_ptr(),
                                     _state().data_ptr(), None) == 0
        assert torch.equal(out, bk.plain(sub, count, prob, torch.int64))
    assert torch.equal(split, keys)
    assert torch.equal(out.view(torch.int64), alone.view(torch.int64))


# the C entries of this tree as chip_smoke.py's --parent reads another
# tree's: with a split after the key (passed null for a parent's draw), the
# loop kernels' one-launch interface, gamma's parameters
PARENT_ENTRIES = {"threefry": "threefry2x32_draw", "gamma": "gamma_draw",
                  "poisson": "poisson_draw", "binomial": "binomial_draw"}


@pytest.mark.parametrize("kernel", list(PARENT_ENTRIES))
def test_chip_smoke_reads_this_trees_entries(kernel):
    import chip_smoke as cs

    src = (CSRC / f"{kernel}.cu").read_text()
    names = cs.c_params(src, PARENT_ENTRIES[kernel])
    assert names[:2] == ["key", "split"] and names[-1] == "stream"
    if kernel == "gamma":
        assert [a for a in names if a != "split"] == cs.GAMMA_PARAMS
    elif kernel != "threefry":
        assert cs.parent_interface(src, PARENT_ENTRIES[kernel]) == "one launch"

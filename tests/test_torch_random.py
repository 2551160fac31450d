"""The port's Random against the JAX package's, on the CPU.

- threefry (``tensor/random/threefry.py``): the three Random123 answers,
  ``PRNGKey`` of several seeds, ``split`` into 2 and 4, 32- and 64-bit
  ``random_bits`` at six shapes, uniforms and normals, against the
  installed jax, exactly (normals within 1e-15 relative: torch's erfinv
  is not XLA's);
- the threefry kernel's own source (``csrc/threefry.cu``), compiled by g++
  against ``tests/threefry_host.h``, in every mode against its plain
  version, bit for bit (the normals within 1e-12: the host's erfinv); its
  folded entry (the draw under ``split(key)[1]``, the split written beside
  it) against the split followed by the plain draw; the launches its C
  entry counts (one for each run of counters that keeps its high word);
  and the source built with its wide plan (four counters a thread on a
  resident grid) at the host's sizes, with jax's Random123 answers at
  counters near 0, 2**32 and 2**64;
- a random variable's draw with its split deferred (``SplitKey``) against
  the split followed by the sampler on the second key;
- ``chip_smoke.py``'s least-path count of SASS (the kernels' bounds) on a
  listing written out here;
- tier A is ``tests/test_torch_random_dists.py``;
- tier B, jax's loop samplers: each builds with the JAX package's static
  type and draws the JAX package's values, linked and performed (their
  grids and kernels are ``tests/test_torch_random_loops*.py``);
- the lift rewrites give the JAX package's graphs op for op, and the same
  draws;
- default updates and ``no_default_updates``; shared keys from a numpy
  Generator and from the JAX package's key;
- a random walk in ``scan``: the traces draw for draw and the gradient
  with respect to the drift within 1e-10 (float64), which replays the
  keys in the reverse scan; K2 refuses such a scan in both packages.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax._src import prng as jprng

import pytensor_tpu as jptt
import pytensor_tpu.tensor.random as jrand
from pytensor_tpu.graph.rewriting.utils import rewrite_graph as jrewrite
import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor.random as trand
from pytensor_tpu_torch.graph.rewriting.utils import rewrite_graph as trewrite
from pytensor_tpu_torch.link.cuda import threefry_kernel as tk
from pytensor_tpu_torch.tensor.random import threefry as tf
from tests.torch_random import PKGS, as_np, held, kw

SPD = np.array([[2.0, 0.3, 0.1], [0.3, 1.5, -0.2], [0.1, -0.2, 1.0]])


# --- threefry -------------------------------------------------------------------

RANDOM123 = [
    ((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
    ((0xFFFFFFFF, 0xFFFFFFFF), (0xFFFFFFFF, 0xFFFFFFFF), (0x1CB996FC, 0xBB002BE7)),
    ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3), (0xC4923A9C, 0x483DF7A0)),
]


@pytest.mark.parametrize("key,count,want", RANDOM123)
def test_random123_known_answers(key, count, want):
    got = tf.threefry_2x32(torch.tensor(key), torch.tensor(count)).numpy()
    assert tuple(int(v) for v in got) == want
    ref = jprng.threefry_2x32(jnp.asarray(key, dtype=jnp.uint32),
                              jnp.asarray(count, dtype=jnp.uint32))
    assert tuple(int(v) for v in np.asarray(ref)) == want


def test_threefry_2x32_of_an_odd_count():
    count = np.arange(7, dtype=np.uint32) * 0x9E3779B9
    key = np.array([3, 0x80000001], dtype=np.uint32)
    got = tf.threefry_2x32(tf.as_key(key), torch.tensor(count.astype(np.int64))).numpy()
    want = np.asarray(jprng.threefry_2x32(jnp.asarray(key), jnp.asarray(count)))
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("seed", [0, 1, 42, 2 ** 31 - 1, 2 ** 40 + 5, -3])
def test_prng_key_of_seeds(seed):
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed))).astype(np.int64)
    np.testing.assert_array_equal(tf.threefry_seed(seed).numpy(), want)


def test_split_of_prngkey_42():
    assert tf.split(tf.threefry_seed(42)).numpy().tolist() == [
        [1832780943, 270669613], [64467757, 2916123636]]


@pytest.mark.parametrize("num", [2, 4])
def test_split(num):
    key = jax.random.PRNGKey(7)
    want = np.asarray(jax.random.split(key, num)).astype(np.int64)
    np.testing.assert_array_equal(tf.split(tf.as_key(np.asarray(key)), num).numpy(), want)


SHAPES = [(), (1,), (7,), (3, 5), (2, 3, 4), (1000,)]


@pytest.mark.parametrize("width", [32, 64])
@pytest.mark.parametrize("shape", SHAPES)
def test_random_bits(shape, width):
    key = jax.random.PRNGKey(11)
    want = np.asarray(jprng.threefry_random_bits(key, width, shape))
    got = tf.random_bits(tf.as_key(np.asarray(key)), width, shape).numpy()
    if width == 64:
        got = got.view(np.uint64)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(got.dtype))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_uniform_and_normal(dtype):
    key = jax.random.PRNGKey(5)
    tkey = tf.as_key(np.asarray(key))
    tdt = getattr(torch, dtype)
    want = np.asarray(jax.random.uniform(key, (3, 333), getattr(jnp, dtype)))
    np.testing.assert_array_equal(tf.uniform(tkey, (3, 333), tdt).numpy(), want)
    want = np.asarray(jax.random.normal(key, (3, 333), getattr(jnp, dtype)))
    got = tf.normal(tkey, (3, 333), tdt).numpy()
    # torch's erfinv is not XLA's: float64 within a few ulps; float32 (whose
    # erfinv each library approximates by its own polynomial) within 8 ulps,
    # the most being in the tails, where erfinv is steep
    if dtype == "float64":
        np.testing.assert_allclose(got, want, rtol=1e-14, atol=0)
    else:
        ulps = np.abs(got.view(np.int32).astype(np.int64) - want.view(np.int32).astype(np.int64))
        assert ulps.max() <= 8


# --- the kernel's source on the host ----------------------------------------------

BUILD = Path(__file__).resolve().parents[1] / "build" / "threefry_host"
HEADER = Path(__file__).resolve().parent / "threefry_host.h"


def _host_build(flags=()):
    """``csrc/threefry.cu`` built by g++ against ``tests/threefry_host.h``
    with ``flags`` (``-DTHREEFRY_WIDE_N``), bound as the wrapper binds the
    card's build."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile the threefry kernel's source for the host")
    source = tk.SOURCE.read_text()
    assert "#include <cuda_runtime.h>" in source
    src = source.replace("#include <cuda_runtime.h>", f'#include "{HEADER}"')
    key = hashlib.sha256(src.encode() + HEADER.read_bytes() + tk.HEADER.read_bytes()
                         + " ".join(flags).encode()).hexdigest()[:16]
    lib = BUILD / f"libthreefry_host_{key}.so"
    if not lib.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        cpp = BUILD / f"threefry_host_{key}.{os.getpid()}.cpp"
        cpp.write_text(src)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx, "-std=c++17", "-O1", "-w", "-ffp-contract=off", "-shared",
                               "-fPIC", *flags, f"-I{HEADER.parent}", f"-I{tk.HEADER.parent}",
                               "-o", str(tmp), str(cpp)],
                              capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[:4000]
        os.replace(tmp, lib)
    return tk.bind(ctypes.CDLL(str(lib)))


@pytest.fixture(scope="module")
def threefry_host():
    return _host_build()


MODES = {"bits32": tk.BITS32, "bits64": tk.BITS64, "keys": tk.KEYS,
         "uniform64": tk.UNIFORM64, "normal64": tk.NORMAL64, "uniform32": tk.UNIFORM32}


def _launches(first, n):
    """The launches a draw of ``n`` (below 2**30) at the counters from
    ``first`` makes: one for each high word of its counters."""
    return len({((first + i) % 2 ** 64) >> 32 for i in (0, n - 1)})


@pytest.mark.parametrize("first", [0, 2 ** 32 - 3, 2 ** 64 - 2], ids=["0", "2e32", "2e64"])
@pytest.mark.parametrize("n", [1, 2, 300, 5000])
@pytest.mark.parametrize("mode", list(MODES))
def test_kernel_source_against_plain(threefry_host, mode, n, first):
    m = MODES[mode]
    key = torch.tensor([0x13198A2E, 0xFFFFFFFF], dtype=torch.int64)
    lo, hi = (-2.5, 3.0) if mode.startswith("uniform") else (0.0, 1.0)
    want = tk.plain(key, n, m, lo, hi, first)
    out = torch.empty_like(want)
    made = threefry_host.threefry2x32_draw(key.data_ptr(), None, first, n, m, out.data_ptr(),
                                           lo, hi, None)
    assert made == _launches(first, n)
    if mode == "normal64":
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-12, atol=1e-15)
    else:
        assert torch.equal(out, want)
    assert threefry_host.threefry2x32_draw(key.data_ptr(), None, first, n, 9, out.data_ptr(), lo,
                                           hi, None) < 0


@pytest.mark.parametrize("key,count,want", RANDOM123)
def test_kernel_source_gives_the_random123_answers(threefry_host, key, count, want):
    out = torch.empty((1, 2), dtype=torch.int64)
    first = (count[0] << 32) | count[1]
    k = torch.tensor(key, dtype=torch.int64)
    assert threefry_host.threefry2x32_draw(k.data_ptr(), None, first, 1, tk.KEYS,
                                           out.data_ptr(), 0.0, 1.0, None) == 1
    assert tuple(out[0].tolist()) == want
    assert tuple(tk.plain(k, 1, tk.KEYS, first=first)[0].tolist()) == want


@pytest.mark.parametrize("n", [1, 2, 300, 5000])
@pytest.mark.parametrize("mode", list(MODES))
def test_folded_entry_is_the_split_then_the_draw(threefry_host, mode, n):
    m = MODES[mode]
    key = torch.tensor([0x13198A2E, 0xFFFFFFFF], dtype=torch.int64)
    lo, hi = (-2.5, 3.0) if mode.startswith("uniform") else (0.0, 1.0)
    split = torch.full((2, 2), -1, dtype=torch.int64)
    want = tk.plain(tf.split(key)[1].contiguous(), n, m, lo, hi)
    out = torch.empty_like(want)
    assert threefry_host.threefry2x32_draw(key.data_ptr(), split.data_ptr(), 0, n, m,
                                           out.data_ptr(), lo, hi, None) == 1
    # the split written beside the draws: the next key first, the draw key
    assert torch.equal(split, tf.split(key))
    psplit = torch.empty_like(split)
    assert torch.equal(tk.plain(key, n, m, lo, hi, split=psplit), want)
    assert torch.equal(psplit, split)
    if mode == "normal64":
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-12, atol=1e-15)
    else:
        assert torch.equal(out, want)


@pytest.mark.parametrize("n", [1, 2, 300, 5000])
@pytest.mark.parametrize("mode", list(MODES))
def test_folded_entry_across_a_counter_boundary(threefry_host, mode, n):
    """A folded draw at the counters from ``2**32 - 3``: the launches after
    the first read the draw key that the first wrote, and the entry counts
    every launch."""
    m = MODES[mode]
    key = torch.tensor([0x13198A2E, 0xFFFFFFFF], dtype=torch.int64)
    lo, hi = (-2.5, 3.0) if mode.startswith("uniform") else (0.0, 1.0)
    first = 2 ** 32 - 3
    split = torch.full((2, 2), -1, dtype=torch.int64)
    want = tk.plain(tf.split(key)[1].contiguous(), n, m, lo, hi, first)
    out = torch.empty_like(want)
    assert threefry_host.threefry2x32_draw(key.data_ptr(), split.data_ptr(), first, n, m,
                                           out.data_ptr(), lo, hi, None) == _launches(first, n)
    assert torch.equal(split, tf.split(key))
    if mode == "normal64":
        np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-12, atol=1e-15)
    else:
        assert torch.equal(out, want)


# the source's wide plan at the host's sizes (four counters a thread on the
# resident grid, 3 blocks on the host, but keys and normals), from 1,000
# draws on and from the first; plain and folded draws, the folded ones
# also where a launch crosses a 2**32 boundary of the counters and the
# next reads the draw key the first wrote
VARIANTS = {"wide-plan": ("-DTHREEFRY_WIDE_N=1000",), "all-wide": ("-DTHREEFRY_WIDE_N=1",)}


@pytest.mark.parametrize("first", [0, 2 ** 32 - 3, 2 ** 64 - 2], ids=["0", "2e32", "2e64"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_kernel_source_choices_against_plain(variant, first):
    lib = _host_build(VARIANTS[variant])
    key = torch.tensor([0x13198A2E, 0xFFFFFFFF], dtype=torch.int64)
    for mode, m in MODES.items():
        lo, hi = (-2.5, 3.0) if mode.startswith("uniform") else (0.0, 1.0)
        for n in (3, 1027, 5001):
            want = tk.plain(key, n, m, lo, hi, first)
            out = torch.empty_like(want)
            assert lib.threefry2x32_draw(key.data_ptr(), None, first, n, m, out.data_ptr(), lo,
                                         hi, None) == _launches(first, n)
            split = torch.empty((2, 2), dtype=torch.int64)
            folded = torch.empty_like(want)
            assert lib.threefry2x32_draw(key.data_ptr(), split.data_ptr(), first, n, m,
                                         folded.data_ptr(), lo, hi, None) == _launches(first, n)
            assert torch.equal(split, tf.split(key))
            out = torch.stack([out, folded])
            want = torch.stack([want, tk.plain(split[1].contiguous(), n, m, lo, hi, first)])
            if mode == "normal64":
                np.testing.assert_allclose(out.numpy(), want.numpy(), rtol=1e-12, atol=1e-15)
            else:
                assert torch.equal(out, want), (mode, n)
    for k, count, answer in RANDOM123:
        out = torch.empty((1, 2), dtype=torch.int64)
        assert lib.threefry2x32_draw(torch.tensor(k).data_ptr(), None,
                                     (count[0] << 32) | count[1], 1, tk.KEYS, out.data_ptr(), 0.0,
                                     1.0, None) == 1
        assert tuple(out[0].tolist()) == answer


# cuobjdump's text of two functions: a normal's shape (a short branch for
# |u| >= 1, else erfinv's log and a polynomial) and a loop with a
# branch inside its body
SASS = """
        Function : probe
        /*0000*/                   LDC R1, c[0x0][0x28] ;                 /* 0x000 */
        /*0010*/                   FSETP.GEU.AND P0, PT, |R3|, 1.875, PT ; /* 0x000 */
        /*0020*/              @!P0 BRA 0x50 ;                             /* 0x000 */
        /*0030*/                   DADD R4, R2, R2 ;                      /* 0x000 */
        /*0040*/                   BRA 0x90 ;                             /* 0x000 */
        /*0050*/                   MUFU.RCP64H R5, R3 ;                   /* 0x000 */
        /*0060*/                   DFMA R4, R2, R2, R4 ;                  /* 0x000 */
        /*0070*/                   DFMA R4, R2, R2, R4 ;                  /* 0x000 */
        /*0080*/                   DMUL R4, R4, R4 ;                      /* 0x000 */
        /*0090*/                   DMUL R2, R2, R4 ;                      /* 0x000 */
        /*00a0*/                   STG.E.64 desc[UR8][R4.64], R2 ;        /* 0x000 */
        /*00b0*/                   EXIT ;                                 /* 0x000 */
        /*00c0*/                   BRA 0xc0;                              /* 0x000 */
        Function : loop
        /*0000*/                   MOV R0, RZ ;                           /* 0x000 */
        /*0010*/                   IADD3 R0, R0, 0x1, RZ ;                /* 0x000 */
        /*0020*/               @P0 BRA 0x40 ;                             /* 0x000 */
        /*0030*/                   LOP3.LUT R2, R0, R1, RZ, 0x3c, !PT ;   /* 0x000 */
        /*0040*/                   SHF.L.W.U32.HI R2, R2, 0xd, R2 ;       /* 0x000 */
        /*0050*/               @P1 BRA 0x10 ;                             /* 0x000 */
        /*0060*/                   EXIT ;                                 /* 0x000 */
"""


def test_sass_least_path_counts_the_shortest_run():
    """chip_smoke.py's reading of SASS for the kernels' bounds: the least
    count on a path (forward branches; by way of given instructions; to a
    loop's back edge), and the normals' path by way of erfinv's log."""
    import chip_smoke as cs

    code = cs.parse_sass(SASS)
    probe, loop = code["probe"], code["loop"]
    # a predicated branch and its target
    assert probe[2][1:3] == (True, "BRA") and probe[2][4] == 0x50
    logs = cs.erfinv_logs(probe)
    assert [probe[i][2:4] for i in logs] == [("MUFU", ".RCP64H")]
    assert cs.sass_least(probe, cs.is_fp64) == 2
    assert cs.sass_least(probe, cs.is_fp64, through=logs) == 5
    assert sum(cs.is_fp64(op, m) for _, _, op, m, _ in probe) == 6
    # the loop's body from its back edge's target to the back edge
    assert cs.sass_least(loop, cs.is_alu, 1, 5) == 2
    # the instructions issued, branches aside: the add and the rotate
    assert cs.sass_least(loop, cs.is_issued, 1, 5) == 2


def test_split_key_folds_its_split_into_the_first_draw():
    key = tf.threefry_seed(7)
    sk = tf.SplitKey(key)
    calls = []

    def fn(k, split):
        calls.append(split is not None)
        return tk.plain(k, 5, tk.UNIFORM64, split=split)

    first = sk.fold(5, fn)
    again = sk.fold(5, fn)
    assert calls == [True, False]
    keys = tf.split(key)
    assert torch.equal(first, tk.plain(keys[1], 5, tk.UNIFORM64))
    assert torch.equal(again, first)
    assert torch.equal(sk.next_key(), keys[0]) and torch.equal(tf.as_key(sk), keys[1])
    # an empty draw makes no split; reading the keys then makes it
    empty = tf.SplitKey(key)
    assert tf.uniform(empty, (0,)).numel() == 0 and empty.keys is None
    assert torch.equal(empty.next_key(), keys[0])


@pytest.mark.parametrize("name,params,size", [
    ("normal", (0.0, 1.0), (5,)), ("uniform", (0.0, 2.0), (3, 2)), ("_gamma", (2.0, 1.5), (4,)),
    ("binomial", (10, 0.3), (6,)), ("poisson", (3.0,), (5,)), ("t", (4.0, 0.0, 1.0), (3,)),
    ("multinomial", (10, np.ones(3) / 3), (2,)), ("hypergeometric", (5, 6, 4), (3,)),
    ("integers", (0, 9), (4,)), ("permutation_rv", (np.arange(6.0),), None)])
def test_draw_defers_the_split_to_the_sampler(name, params, size):
    rv = getattr(trand.basic, name)
    key = tf.threefry_seed(11)
    ps = [torch.as_tensor(np.asarray(p)) for p in params]
    shape = None if size is None else size
    next_key, draws = rv.draw(key, shape, ps, rv.dtype if rv.dtype != "floatX" else "float64")
    keys = tf.split(key)
    want = rv.sampler(keys[1], shape, *ps)
    assert torch.equal(next_key, keys[0])
    assert torch.equal(draws.to(want.dtype), want)


def test_draws_take_the_plain_version_on_the_cpu_and_count_no_launch():
    before = tk.LAUNCHES
    tf.normal(tf.threefry_seed(1), (10,))
    assert tk.LAUNCHES == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        tk.launch(tf.threefry_seed(1), 4, tk.BITS32)


# --- tier B -------------------------------------------------------------------------

TIER_B = {
    "gamma": (2.0, 1.5), "beta": (2.0, 3.0), "dirichlet": (np.ones(3),),
    "chisquare": (3.0,), "invgamma": (2.0, 1.0), "gengamma": (2.0, 1.5, 1.0),
    "t": (4.0, 0.0, 1.0), "negative_binomial": (5, 0.4), "poisson": (3.0,),
    "binomial": (10, 0.3), "betabinom": (10, 2.0, 3.0), "multinomial": (10, np.ones(3) / 3),
}


@pytest.mark.parametrize("name", list(TIER_B))
def test_tier_b_builds_and_raises(name):
    """Each loop sampler: the JAX package's static type, and its draws
    (linked, and through ``perform`` at the JAX package's next key)."""
    types, draws = {}, {}
    for pkg, (ptt, pt, ptr, config) in PKGS.items():
        rng = ptr.rng(3, **kw(pkg))
        x = getattr(ptr, name)(*TIER_B[name], size=(2, 3), rng=rng)
        types[pkg] = (x.type.dtype, x.type.shape, type(x.owner.op).__name__)
        draws[pkg] = ptt.function([], [x.owner.outputs[0], x], **kw(pkg))()
    assert types["torch"] == types["jax"]
    for got, want, what in zip(draws["torch"], draws["jax"], ("next key", "draw")):
        held(got, want, f"{name} {what}")
    node = x.owner
    out = [[None], [None]]
    node.op.perform(node, [np.array([0, 3], np.uint32), np.array([2, 3]),
                           *[np.asarray(c.data) for c in node.inputs[2:]]], out)
    jnode = getattr(jrand, name)(*TIER_B[name], size=(2, 3), rng=jrand.rng(3)).owner
    jout = [[None], [None]]
    jnode.op.perform(jnode, [np.array([0, 3], np.uint32), np.array([2, 3]),
                             *[np.asarray(c.data) for c in jnode.inputs[2:]]], jout)
    held(out[0][0], jout[0][0], f"{name} perform's next key")
    held(out[1][0], jout[1][0], f"{name} perform's draw")


# --- the lifts ------------------------------------------------------------------------


def _ops(var):
    fg = (jptt if "pytensor_tpu_torch" not in type(var).__module__ else tptt).FunctionGraph(
        outputs=[var], clone=True)
    return [type(n.op).__name__ for n in fg.toposort()]


LIFTS = {
    "size_scalar_params": lambda pt, ptr, rng: ptr.normal(0.0, 1.0, size=(3, 2), rng=rng),
    "size_vector_param": lambda pt, ptr, rng: ptr.normal(
        pt.as_tensor_variable(np.array([0.0, 1.0, 2.0])), 1.0, size=(4, 3), rng=rng),
    "dimshuffle_transpose": lambda pt, ptr, rng: ptr.normal(
        pt.as_tensor_variable(np.array([0.0, 5.0, 10.0])), 1.0, size=(2, 3), rng=rng).T,
    "subtensor_int": lambda pt, ptr, rng: ptr.normal(
        pt.as_tensor_variable(np.arange(4.0)), 1.0, rng=rng)[2],
    "subtensor_slice": lambda pt, ptr, rng: ptr.normal(
        pt.as_tensor_variable(np.arange(5.0)), 0.5, rng=rng)[1:4],
    "mvnormal_size": lambda pt, ptr, rng: ptr.multivariate_normal(
        pt.as_tensor_variable(np.zeros(3)), pt.as_tensor_variable(SPD), size=(5,), rng=rng),
}


@pytest.mark.parametrize("case", list(LIFTS))
def test_lift_gives_the_jax_packages_graph(case):
    out = {}
    for pkg, (ptt, pt, ptr, config) in PKGS.items():
        rng = ptr.rng(42, **kw(pkg))
        expr = LIFTS[case](pt, ptr, rng)
        rewrite = jrewrite if pkg == "jax" else trewrite
        lifted = rewrite(expr, include=("random_lift",))
        assert type(lifted.owner.op).__name__ == type(expr.owner.op).__name__ or any(
            "RV" in type(n.op).__name__ for n in [lifted.owner])
        f = ptt.function([], lifted, **kw(pkg))
        out[pkg] = (_ops(lifted), f(), lifted.type.shape)
    assert out["torch"][0] == out["jax"][0]
    assert out["torch"][2] == out["jax"][2]
    held(out["torch"][1], out["jax"][1], case)


def test_lifts_are_not_in_fast_run_and_keep_a_shared_draw():
    for pkg, (ptt, pt, ptr, config) in PKGS.items():
        rng = ptr.rng(1, **kw(pkg))
        rv = ptr.normal(pt.as_tensor_variable(np.arange(4.0)), 1.0, rng=rng)
        rewrite = jrewrite if pkg == "jax" else trewrite
        # the draw feeds another reader too: not lifted
        both = rewrite([rv[0], rv.sum()], include=("random_lift",))
        assert type(both[0].owner.op).__name__ == "Subtensor"
        # canonicalize's own name does not select them
        out = rewrite(rv[0], include=("canonicalize",))
        assert type(out.owner.op).__name__ != "NormalRV"


# --- default updates, shared keys -----------------------------------------------------


def test_default_updates_advance_the_key_and_no_default_updates_stops_it():
    keys = {}
    for pkg, (ptt, pt, ptr, config) in PKGS.items():
        srng = ptr.RandomStream(7, **kw(pkg))
        x = srng.uniform(0.0, 1.0, size=(3,))
        f = ptt.function([], x, **kw(pkg))
        a, b = as_np(f()), as_np(f())
        assert not np.array_equal(a, b)
        k = as_np(x.rng.get_value()).copy()
        g = ptt.function([], x, no_default_updates=True, **kw(pkg))
        c, d = as_np(g()), as_np(g())
        np.testing.assert_array_equal(c, d)
        np.testing.assert_array_equal(as_np(x.rng.get_value()), k)
        keys[pkg] = (a, b, c, k)
    for w, g in zip(keys["jax"], keys["torch"]):
        held(g, w)


def test_shared_keys_from_a_generator_and_from_the_jax_packages_key():
    j = jptt.shared(np.random.default_rng(5))
    t = tptt.shared(np.random.default_rng(5), device="cpu")
    assert type(t).__name__ == "RandomGeneratorSharedVariable"
    np.testing.assert_array_equal(as_np(t.get_value()), np.asarray(j.get_value()))
    j.set_value(np.array([123, 456], dtype=np.uint32))
    t.set_value(j.get_value())
    np.testing.assert_array_equal(as_np(t.get_value()), np.array([123, 456], np.uint32))
    draws = {}
    for pkg, rng in (("jax", j), ("torch", t)):
        ptt, pt, ptr, config = PKGS[pkg]
        x = ptr.normal(0.0, 1.0, size=(4,), rng=rng)
        draws[pkg] = ptt.function([], x, updates={rng: x.owner.outputs[0]}, **kw(pkg))()
    held(draws["torch"], draws["jax"])


def test_a_plan_of_draws_reads_nothing_back_but_hypergeometric():
    srng = trand.RandomStream(2, device="cpu")
    f = tptt.function([], [srng.normal(0.0, 1.0, size=(3,)), srng.uniform(size=(2,))],
                      device="cpu")
    assert f.linked.host_reads == []
    g = tptt.function([], srng.hypergeometric(5, 4, 3, size=(2,)), device="cpu")
    assert any("hypergeometric" in r for r in g.linked.host_reads)


# --- RNG states in scan -----------------------------------------------------------------


def _random_walk(pkg):
    ptt, pt, ptr, config = PKGS[pkg]
    srng = ptr.RandomStream(5, **kw(pkg))
    mu = pt.dscalar("mu")
    x0 = pt.dvector("x0")

    def step(x, mu):
        return x + mu * x ** 2 + pt.cast(srng.normal(0.0, 1.0, size=(3,)), "float64")

    xs, upd = ptt.scan(step, outputs_info=[x0], non_sequences=[mu], n_steps=5)
    g = ptt.grad(pt.sum(xs[-1] ** 2), mu)
    return ptt.function([mu, x0], [xs, g], updates=upd, **kw(pkg)), xs


def test_random_walk_in_scan_and_its_gradient():
    fns = {pkg: _random_walk(pkg) for pkg in PKGS}
    x0 = np.array([0.1, -0.2, 0.05])
    for _ in range(2):
        want = fns["jax"][0](0.05, x0)
        got = fns["torch"][0](0.05, x0)
        np.testing.assert_allclose(as_np(got[0]), np.asarray(want[0]), rtol=1e-12, atol=1e-14)
        np.testing.assert_allclose(float(got[1]), float(want[1]), rtol=1e-10)


def test_k2_takes_no_scan_with_a_random_variable():
    from pytensor_tpu.link.pallas.scan_pallas import pallas_scan_eligible
    from pytensor_tpu_torch.link.cuda.scan_kernel import scan_kernel_eligible

    for pkg, eligible in (("jax", pallas_scan_eligible), ("torch", scan_kernel_eligible)):
        _, xs = _random_walk(pkg)
        node = xs.owner
        assert type(node.op).__name__ == "Scan"
        assert node.op.info.n_untraced == 1
        assert not eligible(node.op, node)


@pytest.mark.parametrize("case", ["permutation", "choice"])
def test_a_sampler_reads_its_int_parameter_on_the_host(case):
    """``permutation(n)`` and ``choice(n)`` read ``n`` as a Python int: the
    lowering declares that parameter a host port, so a constant stays on
    the host and a plan of it may be captured; the draws are the JAX
    package's."""
    from pytensor_tpu_torch.link.torch.dispatch import ports_of

    out = {}
    for pkg, (ptt, pt, ptr, config) in PKGS.items():
        rng = ptr.rng(3, **kw(pkg))
        x = ptr.permutation(7, rng=rng) if case == "permutation" else ptr.choice(
            7, size=(4,), rng=rng)
        f = ptt.function([], x, **kw(pkg))
        out[pkg] = f()
        if pkg == "torch":
            assert f.linked.host_reads == []
            assert ports_of(x.owner, "host") == {1, 2}
    held(out["torch"], out["jax"], case)

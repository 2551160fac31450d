"""The port's kernels on an NVIDIA GPU: K1, K2, K3 and K4 against their
plain versions, the linked radon function against the float64 closed
form, and the sparse graphs against float64 scipy.

Every test here is marked ``cuda`` and skips without a card.  The file
imports only the port (no JAX), so on the machine with the card it runs
without the JAX test configuration:

    python -m pytest --noconftest tests/test_torch_cuda.py

Tolerances are chip_smoke.py's: K1 ``1e-5`` (float32) and ``1e-12``
(float64) of ``max(1, max|plain|)``; K3 after 64 float32 steps ``1e-4``
of ``max(1, max|plain|)``; the linked float32 graph ``rtol 1e-4`` with
``atol 1e-4 * max|dlogp|`` against float64; K2 on the ported scan cases
``1e-6`` of ``max(1, max|loop|)`` against the step loop, its one-hot
products bit for bit against the step loop, and the radon chain after 32
steps at K3's tolerances against K3; K4 per row within
``4 * D2 * 2**-24 * sum_j |a_ij x_j|``, and the sparse graphs as
``tests/test_torch_sparse.py`` holds them.  Captured functions (one CUDA
graph per input signature) are held bit for bit against the same graph
linked eagerly where no kernel adds by atomics, else to ``1e-5`` of
``max(1, max|eager|)``.  K1 on every scalar op of the expression table in
each dtype: the exact ops with the plain version's bits, the others at
K1's tolerances; K2 on scans of its new ops at ``1e-6``; the logreg and
MFU steps at small widths captured, with the eager plan's bits.  The
Elman BPTT step and its loop at small widths captured, with the eager
plan's bits and the CPU's values at ``1e-5`` of ``max(1, max|cpu|)``; a
``Blockwise{Dot}`` and a looped ``Blockwise`` against the CPU at the
same; a static BPTT under ``scan__pallas`` launching K2 once, for its
forward scan, within ``1e-5`` of the step loop.  The GP step and its loop
and the Kalman log-likelihood and gradient at small widths captured, with
the eager plan's bits and the CPU's values at ``1e-5``; a
``Blockwise{Cholesky}`` of 16 matrices as one ``cholesky_ex`` call, within
``1e-12`` of the CPU (float64), with the NaN and lower-triangle contracts.
The special functions (``link/cuda/special.py``): each as a one-node K1
launch in float32 and float64 on its grid and numpy's edges against its
plain version on the card (``2e-5`` and ``5e-9`` of ``max(1, |plain|)``,
NaN and infinities where the plain version has them), the special op
group a dtype fused, an Elemwise of one on the card never running its
plain version, a failed K1 build raising, and the bessel loop through K2
under ``scan__pallas`` (one launch) and as the step loop (K1 twice a
step), each within ``2e-6`` of the float64 scipy loop.  bfloat16: a
linked product with cuBLAS's reduced-precision reductions off, captured
and replayed whatever the caller's setting, which each call restores; K1
on every op of its table in bfloat16 (the exact ops bit for bit, the
others within 1 ulp); K2 on a bfloat16 EWMA bit for bit its step loop.
complex64 and complex128: K1 on every complex op (``cases.COMPLEX_OPS``)
as a one-node launch against its plain version on the card
(``cases.complex_held``: exact ops bit for bit, the others within 8
epsilons of the modulus) and numpy complex128 (``cases.complex_near``),
and the periodogram's one K1 launch (its ``abs``-``sqr`` group of the
complex spectrum) and its whole chain as one kernel.  ``tensor/optimize.py``:
the logistic-regression MAP at n 512, d 16 in float64, BFGS with its
evaluations replayed (K1 launches at each) and Newton captured whole,
against the same functions linked for the CPU at ``1e-10``.  Random:
the threefry kernel in each mode against its plain version on the card
(bit for bit; the normals within ``1e-11``) and jax's Random123 answers,
its folded draw (the split made in the same launch) against the split
followed by the plain draw, at an HMC step's sizes and at 2**20 + 3, and
a draw whose counters cross 2**32; the three HMC transitions of
``models/hmc.py`` at small widths, each one captured CUDA graph launching
K1 and threefry (twice a transition), against the CPU at ``2e-4`` with the
same accepts or indices.  jax's loop samplers: each of
the twelve on its edge grid in both float dtypes through the gamma,
Poisson or binomial kernel, bit for bit the same draw on the plain loops
on the card; the RBM Gibbs chain at small widths, one captured CUDA graph
launching the binomial kernel, with the CPU's draws where its products
are exact on both devices.  The control and debug ops (the radon model
at 50/6, float64): the asserts' deferred flags in a captured function
(the unguarded function's bits, a failing data assert raising after a
replay, the flags zeroed for the next call), the lazy ``IfElse``
launching K1 as the unguarded function does at a finite theta (and the
two conditions' own fused nodes) and only its condition's node at a NaN
theta, ``DebugMode`` holding each K1 node against its plain
version on the CPU (once a node), and ``HasInnerFunction.fn`` on the card
by default.
"""

import numpy as np
import pytest
import torch

from pytensor_tpu_torch.compile.mode import FAST_RUN
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.link.cuda import cases
from pytensor_tpu_torch.link.torch.convert import as_torch
from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch
from pytensor_tpu_torch.models import radon_kernel
from pytensor_tpu_torch.models.radon import (
    make_radon_graphs,
    make_radon_logp_batched,
    radon_logp_dlogp_reference,
    theta_start,
)
from pytensor_tpu_torch.tensor import fused_kernel
from pytensor_tpu_torch.tensor.fused import FusedElemwise

pytestmark = pytest.mark.cuda
K1_RTOL = {"float32": 1e-5, "float64": 1e-12}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the kernels are CUDA")
    return torch.device("cuda", torch.cuda.current_device())


def _scaled(a, b):
    return float((a - b).abs().max()) / max(1.0, float(b.abs().max()))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_k1_matches_plain(card, dtype, batched):
    if batched:
        theta, logp, dlogp, n = make_radon_logp_batched(dtype=dtype)
        inputs, outputs = [theta], [logp, dlogp]
        start = np.tile(theta_start(n, dtype), (64, 1))
    else:
        inputs, outputs, n = make_radon_graphs(dtype=dtype)
        start = theta_start(n, dtype)
    fg = FunctionGraph(inputs, outputs, clone=True)
    FAST_RUN.optimizer.rewrite(fg)
    nodes = [nd for nd in fg.toposort() if isinstance(nd.op, FusedElemwise)]
    needed = [i for nd in nodes for i in nd.inputs]
    values = iter(fgraph_to_torch(FunctionGraph(fg.inputs, needed, clone=False), card)(
        as_torch(start, card)))
    for nd in nodes:
        args = [next(values) for _ in nd.inputs]
        kern = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, card)
        for got, want in zip(kern.launch(*args), kern.plain(*args)):
            assert got.dtype == want.dtype and got.shape == want.shape
            assert _scaled(got, want) <= K1_RTOL[dtype], str(nd.op)


def _k1_layout_case(case, dtype, card):
    """x, y for one of K1's layout classes (as tests/test_torch_fused.py
    runs them on the host); x holds a NaN and a -0.0."""
    rng = np.random.default_rng(11)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(dtype)).to(card)

    x = t(*{"tail": (1001,), "misaligned": (1001,)}.get(case, (5, 7)))
    x.view(-1)[:2] = torch.tensor([float("nan"), -0.0])
    if case == "transposed":
        x = x.T.contiguous().T
    elif case == "misaligned":
        x = torch.cat([t(1), x])[1:]
    y = {"row": t(7), "column": t(5, 1), "0d": t(), "transposed": t(5, 7), "tail": t(1001),
         "misaligned": t(1001)}[case]
    return x, y


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["row", "column", "0d", "transposed", "tail", "misaligned"])
def test_k1_layout_classes_match_plain(card, case, dtype):
    """K1 launched on each layout class (strided broadcasts, a 0-d input, a
    column-major input, 16-byte vectors with a tail, a misaligned pointer)
    against its plain version: NaN where plain has NaN, +0.0 for abs(-0.0)."""
    import pytensor_tpu_torch.tensor as pt

    x, y = _k1_layout_case(case, dtype, card)
    tx = pt.tensor("x", dtype=dtype, shape=(None,) * x.ndim)
    ty = pt.tensor("y", dtype=dtype, shape=(None,) * y.ndim)
    outs = [tx * ty - pt.exp(-ty) + 0.1, pt.maximum(tx, ty), pt.abs(tx), ty * 2.0]
    kern = fused_kernel.FusedElemwiseKernel(FusedElemwise([tx, ty], outs).fgraph, card)
    before = fused_kernel.LAUNCHES
    got = kern(x, y)
    torch.cuda.synchronize()
    assert fused_kernel.LAUNCHES == before + 1
    for g, w in zip(got, kern.plain(x, y)):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.isnan(), w.isnan())
        g, w = g[~w.isnan()], w[~w.isnan()]
        assert _scaled(g.double(), w.double()) <= K1_RTOL[dtype]
        assert torch.equal(torch.signbit(g[w == 0]), torch.signbit(w[w == 0]))


def test_k3_matches_plain(card):
    fn, th0, m0, n = radon_kernel.make_radon_leapfrog_kernel(n_steps=64, device=card)
    th, m = as_torch(th0, card), as_torch(m0, card)
    before = radon_kernel.LAUNCHES
    got = fn(th, m)
    assert radon_kernel.LAUNCHES == before + 1
    want = radon_kernel.leapfrog_plain(th, m, fn.data, 64, 1e-3)
    for g, w in zip(got, want):
        assert _scaled(g, w) <= 1e-4


def test_k3_chains_match_single_chain_launches(card):
    """One block per chain, and a fixed summation order: a batch of chains
    gives each chain's single launch bit for bit."""
    fn, th0, m0, n = radon_kernel.make_radon_leapfrog_kernel(n_steps=16, device=card)
    rng = np.random.default_rng(3)
    th = as_torch((th0 + 0.1 * rng.standard_normal((4, n))).astype("float32"), card)
    m = as_torch(rng.standard_normal((4, n)).astype("float32"), card)
    batch = fn(th, m)
    for k in range(4):
        for b, s in zip(batch, fn(th[k].contiguous(), m[k].contiguous())):
            assert torch.equal(b[k], s)


def test_k3_with_two_counties_a_thread_matches_plain(card):
    """300 counties: a block of 256 threads, threads 0-43 own two counties
    and walk them from shared memory."""
    fn, th0, m0, n = radon_kernel.make_radon_leapfrog_kernel(
        n_steps=64, n_obs=2400, n_counties=300, device=card)
    th, m = as_torch(th0, card), as_torch(m0, card)
    got = fn(th, m)
    want = radon_kernel.leapfrog_plain(th, m, fn.data, 64, 1e-3)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all()) and _scaled(g, w) <= 1e-4


def test_k3_relaunch_is_bit_identical(card):
    fn, th0, m0, n = radon_kernel.make_radon_leapfrog_kernel(n_steps=256, device=card)
    th, m = as_torch(th0, card), as_torch(m0, card)
    first, again = fn(th, m), fn(th, m)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_linked_entry_matches_closed_form(card):
    from pytensor_tpu_torch.entry import entry

    fn, (theta0,) = entry("cuda")
    rng = np.random.default_rng(1)
    theta = (theta_start(theta0.shape[0], "float32")
             + 0.1 * rng.standard_normal(theta0.shape[0])).astype("float32")
    before = fused_kernel.LAUNCHES
    prev_tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        lp, g = fn(as_torch(theta, card))
        # the call ran its matmuls in full float32 and left the caller's setting
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev_tf32
    assert fused_kernel.LAUNCHES > before
    rlp, rg = radon_logp_dlogp_reference(theta.astype("float64"))
    np.testing.assert_allclose(lp.cpu().numpy(), rlp, rtol=1e-4)
    np.testing.assert_allclose(g.cpu().numpy(), rg, rtol=1e-4, atol=1e-4 * np.max(np.abs(rg)))
    with pytest.raises(ValueError, match="cpu"):
        fn(torch.from_numpy(theta))  # a CUDA-linked function takes CUDA tensors


def _scan_cases():
    """(inputs, a function that builds the outputs, input values) of the
    ported scan cases."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt

    rng = np.random.default_rng(0)
    z = pt.tensor("z", dtype="float32", shape=())
    v4 = pt.tensor("v4", dtype="float32", shape=(4,))
    v5 = pt.tensor("v5", dtype="float32", shape=(5,))
    W = pt.as_tensor_variable((np.eye(5) * 0.9 + 0.01).astype("float32"))
    x = pt.tensor("x", dtype="float32", shape=(4,))
    m = pt.tensor("m", dtype="float32", shape=(6, 40))
    return {
        "abs_max": ([m], lambda: ptt.scan(
            lambda a: a / (pt.max(pt.abs(a)) + np.float32(1e-9)) * np.float32(1.5)
            + pt.max(pt.abs(a), axis=1).dimshuffle(0, "x") * np.float32(0.01)
            - pt.max(a, axis=0).dimshuffle("x", 0) * np.float32(0.01),
            outputs_info=[m], n_steps=4)[0],
            [np.random.default_rng(2).standard_normal((6, 40)).astype("float32")]),
        "scalar_carry": ([z], lambda: ptt.scan(
            lambda acc: acc * np.float32(1.1) + np.float32(0.5), outputs_info=[z],
            n_steps=6)[0], [np.float32(1.0)]),
        "vector_state_and_nitsot": ([v4], lambda: list(ptt.scan(
            lambda acc: (acc + np.float32(1.0), (acc ** 2).sum()),
            outputs_info=[v4, None], n_steps=3)[0]), [np.zeros(4, "float32")]),
        "tanh_dot": ([v5], lambda: ptt.scan(
            lambda acc: pt.tanh(pt.dot(W, acc)) + np.float32(0.01), outputs_info=[v5],
            n_steps=10)[0], [rng.standard_normal(5).astype("float32")]),
        "sequences": ([x], lambda: ptt.scan(
            lambda xt, acc: acc + xt, sequences=[x],
            outputs_info=[pt.constant(np.float32(0.0))])[0], [np.ones(4, "float32")]),
    }


@pytest.mark.parametrize("case", ["abs_max", "scalar_carry", "vector_state_and_nitsot",
                                  "tanh_dot", "sequences"])
def test_k2_matches_plain_loop(card, case):
    """Each ported scan case through function() on the card: one K2 launch,
    held against the same scan linked without ``scan__pallas`` (the step
    loop), to 1e-6 of max(1, max|loop|): both run float32 in other orders."""
    import pytensor_tpu_torch as ptt
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda import scan_kernel

    ins, build, vals = _scan_cases()[case]
    outs = {}
    for pallas in (False, True):
        with config.change_flags(scan__pallas=pallas):
            f = ptt.function(ins, build(), device=card)
        before = scan_kernel.LAUNCHES
        res = f(*[as_torch(v, card) for v in vals])
        torch.cuda.synchronize()
        assert scan_kernel.LAUNCHES == before + pallas
        outs[pallas] = res if isinstance(res, list) else [res]
    for got, want in zip(outs[True], outs[False]):
        assert got.shape == want.shape and got.dtype == want.dtype
        assert _scaled(got, want) <= 1e-6, case


def test_k2_leapfrog_chain_matches_k3(card):
    """The radon chain through scan + function() at full width, 32 steps: one
    K2 launch, held against K3 from the same start at chip_smoke's K2
    tolerance of max(1, max|K3|)."""
    from pytensor_tpu_torch.link.cuda import scan_kernel
    from pytensor_tpu_torch.models.radon import make_leapfrog_chain

    chain = make_leapfrog_chain(n_steps=32, device=card)
    fn3, th0, m0, _ = radon_kernel.make_radon_leapfrog_kernel(n_steps=32, device=card)
    th, m = as_torch(th0, card), as_torch(m0, card)
    before = scan_kernel.LAUNCHES
    got = chain(th, m)
    assert scan_kernel.LAUNCHES == before + 1
    for g, w, tol in zip(got, fn3(th, m), (3e-4, 3e-3, 5e-4)):
        assert _scaled(g, w) <= tol


@pytest.mark.parametrize("kind", ["finite", "negzero", "inf"])
@pytest.mark.parametrize("direction", ["gather", "segsum"])
def test_k2_onehot_dot_matches_loop(card, direction, kind):
    """A Dot against a one-hot (919, 85) constant, as the radon body holds
    them, through function() on the card: one K2 launch with its arena and
    constants in shared memory, the one-hot matrix out of the constants,
    and the step loop's bits (small integers sum exactly in any order;
    a -0.0 gives +0.0; an inf gives NaN where it meets a 0)."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda import scan_kernel

    rng = np.random.default_rng(5)
    C = np.zeros((919, 85), dtype="float32")
    C[np.arange(919), rng.integers(0, 85, size=919)] = 1.0
    n = 85 if direction == "gather" else 919
    v = rng.integers(-8, 9, size=n).astype("float32")
    if kind == "negzero":
        v[3] = -0.0
    elif kind == "inf":
        v[2] = np.inf
    v0 = pt.tensor("v0", dtype="float32", shape=(n,))
    Cv = pt.as_tensor_variable(C)

    def dot(x):
        return pt.dot(Cv, x) if direction == "gather" else pt.dot(x[None, :], Cv)

    outs = {}
    for pallas in (False, True):
        with config.change_flags(scan__pallas=pallas):
            (tr, y), _ = ptt.scan(lambda x: (x * np.float32(0.5), dot(x)),
                                  outputs_info=[v0, None], n_steps=3)
            f = ptt.function([v0], [tr, y], device=card)
        before = scan_kernel.LAUNCHES
        outs[pallas] = f(as_torch(v, card))
        torch.cuda.synchronize()
        assert scan_kernel.LAUNCHES == before + pallas
    (node,) = [nd for nd in f.fgraph.apply_nodes if type(nd.op).__name__ == "Scan"]
    src = scan_kernel.ScanKernelSource(node.op, node)
    assert src.placement == "shared" and len(src.const_bytes) < C.nbytes
    for g, w in zip(outs[True], outs[False]):
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(torch.nan_to_num(g, nan=7.0), torch.nan_to_num(w, nan=7.0))
        assert torch.equal(torch.signbit(g[~g.isnan()]), torch.signbit(w[~w.isnan()]))


def test_k2_is_deterministic_and_refuses_more_shared_memory_than_the_card_has(card):
    """Two launches of the radon body give the same bits; a source whose
    launch asks for more dynamic shared memory than a block may use comes
    back as a CUDA error, raised by the wrapper."""
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.cuda import scan_kernel
    from pytensor_tpu_torch.models.radon import make_leapfrog_chain

    chain = make_leapfrog_chain(n_steps=16, device=card)
    (node,) = [nd for nd in chain.fgraph.apply_nodes if type(nd.op).__name__ == "Scan"]
    feed = fgraph_to_torch(FunctionGraph(chain.fgraph.inputs, node.inputs, clone=False), card)
    fn3, th0, m0, _ = radon_kernel.make_radon_leapfrog_kernel(n_steps=16, device=card)
    n_steps, *outer = feed(as_torch(th0, card), as_torch(m0, card))
    k2 = scan_kernel.ScanKernel(node.op, node, card)
    assert k2.src.placement == "shared"
    first, again = k2.launch(n_steps.cpu(), *outer), k2.launch(n_steps.cpu(), *outer)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, again))
    k2._lib = None
    k2.source = k2.source.replace(f"#define K2_SMEM {k2.src.smem_bytes}",
                                  f"#define K2_SMEM {scan_kernel.SMEM_LIMIT + 16}")
    with pytest.raises(RuntimeError, match="CUDA error"):
        k2.launch(n_steps.cpu(), *outer)


def _sparse(n, density, seed):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    return sp.random(n, n, density=density, format="csr", random_state=rng, dtype="float32"), rng


def test_k4_matches_plain_and_is_deterministic(card):
    """K4 at every lane count against its plain version, per row within
    4 * D2 * 2**-24 * sum_j |a_ij x_j| (float32 sums of at most D2 terms
    in two orders), and bit for bit against itself."""
    from pytensor_tpu_torch.link.cuda import spmv_kernel
    from pytensor_tpu_torch.link.torch.convert import sparse_as_torch

    A, rng = _sparse(5000, 0.002, 7)
    A = A.tolil()
    A[3, :] = 0          # an empty row
    A[4, :300] = 1.0     # a row longer than every lane group
    A = A.tocsr()
    c = sparse_as_torch(A, card)
    xv = rng.standard_normal(5000).astype("float32")
    x = as_torch(xv, card)
    bound = 4 * np.diff(A.indptr).max() * 2.0 ** -24 * (abs(A) @ np.abs(xv.astype("float64")))
    want = spmv_kernel.plain(c.indptr, c.indices, c.data, x).cpu().numpy()
    for G in (1, 2, 4, 8, 16, 32):
        before = spmv_kernel.LAUNCHES
        got = spmv_kernel.launch(c.indptr, c.indices, c.data, x, G)
        again = spmv_kernel.launch(c.indptr, c.indices, c.data, x, G)
        torch.cuda.synchronize()
        assert spmv_kernel.LAUNCHES == before + 2
        assert torch.equal(got, again)
        assert np.all(np.abs(got.cpu().numpy() - want) <= bound), G
        assert float(got[3]) == 0.0


def _lane_order(c, xv, G):
    """y = A x in K4's lane order (``csrc/spmv_csr.cu``'s note), on the CPU:
    G lane sums by libm's fmaf (one rounding, as the card's), then the
    tree in float32."""
    import ctypes
    import ctypes.util

    fmaf = ctypes.CDLL(ctypes.util.find_library("m")).fmaf
    fmaf.argtypes = [ctypes.c_float] * 3
    fmaf.restype = ctypes.c_float
    indptr, indices = c.indptr.cpu().numpy(), c.indices.cpu().numpy()
    data = c.data.cpu().numpy()
    y = np.empty(len(indptr) - 1, dtype="float32")
    for r in range(len(y)):
        acc = [0.0] * G
        for lane in range(G):
            for k in range(indptr[r] + lane, indptr[r + 1], G):
                acc[lane] = fmaf(data[k], xv[indices[k]], acc[lane])
        acc = [np.float32(a) for a in acc]
        o = G // 2
        while o:
            for lane in range(o):
                acc[lane] = acc[lane] + acc[lane + o]
            o //= 2
        y[r] = acc[0]
    return y


@pytest.mark.parametrize("case", ["random", "rows_of_128"])
def test_k4_gives_the_lane_order_bit_for_bit(card, case):
    """K4 against its lane order computed on the CPU, bit for bit: a small
    random CSR (8 lanes a row), and 16 rows of 128 nonzeros (32 lanes a
    row, two pairs and no single a lane)."""
    import scipy.sparse as sp

    from pytensor_tpu_torch.link.cuda import spmv_kernel
    from pytensor_tpu_torch.link.torch.convert import sparse_as_torch

    if case == "random":
        A, rng = _sparse(3000, 0.003, 11)
    else:
        rng = np.random.default_rng(12)
        cols = np.concatenate([rng.choice(400, 128, replace=False) for _ in range(16)])
        A = sp.csr_matrix((rng.standard_normal(16 * 128).astype("float32"), cols,
                           np.arange(0, 16 * 128 + 1, 128)), shape=(16, 400))
    c = sparse_as_torch(A, card)
    xv = rng.standard_normal(A.shape[1]).astype("float32")
    got = spmv_kernel.launch(c.indptr, c.indices, c.data, as_torch(xv, card))
    torch.cuda.synchronize()
    want = _lane_order(c, xv, spmv_kernel.group_size(A.shape[0], A.nnz))
    assert np.array_equal(got.cpu().numpy().view("int32"), want.view("int32"))


def test_k4_refuses_what_it_does_not_take(card):
    from pytensor_tpu_torch.link.cuda import spmv_kernel
    from pytensor_tpu_torch.link.torch.convert import sparse_as_torch

    A, _ = _sparse(300, 0.05, 8)
    c = sparse_as_torch(A, card)
    x = torch.ones(300, device=card)
    with pytest.raises(RuntimeError, match="CUDA error"):
        spmv_kernel.launch(c.indptr, c.indices, c.data, x, G=3)
    with pytest.raises(ValueError):
        spmv_kernel.launch(c.indptr, c.indices.long(), c.data, x)
    with pytest.raises(ValueError):
        spmv_kernel.launch(c.indptr, c.indices, c.data, x.double())
    with pytest.raises(ValueError):
        spmv_kernel.launch(c.indptr.cpu(), c.indices, c.data, x)


def test_routed_graph_and_train_loop_launch_k4(card):
    """The gradient graph launches K4 twice (A and its transpose), a
    3-step train_loop three times; both against float64 scipy."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.link.cuda import spmv_kernel
    from pytensor_tpu_torch.sparse import as_sparse_variable, structured_dot

    A, rng = _sparse(1500, 0.005, 9)
    x = pt.tensor("x", dtype="float32", shape=(1500,))
    y = structured_dot(as_sparse_variable(A), x)
    cost = pt.sum(y * y)
    f = ptt.function([x], [cost, ptt.grad(cost, x)], device=card)
    xv = rng.standard_normal(1500).astype("float32")
    before = spmv_kernel.LAUNCHES
    c, g = f(as_torch(xv, card))
    torch.cuda.synchronize()
    assert spmv_kernel.LAUNCHES == before + 2
    y64 = A.astype("float64") @ xv.astype("float64")
    np.testing.assert_allclose(float(c), (y64 ** 2).sum(), rtol=1e-4)
    g64 = 2 * (A.T.astype("float64") @ y64)
    np.testing.assert_allclose(g.cpu().numpy(), g64, rtol=1e-4, atol=1e-4 * np.abs(g64).max())

    x0 = rng.standard_normal((1500, 1)).astype("float32")
    xsh = ptt.shared(x0, name="x", device=card)
    y = structured_dot(as_sparse_variable(A), xsh)
    loop = ptt.train_loop([], pt.sum(y), {xsh: y / (pt.max(pt.abs(y)) + 1e-9)}, n_steps=3,
                          device=card)
    before = spmv_kernel.LAUNCHES
    out = loop()
    torch.cuda.synchronize()
    assert spmv_kernel.LAUNCHES == before + 3
    v = x0.astype("float64")
    for _ in range(3):
        yv = A @ v
        v = yv / (np.abs(yv).max() + 1e-9)
    np.testing.assert_allclose(float(out), yv.sum(), rtol=2e-4)
    np.testing.assert_allclose(xsh.get_value().cpu().numpy(), v, atol=2e-5)


# --- whole-function capture (link/torch/linker.py CapturedFunction) ---------------

def _entry_pair():
    """The float32 ``entry`` function captured, and the same linked eagerly
    (``xla__jit`` off)."""
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.entry import entry

    fn, (theta0,) = entry("cuda")
    with config.change_flags(xla__jit=False):
        eager, _ = entry("cuda")
    return fn, eager, theta0.shape[0]


def _theta(n, seed, chains=None):
    rng = np.random.default_rng(seed)
    th = theta_start(n, "float32")
    if chains is not None:
        th = np.tile(th, (chains, 1))
    return (th + 0.1 * rng.standard_normal(th.shape)).astype("float32")


def test_entry_replay_gives_the_eager_plans_bits(card):
    """The float32 entry function has no atomics: the warm-up call and two
    replays give the eager plan's bits."""
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction, Plan

    fn, eager, n = _entry_pair()
    assert isinstance(fn, CapturedFunction) and isinstance(eager, Plan)
    theta = as_torch(_theta(n, 1), card)
    want = eager(theta)
    for _ in range(3):
        got = fn(theta)
        torch.cuda.synchronize()
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert len(fn.graphs) == 1


def test_an_output_is_unchanged_by_later_calls(card):
    fn, _, n = _entry_pair()
    first = fn(as_torch(_theta(n, 1), card))
    replayed = fn(as_torch(_theta(n, 2), card))
    kept = [t.clone() for t in first + replayed]
    fn(as_torch(_theta(n, 3), card))
    fn(as_torch(_theta(n, 4), card))
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first + replayed, kept))
    assert not torch.equal(first[1], replayed[1])


def test_a_new_input_shape_is_a_new_capture(card):
    """The batched graph at 8 chains, then 16, then 8 again: two captures,
    each call the eager values (the float32 gradient adds by atomics, so to
    1e-5 of max(1, max|eager|), not bit for bit)."""
    from pytensor_tpu_torch.compile.mode import FAST_RUN
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.torch.linker import TorchLinker

    theta, logp, dlogp, n = make_radon_logp_batched(dtype="float32")
    fg = FunctionGraph([theta], [logp, dlogp], clone=True)
    FAST_RUN.optimizer.rewrite(fg)
    fn = TorchLinker.make_torch_fn(fg, card)
    with config.change_flags(xla__jit=False):
        eager = TorchLinker.make_torch_fn(fg, card)
    for k, chains in enumerate((8, 16, 8, 16)):
        th = as_torch(_theta(n, 5 + k, chains), card)
        for got, want in zip(fn(th), eager(th)):
            assert got.shape == want.shape == (chains,) + want.shape[1:]
            assert _scaled(got, want) <= 1e-5
    assert sorted(key[0][0][0] for key in fn.graphs) == [8, 16]


def _shared_function(card, jit):
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.config import config

    rng = np.random.default_rng(6)
    w = ptt.shared(rng.standard_normal(7).astype("float32"), name="w", device=card)
    a = ptt.shared(np.arange(3, dtype="float32"), name="a", device=card)
    b = ptt.shared(np.ones(3, dtype="float32"), name="b", device=card)
    x = pt.tensor("x", dtype="float32", shape=(7,))
    with config.change_flags(xla__jit=jit):
        f = ptt.function([x], [(w * x).sum(), a], updates={w: w * 0.5 + x, a: b, b: a},
                         device=card)
    return f, (w, a, b)


def test_shared_updates_under_replay_equal_eager_calls(card):
    """Three calls with in-place updates and a swap of two shared variables,
    then ``set_value`` and a fourth: the captured function and the eager
    one give the same outputs and leave the same shared values."""
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction

    runs = {}
    for jit in (True, False):
        f, shared = _shared_function(card, jit)
        assert isinstance(f.linked, CapturedFunction) == jit
        outs = []
        for k in range(3):
            outs.append([o.clone() for o in f(as_torch(np.full(7, k, "float32"), card))])
        shared[0].set_value(np.full(7, 2.0, "float32"))
        outs.append(f(as_torch(np.ones(7, "float32"), card)))
        runs[jit] = outs, [s.get_value().cpu() for s in shared]
    (outs_c, vals_c), (outs_e, vals_e) = runs[True], runs[False]
    for oc, oe in zip(outs_c, outs_e):
        assert all(torch.equal(c, e) for c, e in zip(oc, oe))
    assert all(torch.equal(c, e) for c, e in zip(vals_c, vals_e))
    assert float(outs_c[3][0]) == 14.0  # w = 2 after set_value, x = 1


def test_an_uncapturable_function_runs_eagerly_and_raises_on_a_bad_index(card):
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.link.torch.linker import Plan

    v = pt.tensor("v", dtype="float32", shape=(None,))
    i = pt.tensor("i", dtype="int64", shape=(None,))
    f = ptt.function([v, i], v[i] * 2.0, device=card)
    assert isinstance(f.linked, Plan) and not f.linked.capturable
    vals = as_torch(np.arange(4, dtype="float32"), card)
    assert f(vals, as_torch(np.array([3, -4]), card)).cpu().tolist() == [6.0, 0.0]
    with pytest.raises(IndexError, match="out of bounds"):
        f(vals, as_torch(np.array([0, 4]), card))


def test_the_launch_counters_count_replays(card):
    """K1, K2 and K4 count the same launches a call whether the call is the
    capturing one (its warm-up) or a replay; the capture itself counts none."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.link.cuda import scan_kernel, spmv_kernel
    from pytensor_tpu_torch.models.radon import make_leapfrog_chain
    from pytensor_tpu_torch.sparse import as_sparse_variable, structured_dot

    fn, _, n = _entry_pair()
    theta = as_torch(_theta(n, 1), card)
    per_call = []
    for _ in range(3):
        before = fused_kernel.LAUNCHES
        fn(theta)
        per_call.append(fused_kernel.LAUNCHES - before)
    assert per_call[0] > 0 and len(set(per_call)) == 1

    chain = make_leapfrog_chain(n_steps=8, device=card)
    th, m = as_torch(theta_start(n, "float32"), card), torch.zeros(n, device=card)
    for _ in range(3):
        before = scan_kernel.LAUNCHES
        chain(th, m)
        assert scan_kernel.LAUNCHES == before + 1

    A, rng = _sparse(1500, 0.005, 9)
    xsh = ptt.shared(rng.standard_normal((1500, 1)).astype("float32"), name="x", device=card)
    y = structured_dot(as_sparse_variable(A), xsh)
    loop = ptt.train_loop([], pt.sum(y), {xsh: y / (pt.max(pt.abs(y)) + 1e-9)}, n_steps=5,
                          device=card)
    for _ in range(3):
        before = spmv_kernel.LAUNCHES
        loop()
        assert spmv_kernel.LAUNCHES == before + 5


def test_power_iteration_replay_gives_the_eager_plans_bits(card):
    """The 64-step power iteration through train_loop, captured and eager
    from the same start: the same output and final x, bit for bit (K4 and
    the reductions add in a fixed order)."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.sparse import as_sparse_variable, structured_dot

    A, rng = _sparse(1500, 0.005, 10)
    x0 = rng.standard_normal((1500, 1)).astype("float32")
    xsh = ptt.shared(x0, name="x", device=card)
    y = structured_dot(as_sparse_variable(A), xsh)
    upd = {xsh: y / (pt.max(pt.abs(y)) + 1e-9)}
    loops = {}
    for jit in (True, False):
        with config.change_flags(xla__jit=jit):
            loops[jit] = ptt.train_loop([], pt.sum(y), upd, n_steps=64, device=card)
    got = {}
    for jit, calls in ((True, 3), (False, 1)):
        for _ in range(calls):  # the capturing call, then replays
            xsh.set_value(x0)
            out = loops[jit]()
            got.setdefault(jit, []).append((out, xsh.get_value().clone()))
    torch.cuda.synchronize()
    want_out, want_x = got[False][0]
    for out, x in got[True]:
        assert torch.equal(out, want_out) and torch.equal(x, want_x)


# --- the op library of the logistic-regression and MLP slice --------------------------

@pytest.mark.parametrize("dtype", ["float32", "float64", "bool", "int8", "int16", "int32",
                                   "int64"])
def test_k1_every_scalar_op_matches_plain(card, dtype):
    """Every scalar op of the expression table in one fused node a dtype,
    on numpy's edges: the exact ops with the plain version's bits (NaN at
    the same places, the sign of every zero), the others within K1_RTOL of
    max(1, |plain|), infinities at the same places."""
    ins, outs, names = cases.scalar_op_group(dtype)
    kern = fused_kernel.FusedElemwiseKernel(FusedElemwise(ins, outs).fgraph, card)
    args = [as_torch(v, card) for v in cases.op_group_inputs(dtype, ins, 1031)]
    got, want = kern.launch(*args), kern.plain(*args)
    for name, g, w in zip(names, got, want):
        g, w = g.cpu(), w.cpu()
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if not g.dtype.is_floating_point:
            assert torch.equal(g, w), name
            continue
        assert torch.equal(g.isnan(), w.isnan()), name
        g, w = g[~w.isnan()], w[~w.isnan()]
        if name in cases.EXACT_OPS:
            assert torch.equal(g, w) and torch.equal(torch.signbit(g), torch.signbit(w)), name
        else:
            assert torch.equal(g.isinf(), w.isinf()), name
            fin = ~w.isinf()
            rel = (g[fin].double() - w[fin].double()).abs() / w[fin].double().abs().clamp(min=1)
            assert float(rel.max()) <= K1_RTOL[dtype], name


def test_k2_new_ops_match_plain_loop(card):
    """K2 on scans of Dot22, Gemm, Dot22Scalar, Join, Split, ARange,
    DeepCopyOp and ViewOp, and on tanh(dot(W, acc)) with a 5 x 5 W, against
    the step loop on the card, to 1e-6 of max(1, max|loop|)."""
    from pytensor_tpu_torch.link.cuda import scan_kernel
    from pytensor_tpu_torch.scan.op import Scan

    for tag, ins, outs, vals, raw in cases.k2_new_op_scans():
        fg = FunctionGraph(ins, outs, clone=True)
        if not raw:
            FAST_RUN.optimizer.rewrite(fg)
        node = next(nd for nd in fg.apply_nodes if isinstance(nd.op, Scan))
        assert scan_kernel.scan_kernel_eligible(node.op, node), tag
        kern = scan_kernel.ScanKernel(node.op, node, card)
        feed = fgraph_to_torch(FunctionGraph(fg.inputs, node.inputs, clone=False), card)
        n_steps, *outer = feed(*[as_torch(v, card) for v in vals])
        before = scan_kernel.LAUNCHES
        got = kern.launch(n_steps.cpu(), *outer)
        want = kern.plain(n_steps.cpu(), *outer)
        assert scan_kernel.LAUNCHES == before + 1
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.dtype == w.dtype
            assert _scaled(g, w) <= 1e-6, tag


def test_logreg_and_mfu_steps_are_captured_and_launch_k1(card):
    """The logistic-regression step and the MFU step (float32) at small
    widths: captured, K1 launched at every replay, the replay with the
    eager plan's bits from the same state."""
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.models.logreg import make_logreg_training_step
    from pytensor_tpu_torch.models.mlp import make_mlp_mfu_step

    def logreg(jit):
        with config.change_flags(xla__jit=jit):
            f, (X, y), params = make_logreg_training_step(256, 16, device=card)
        return f, [as_torch(X, card), as_torch(y, card)], list(params)

    def mfu(jit):
        with config.change_flags(xla__jit=jit):
            f, _, args = make_mlp_mfu_step(64, 32, 2, "float32", device=card)
        return f, list(args), sorted((v for v in f.shared_vars), key=lambda v: v.name)

    for make in (logreg, mfu):
        (f, args, params), (f_e, _, params_e) = make(True), make(False)
        assert isinstance(f.linked, CapturedFunction)
        init = [v.get_value() for v in params]
        f(*args)
        for v, x in zip(params, init):
            v.set_value(x.clone())
        before = fused_kernel.LAUNCHES
        out = f(*args)
        torch.cuda.synchronize()
        assert fused_kernel.LAUNCHES > before
        out_e = f_e(*args)
        assert torch.equal(out, out_e)
        for a, b in zip(params, params_e):
            assert torch.equal(a.get_value(), b.get_value()), a.name


@pytest.mark.parametrize("mode", ["set", "inc_ignore_duplicates"])
@pytest.mark.parametrize("form", ["axis0", "axis1", "flat"])
def test_duplicate_index_write_takes_the_last_on_the_card(card, form, mode):
    """A set, or an increment that ignores duplicates, of an index with many
    duplicates (each of 8 positions written ~25,000 times) in each form the
    port lowers apart: numpy's result (the JAX package's oracle computes it
    with numpy, ``tests/test_torch_ops.py`` holds the port to that oracle),
    bit for bit, at every one of three calls, captured and eager."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.config import config

    rng = np.random.default_rng(5)
    x0 = rng.standard_normal((8, 256))
    rows, cols = rng.integers(0, 8, 200_000), rng.integers(0, 8, 200_000)
    index, y_shape, np_index = {
        "axis0": (lambda x: x[rows], (200_000, 256), rows),
        "axis1": (lambda x: x[:, cols], (8, 200_000), (slice(None), cols)),
        "flat": (lambda x: x[rows, cols], (200_000,), (rows, cols)),
    }[form]
    y0 = np.arange(np.prod(y_shape), dtype="float64").reshape(y_shape)
    want = x0.copy()
    if mode == "set":
        want[np_index] = y0
    else:
        want[np_index] += y0
    x = pt.tensor("x", dtype="float64", shape=x0.shape)
    y = pt.tensor("y", dtype="float64", shape=y_shape)
    out = (pt.set_subtensor(index(x), y) if mode == "set"
           else pt.inc_subtensor(index(x), y, ignore_duplicates=True))
    for jit in (True, False):
        with config.change_flags(xla__jit=jit):
            f = ptt.function([x, y], out, device=card)
        for _ in range(3):
            got = f(as_torch(x0, card), as_torch(y0, card))
            np.testing.assert_array_equal(got.cpu().numpy(), want)


@pytest.mark.parametrize("steps", [1, 3], ids=["function", "train_loop"])
def test_elman_step_is_captured_and_matches_the_cpu(card, steps):
    """The Elman BPTT step (and its loop, whose scans sit in the loop's
    scan) at small widths: captured, with the eager plan's bits from the
    same state and the CPU's values."""
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.models.rnn import make_elman_rnn_bptt

    def make(device, jit=True):
        with config.change_flags(xla__jit=jit):
            return make_elman_rnn_bptt(8, 4, 8, n_steps_per_call=steps, device=device)

    (f, (X, y), ws), (f_e, _, ws_e), (f_c, _, ws_c) = make(card), make(card, False), make("cpu")
    assert isinstance(f.linked, CapturedFunction) and f.linked.plan.host_reads == []
    args = [as_torch(X, card), as_torch(y, card)]
    init = [w.get_value() for w in ws]
    f(*args)
    for w, x in zip(ws, init):
        w.set_value(x.clone())
    out, out_e, out_c = f(*args), f_e(*args), f_c(X, y)
    assert torch.equal(out, out_e)
    assert _scaled(out.cpu(), out_c) <= 1e-5
    for a, b, c in zip(ws, ws_e, ws_c):
        assert torch.equal(a.get_value(), b.get_value())
        assert _scaled(a.get_value().cpu(), c.get_value()) <= 1e-5


def test_blockwise_on_the_card_matches_the_cpu(card):
    """A Blockwise{Dot} (one batched torch.matmul) and a Blockwise of a core
    op without a batching rule (the core lowering over the batch)."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.graph.replace import vectorize_graph

    a = pt.tensor("a", dtype="float32", shape=(5, 1, 3, 4))
    b = pt.tensor("b", dtype="float32", shape=(2, 4, 2))
    x = pt.tensor("x", dtype="float32", shape=(4, 3))
    xb = pt.tensor("xb", dtype="float32", shape=(2, 4, 3))
    outs = [pt.matmul(a, b), vectorize_graph(pt.argmax(x, axis=0), replace={x: xb})]
    rng = np.random.default_rng(0)
    vals = [rng.standard_normal(v.type.shape).astype("float32") for v in (a, b, xb)]
    got = ptt.function([a, b, xb], outs, device=card)(*[as_torch(v, card) for v in vals])
    want = ptt.function([a, b, xb], outs, device="cpu")(*vals)
    assert _scaled(got[0].cpu(), want[0]) <= 1e-5
    assert torch.equal(got[1].cpu(), want[1])


def test_static_bptt_takes_k2_for_its_forward_scan(card):
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda import scan_kernel

    def build():
        v0 = pt.tensor("v0", dtype="float32", shape=(16,))
        W = pt.tensor("W", dtype="float32", shape=(16, 16))
        tr, _ = ptt.scan(lambda acc, w: pt.tanh(pt.dot(w, acc)), outputs_info=[v0],
                         non_sequences=[W], n_steps=12)
        loss = (tr ** 2).sum()
        return [v0, W], [loss, *ptt.grad(loss, [v0, W])]

    rng = np.random.default_rng(1)
    vals = [as_torch(rng.standard_normal(16).astype("float32"), card),
            as_torch((rng.standard_normal((16, 16)) * 0.3).astype("float32"), card)]
    with config.change_flags(scan__pallas=True):
        f = ptt.function(*build(), device=card)
    loop = ptt.function(*build(), device=card)
    f(*vals)
    before = scan_kernel.LAUNCHES
    got = f(*vals)
    torch.cuda.synchronize()
    assert scan_kernel.LAUNCHES == before + 1
    for g, w in zip(got, loop(*vals)):
        assert _scaled(g, w) <= 1e-5


# --- the linalg slice ------------------------------------------------------------------

@pytest.mark.parametrize("steps", [1, 3], ids=["function", "train_loop"])
def test_gp_step_is_captured_and_matches_the_cpu(card, steps):
    """The GP SGD step (n 32, float32) and its loop: captured, the eager
    plan's bits from the same state, the CPU's values."""
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.models.gp import make_gp_sgd_step

    def make(device, jit=True):
        with config.change_flags(xla__jit=jit):
            return make_gp_sgd_step(32, dtype="float32", n_steps_per_call=steps, device=device)

    (f, ps), (f_e, ps_e), (f_c, ps_c) = make(card), make(card, False), make("cpu")
    assert isinstance(f.linked, CapturedFunction) and f.linked.plan.host_reads == []
    f()
    for p in ps:
        p.set_value(np.zeros((), "float32"))
    out, out_e, out_c = f(), f_e(), f_c()
    assert torch.equal(out, out_e)
    assert _scaled(out.cpu(), out_c) <= 1e-5
    for a, b, c in zip(ps, ps_e, ps_c):
        assert torch.equal(a.get_value(), b.get_value())
        assert _scaled(a.get_value().cpu(), c.get_value()) <= 1e-5


def test_kalman_loglike_and_grad_is_captured_and_matches_the_cpu(card):
    """16 steps: the pushed-out Blockwise nodes and both scans captured
    (the diagonal gradient's ``arange`` indices are bounded by their size,
    with no read of the device), the CPU's values."""
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.models.kalman import make_kalman_loglike_and_grad

    f, theta, _ = make_kalman_loglike_and_grad(16, dtype="float32", device=card)
    f_c, _, _ = make_kalman_loglike_and_grad(16, dtype="float32", device="cpu")
    assert isinstance(f.linked, CapturedFunction) and f.linked.plan.host_reads == []
    args = [as_torch(np.asarray(v), card) for v in theta]
    f(*args)
    for g, w in zip(f(*args), f_c(*theta)):
        assert g.dtype == w.dtype
        assert _scaled(g.cpu(), w) <= 1e-5


def test_blockwise_cholesky_is_one_batched_call(card):
    """A Blockwise{Cholesky} of 16 matrices is one call of
    ``torch.linalg.cholesky_ex``, with the CPU's values; a matrix that is
    not positive definite is NaN in its lower triangle alone, and only the
    lower triangle is read, on the card as on the CPU."""
    from torch.profiler import ProfilerActivity, profile

    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.tensor import linalg as ptl

    A = pt.tensor("A", dtype="float64", shape=(16, 8, 8))
    f = ptt.function([A], ptl.cholesky(A), device=card)
    f_c = ptt.function([A], ptl.cholesky(A), device="cpu")
    rng = np.random.default_rng(4)
    a = rng.standard_normal((16, 8, 8))
    v = a @ a.transpose(0, 2, 1) + 8 * np.eye(8)
    v[3] = np.tril(v[3]) + np.triu(rng.standard_normal((8, 8)) * 50, 1)  # garbage above
    v[5, 0, 0] = -1.0  # not positive definite
    x = as_torch(v, card)
    f(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        f.linked.plan(x)
    calls = sum(e.count for e in prof.key_averages() if e.key == "aten::linalg_cholesky_ex")
    assert calls == 1
    got, want = f(x).cpu(), f_c(v)
    assert torch.equal(got.isnan(), want.isnan())
    lower = torch.tril_indices(8, 8)
    assert bool(got[5][lower[0], lower[1]].isnan().all()) and bool((got[5].triu(1) == 0).all())
    ok = [k for k in range(16) if k != 5]
    assert _scaled(got[ok], want[ok]) <= 1e-12


# --- the special functions ----------------------------------------------------------

SPECIAL_TOL = {"float32": 2e-5, "float64": 5e-9}


def _held_special(name, got, want, dtype):
    g, w = got.double().cpu(), want.double().cpu()
    assert torch.equal(g.isnan(), w.isnan()), name
    inf = w.isinf()
    assert torch.equal(g[inf], w[inf]), name
    fin = torch.isfinite(w)
    assert _scaled(g[fin], w[fin]) <= SPECIAL_TOL[dtype] if fin.any() else True, name


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k1_special_functions_match_plain(card, dtype):
    from pytensor_tpu_torch.link.torch.dispatch import _one_node_k1

    fns = {name: _one_node_k1(cases.special_node(name, dtype).op,
                              cases.special_node(name, dtype), card)
           for name in sorted(cases.SPECIAL_GRIDS)}
    fused_kernel.build([f.k1 for f in fns.values()])
    for name, fn in fns.items():
        args = [as_torch(v, card) for v in cases.special_inputs(name, dtype, 4096, 5)]
        got = fn.k1.launch(*args)[0]
        _held_special(name, got, fn.k1.plain(*args)[0], dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_k1_special_op_group_matches_plain(card, dtype):
    ins, outs, names = cases.special_op_group(dtype)
    kern = fused_kernel.FusedElemwiseKernel(FusedElemwise(ins, outs).fgraph, card)
    args = [as_torch(v, card) for v in cases.special_group_inputs(dtype, 4099)]
    for name, g, w in zip(names, kern.launch(*args), kern.plain(*args)):
        _held_special(name, g, w, dtype)


def test_censored_gradient_counts_its_device_functions(card):
    """models/censored.py's logp and gradient, captured: a replay counts
    one launch of each kernel holding gammaincc_ddk, betainc_dda and
    betainc_ddb (``fused_kernel.OP_LAUNCHES``), and gives the CPU's plain
    versions' values within 1e-9."""
    from pytensor_tpu_torch.models import censored

    t, y = censored.censored_data(4096, 3)
    params = [np.asarray(p) for p in censored.PARAMS]
    f = censored.make_censored_logp(device=card)
    args = [as_torch(v, card) for v in (t, y, *params)]
    f(*args)
    fused_kernel.OP_LAUNCHES.clear()
    got = f(*args)
    torch.cuda.synchronize()
    assert {k: fused_kernel.OP_LAUNCHES[k] for k in
            ("gammaincc_ddk", "betainc_dda", "betainc_ddb")} == {
        "gammaincc_ddk": 1, "betainc_dda": 1, "betainc_ddb": 1}
    want = censored.make_censored_logp(device="cpu")(t, y, *params)
    np.testing.assert_allclose([float(g.cpu()) for g in got], [float(w) for w in want],
                               rtol=1e-9)


def test_a_special_elemwise_on_the_card_launches_k1(card):
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt

    x = pt.vector("x", dtype="float32")
    f = ptt.function([x], pt.kve(1.0, x), device=card)
    v = torch.linspace(0.5, 4.0, 1000, device=card)
    f(v)
    fused_kernel.LAUNCHES = 0
    got = f(v)
    torch.cuda.synchronize()
    assert fused_kernel.LAUNCHES == 1
    from pytensor_tpu_torch.scalar import bessel
    torch.testing.assert_close(got, bessel.kve(torch.ones_like(v).double(), v.double()).float(),
                               rtol=2e-6, atol=0)


def test_a_failed_k1_build_raises(card, monkeypatch):
    """No fallback: a K1 kernel whose build fails raises at its launch."""
    from pytensor_tpu_torch.link.cuda import build as cuda_build

    def refuse(*args, **kwargs):
        raise RuntimeError("nvcc failed (refused by the test)")

    node = cases.special_node("erfcx", "float32")
    from pytensor_tpu_torch.link.torch.dispatch import _one_node_k1

    fn = _one_node_k1(node.op, node, card)
    monkeypatch.setattr(fused_kernel, "_ENTRIES", {})  # nothing built yet
    monkeypatch.setattr(cuda_build, "build_library", refuse)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        fn(torch.ones(8, device=card))


@pytest.mark.parametrize("pallas", [False, True], ids=["step_loop", "scan__pallas"])
def test_bessel_loop_on_the_card(card, pallas):
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda import scan_kernel
    from pytensor_tpu_torch.models.bessel import bessel_reference, make_bessel_loop, v_start

    with config.change_flags(scan__pallas=pallas):
        f, v = make_bessel_loop(256, 4, device=card)
    f()
    v.set_value(as_torch(v_start(256), card))
    fused_kernel.LAUNCHES = scan_kernel.LAUNCHES = 0
    f()
    torch.cuda.synchronize()
    launches = (fused_kernel.LAUNCHES, scan_kernel.LAUNCHES)
    assert launches == ((0, 1) if pallas else (8, 0))
    want, _ = bessel_reference(v_start(256), 4)
    got = v.get_value().double().cpu().numpy()
    assert np.max(np.abs(got - want) / np.abs(want)) <= 2e-6


# --- bfloat16 --------------------------------------------------------------------------

def _bf16_ulps(a, b):
    def ordered(x):
        u = x.view(torch.int16).to(torch.int32)
        return torch.where(u < 0, -(u & 0x7FFF), u)

    d = (ordered(a) - ordered(b)).abs()
    return int(torch.where(a.isnan() & b.isnan(), torch.zeros_like(d), d).max())


def test_bf16_products_reduce_in_float32_under_capture(card):
    """A bfloat16 product inside a linked call runs with cuBLAS's
    reduced-precision reductions off, captured and replayed alike, and the
    caller's setting is back after each call: the replay's bits are the
    product's taken with the setting off, whatever the caller's."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt

    matmul = torch.backends.cuda.matmul
    gen = torch.Generator(device=card).manual_seed(12)
    x = torch.randn(64, 8192, generator=gen, device=card).to(torch.bfloat16)
    y = torch.randn(8192, 64, generator=gen, device=card).to(torch.bfloat16)
    prev = matmul.allow_bf16_reduced_precision_reduction
    try:
        matmul.allow_bf16_reduced_precision_reduction = False
        want = x @ y
        xs, ys = pt.tensor("x", dtype="bfloat16", shape=(64, 8192)), pt.tensor(
            "y", dtype="bfloat16", shape=(8192, 64))
        f = ptt.function([xs, ys], pt.dot(xs, ys), device=card)
        for setting in (True, False, True):
            matmul.allow_bf16_reduced_precision_reduction = setting
            got = f(x, y)  # a capture, then replays
            assert matmul.allow_bf16_reduced_precision_reduction is setting
            assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    finally:
        matmul.allow_bf16_reduced_precision_reduction = prev


def test_k1_bf16_op_group_matches_plain(card):
    """K1 on every op of its table in bfloat16, one fused node, on numpy's
    edges: the exact ops with the plain version's bits, the others within
    1 ulp."""
    ins, outs, names = cases.bf16_op_group()
    kern = fused_kernel.FusedElemwiseKernel(FusedElemwise(ins, outs).fgraph, card)
    vals = [as_torch(v, card) for v in cases.op_group_inputs("bfloat16", ins, 4099)]
    got, want = kern.launch(*vals), kern.plain(*vals)
    torch.cuda.synchronize()
    for name, g, w in zip(names, got, want):
        if g.dtype == torch.bool:
            assert torch.equal(g, w), name
        else:
            assert _bf16_ulps(g, w) <= (0 if name in cases.BF16_EXACT_OPS else 1), name


def test_k2_bf16_ewma_matches_its_step_loop(card):
    """The EWMA scan in bfloat16 under ``scan__pallas``: one K2 launch, bit
    for bit its step loop on the card."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda import scan_kernel
    from pytensor_tpu_torch.scan.op import Scan
    from pytensor_tpu_torch.utils import np_dtype

    bf = np_dtype("bfloat16").type
    x = pt.tensor("x", dtype="bfloat16", shape=(512,))
    with config.change_flags(scan__pallas=True):
        tr, _ = ptt.scan(lambda xt, acc: bf(0.98) * acc + bf(0.02) * xt, sequences=[x],
                         outputs_info=[pt.constant(np.asarray(0.0, np_dtype("bfloat16")))])
        f = ptt.function([x], tr, device=card)
    xv = torch.randn(512, device=card).to(torch.bfloat16)
    f(xv)
    scan_kernel.LAUNCHES = 0
    got = f(xv)
    torch.cuda.synchronize()
    assert scan_kernel.LAUNCHES == 1
    node = next(nd for nd in f.fgraph.apply_nodes if isinstance(nd.op, Scan))
    feed = fgraph_to_torch(FunctionGraph(f.fgraph.inputs, node.inputs, clone=True), card)
    want = scan_kernel.ScanKernel(node.op, node, card).plain(*feed(xv))[0]
    assert got.dtype == torch.bfloat16 and _bf16_ulps(got, want) == 0


TAIL_GROUPS = ("cumop bool", "cumop int32", "cumop float32", "cumop float64", "repeat",
               "searchsorted", "topk ties", "unravel ravel", "fft float32", "fft float64",
               "convolve1d", "convolve2d", "pad", "interp")


@pytest.mark.parametrize("tag", TAIL_GROUPS)
def test_tail_lowerings_match_the_cpu(card, tag):
    """Each group of the tail's lowerings (``cases.tail_cases``) linked for
    the card against the same graph linked for the CPU: integer and bool
    results exactly, floats within ``cases.TAIL_RTOL`` of max|cpu|."""
    import pytensor_tpu_torch as ptt

    (_, ins, outs, vals), = [c for c in cases.tail_cases(2 ** 12) if c[0] == tag]
    on_card = ptt.function(ins, outs, device=card)
    on_cpu = ptt.function(ins, outs, device="cpu")
    got, want = on_card(*vals), on_cpu(*vals)
    for g, w, o in zip(got, want, outs):
        err = cases.tail_held(g.cpu().numpy(), w.numpy(), o.type.dtype)
        assert err <= (0 if o.type.dtype in ("bool", "int32", "int64") else
                       cases.TAIL_RTOL[o.type.dtype]), (tag, str(o), err)


def test_einsum_loop_and_step_on_the_card(card):
    """The einsum loop at small widths, captured, against the float64
    reference; the step launches K1 once a call (its FusedElemwise)."""
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.models import einsum as em

    m, n, steps = 8, 256, 4
    loop, a = em.make_einsum_loop(steps, m=m, n=n, device=card)
    assert isinstance(loop.linked, CapturedFunction)
    loop()
    ref, _ = em.einsum_reference(*em.einsum_data(m, n), 2 * steps)
    block = a.get_value().cpu().numpy()[:m, :m]
    assert np.max(np.abs(block - ref[:m, :m])) <= 1e-5 * np.max(np.abs(ref[:m, :m]))
    step, _ = em.make_einsum_step(m=m, n=n, device=card)
    step()
    fused_kernel.LAUNCHES = 0
    step()
    torch.cuda.synchronize()
    assert fused_kernel.LAUNCHES == 1


def test_cumsum_scan_in_k2_equals_cumop(card):
    """``benchsuite.py:87 ours_scan``'s cumsum row under ``scan__pallas``
    (one K2 launch) and ``pt.cumsum(x) / n`` through ``CumOp``: the same
    function by two routes, within ``1e-5`` of max|cumop|."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda import scan_kernel

    n = 1024
    x = pt.tensor("x", dtype="float32", shape=(n,))
    with config.change_flags(scan__pallas=True):
        tr, _ = ptt.scan(lambda xt, acc: acc + xt, sequences=[x],
                         outputs_info=[pt.constant(np.float32(0.0))])
        f = ptt.function([x], tr / np.float32(n), device=card)
    g = ptt.function([x], pt.cumsum(x) / np.float32(n), device=card)
    xv = torch.randn(n, device=card)
    f(xv)
    scan_kernel.LAUNCHES = 0
    got = f(xv)
    torch.cuda.synchronize()
    assert scan_kernel.LAUNCHES == 1
    want = g(xv)
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_k1_floor_division_keeps_the_sign_of_zero(card):
    """K1's floor division of a signed zero: numpy's sign (-0.0 // 0.3 is
    -0.0), bit for bit its plain version."""
    import pytensor_tpu_torch.tensor as pt

    for dtype in ("float32", "float64"):
        x, y = pt.tensor("x", dtype=dtype, shape=(None,)), pt.tensor("y", dtype=dtype,
                                                                      shape=(None,))
        kern = fused_kernel.FusedElemwiseKernel(FusedElemwise([x, y], [x // y]).fgraph, card)
        xv = torch.tensor([-0.0, 0.0, -0.0, 0.0], dtype=getattr(torch, dtype), device=card)
        yv = torch.tensor([0.3, 0.3, -0.3, -0.3], dtype=getattr(torch, dtype), device=card)
        got = kern.launch(xv, yv)[0]
        assert torch.equal(torch.signbit(got).cpu(), torch.tensor([True, False, False, True]))
        assert torch.equal(torch.signbit(got), torch.signbit(kern.plain(xv, yv)[0]))


@pytest.mark.parametrize("dtype", ["complex64", "complex128"])
def test_k1_complex_ops_match_plain_and_numpy(card, dtype):
    """Every complex op K1 emits, one node a launch, on ``cases.complex_values``
    (signed zeros, units, the axes, parts of very different sizes first)."""
    from pytensor_tpu_torch.graph.fg import FunctionGraph as FG

    bad = []
    for name in cases.COMPLEX_OPS:
        node = cases.complex_node(name, dtype)
        kern = fused_kernel.FusedElemwiseKernel(FG(list(node.inputs), node.outputs, clone=True),
                                                card)
        vals = cases.complex_inputs(name, dtype, 4099, 17)
        args = [as_torch(v, card) for v in vals]
        (got,) = kern.launch(*args)
        (want,) = kern.plain(*args)
        torch.cuda.synchronize()
        got, want = got.cpu().numpy(), want.cpu().numpy()
        if not cases.complex_held(got, want, name, dtype):
            bad.append((name, "plain"))
        if not cases.complex_near(got, cases.numpy_complex_op(name, vals), dtype):
            bad.append((name, "numpy"))
    assert not bad, bad


def test_periodogram_is_one_k1_launch(card):
    """The periodogram (8 x 4,096 float32): one K1 launch a replayed call,
    for the group of ``abs`` and ``sqr`` (``complex`` and ``angle`` are
    single nodes, as in the JAX package), its power within ``1e-5`` of its
    max and its phase within ``2e-3`` (where |c| is above 1e-3 of its max)
    of float64 NumPy; and the whole chain as one K1 kernel
    (``cases.periodogram_chain``) within 8 epsilons of its plain version."""
    import pytensor_tpu_torch as ptt

    f = ptt.function(*cases.periodogram_graph(), device=card)
    x = torch.randn(8, 4096, device=card)
    f(x)
    fused_kernel.LAUNCHES = 0
    power, phase = f(x)
    torch.cuda.synchronize()
    assert fused_kernel.LAUNCHES == 1
    spec = np.fft.rfft(x.double().cpu().numpy())
    assert np.abs(power.cpu().numpy() - np.abs(spec) ** 2).max() <= 1e-5 * (np.abs(spec) ** 2).max()
    big = np.abs(spec) > 1e-3 * np.abs(spec).max()
    dphi = np.angle(np.exp(1j * (phase.cpu().numpy() - np.angle(spec))))
    assert np.abs(dphi[big]).max() <= 2e-3
    kern = fused_kernel.FusedElemwiseKernel(FunctionGraph(*cases.periodogram_chain(),
                                                          clone=True), card)
    packed = torch.view_as_real(torch.fft.rfft(x))
    parts = [packed[..., 0], packed[..., 1]]
    for got, want in zip(kern.launch(*parts), kern.plain(*parts)):
        torch.cuda.synchronize()
        assert cases.complex_held(got.cpu().numpy(), want.cpu().numpy(), "abs", "complex64")


def test_logreg_map_on_the_card_matches_the_cpu(card):
    """The MAP of the logistic regression at n 512, d 16, float64, lam 1e-3:
    BFGS (its evaluations replayed, each launching K1), Newton (captured
    whole) and the IFT gradient, each within ``1e-10`` of the same function
    linked for the CPU."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.models.logreg import _xent, make_logreg_graphs
    from pytensor_tpu_torch.tensor.optimize import minimize, root

    (X, y, w, b), _, (Xv, yv, wv, bv) = make_logreg_graphs(512, 16, "float64")
    lam = pt.dscalar("lam")
    obj = _xent(X, y, w, b, "float64") + 0.5 * lam * pt.sum(w ** 2)
    (ws, ok), _ = minimize(obj, w)
    (wr, okr), _ = root(ptt.grad(obj, w), w)
    outs = {"bfgs": [ws, ok, ptt.grad(pt.sum(ws), lam)], "newton": [wr, okr]}
    vals = [wv, Xv, yv, bv, np.asarray(1e-3)]
    for kind, o in outs.items():
        on_card = ptt.function([w, X, y, b, lam], o, device=card)
        on_cpu = ptt.function([w, X, y, b, lam], o, device="cpu")
        assert isinstance(on_card.linked, CapturedFunction) == (kind == "newton")
        on_card(*[as_torch(v, card) for v in vals])
        fused_kernel.LAUNCHES = 0
        got = on_card(*[as_torch(v, card) for v in vals])
        torch.cuda.synchronize()
        assert fused_kernel.LAUNCHES > 0
        for g, w_ in zip(got, on_cpu(*vals)):
            assert np.allclose(g.cpu().numpy(), w_.numpy(), rtol=1e-10, atol=1e-10), kind


# jax's answers for threefry2x32 (key, 64-bit counter, the two words)
RANDOM123 = [((0, 0), 0, (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF, 0xFFFFFFFF), 2 ** 64 - 1, (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), 0x243F6A8885A308D3, (0xC4923A9C, 0x483DF7A0))]


@pytest.mark.parametrize("mode", ["bits32", "bits64", "keys", "uniform64", "normal64",
                                  "uniform32"])
def test_threefry_kernel_matches_plain(card, mode):
    """Each mode of the threefry kernel at 2**20 + 3 counters against its
    plain version on the card (the normals within ``1e-11``, CUDA's erfinv
    not being torch's; the rest bit for bit), and jax's answers."""
    from pytensor_tpu_torch.link.cuda import threefry_kernel as tk

    m = {"bits32": tk.BITS32, "bits64": tk.BITS64, "keys": tk.KEYS,
         "uniform64": tk.UNIFORM64, "normal64": tk.NORMAL64, "uniform32": tk.UNIFORM32}[mode]
    key = torch.tensor([0x13198A2E, 0xFFFFFFFF], dtype=torch.int64, device=card)
    before = tk.LAUNCHES
    got = tk.launch(key, 2 ** 20 + 3, m, -2.5, 3.0)
    want = tk.plain(key, 2 ** 20 + 3, m, -2.5, 3.0)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 1
    if mode == "normal64":
        assert bool(((got - want).abs() <= 1e-11 * want.abs()).all())
    else:
        assert torch.equal(got, want)
    for k, first, words in RANDOM123:
        out = tk.launch(torch.tensor(k, device=card), 1, tk.KEYS, first=first)
        assert tuple(out[0].tolist()) == words


@pytest.mark.parametrize("mode", ["bits32", "bits64", "keys", "uniform64", "normal64",
                                  "uniform32"])
def test_threefry_folded_draw_is_the_split_then_the_draw(card, mode):
    """Each mode's folded draw (one launch under ``split(key)[1]`` that
    writes ``split(key)``) at 89, 22,784 and 2**20 + 3 draws against the
    split followed by the plain draw, and the draws at the counters
    ``2**32 - 3`` on, plain and folded (two launches, counted, the
    second's output off a 16-byte boundary and, folded, under the draw key
    the first wrote) against the plain version."""
    from pytensor_tpu_torch.link.cuda import threefry_kernel as tk
    from pytensor_tpu_torch.tensor.random import threefry as tf

    m = {"bits32": tk.BITS32, "bits64": tk.BITS64, "keys": tk.KEYS,
         "uniform64": tk.UNIFORM64, "normal64": tk.NORMAL64, "uniform32": tk.UNIFORM32}[mode]
    key = torch.tensor([0x13198A2E, 0xFFFFFFFF], dtype=torch.int64, device=card)

    def same(got, want):
        if mode == "normal64":
            return bool(((got - want).abs() <= 1e-11 * want.abs()).all())
        return torch.equal(got, want)

    for n in (89, 22784, 2 ** 20 + 3):
        split = torch.full((2, 2), -1, dtype=torch.int64, device=card)
        before = tk.LAUNCHES
        got = tk.launch(key, n, m, -2.5, 3.0, split=split)
        torch.cuda.synchronize()
        assert tk.LAUNCHES == before + 1
        keys = tf.split(key)
        assert torch.equal(split, keys)
        assert same(got, tk.plain(keys[1].contiguous(), n, m, -2.5, 3.0))
    first, n = 2 ** 32 - 3, 2 ** 20 + 3
    split = torch.full((2, 2), -1, dtype=torch.int64, device=card)
    before = tk.LAUNCHES
    got = tk.launch(key, n, m, -2.5, 3.0, first=first)
    folded = tk.launch(key, n, m, -2.5, 3.0, first=first, split=split)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == before + 4
    assert same(got, tk.plain(key, n, m, -2.5, 3.0, first=first))
    assert same(folded, tk.plain(keys[1].contiguous(), n, m, -2.5, 3.0, first=first))


@pytest.mark.parametrize("entry", ["make_radon_hmc", "make_radon_hmc_chains",
                                   "make_radon_multinomial_hmc"])
def test_hmc_transition_is_one_replay_and_matches_the_cpu(card, entry):
    """An HMC transition at 50 observations, 6 counties, 6 leapfrog steps
    (4 chains): one captured CUDA graph, K1 and threefry launched at each
    replay, and 3 transitions within ``2e-4`` of the same function on the
    CPU, with the same accepts or indices."""
    import pytensor_tpu_torch.models.hmc as hmc
    from pytensor_tpu_torch.link.cuda import threefry_kernel as tk
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction

    kw = dict(n_obs=50, n_counties=6, n_leapfrog=6)
    if entry == "make_radon_hmc_chains":
        kw["n_chains"] = 4
    f, pos = getattr(hmc, entry)(device=card, **kw)[:2]
    g, gpos = getattr(hmc, entry)(device="cpu", **kw)[:2]
    assert isinstance(f.linked, CapturedFunction)
    for step in range(3):
        if step == 2:
            fused_kernel.LAUNCHES = tk.LAUNCHES = 0
        (a_logp, a_acc), (b_logp, b_acc) = f(), g()
        torch.cuda.synchronize()
        assert torch.equal(a_acc.cpu(), b_acc)
        assert _scaled(a_logp.cpu().double(), b_logp.double()) <= 2e-4
        assert _scaled(pos.get_value().cpu().double(), gpos.get_value().double()) <= 2e-4
    # the momenta's normals and the Metropolis or Gumbel uniforms, each one
    # launch that also makes its key's split
    assert fused_kernel.LAUNCHES > 0 and tk.LAUNCHES == 2
    assert len(f.linked.graphs) == 1


@pytest.mark.parametrize("name", list(cases.LOOP_SAMPLERS))
def test_loop_sampler_kernels_match_plain(card, name):
    """Each of jax's loop samplers at 4,096 draws on its edge grid
    (``cases.loop_grid``) in float32 and float64: the draw through the
    gamma, Poisson or binomial kernel (one launch each, no host read) bit
    for bit the draw with the plain loops on the card."""
    from pytensor_tpu_torch.link.cuda import binomial_kernel, gamma_kernel, poisson_kernel
    from pytensor_tpu_torch.tensor.random import basic

    mods = {"gamma": gamma_kernel, "poisson": poisson_kernel, "binomial": binomial_kernel}
    mod = mods[cases.LOOP_SAMPLERS[name]]
    rv = basic._gamma if name == "gamma" else getattr(basic, name)
    key = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64, device=card)
    batch = (1024,) if rv.ndim_supp else (4096,)
    for dt in ("float32", "float64"):
        params = [torch.from_numpy(a.astype(dt)).to(card) for a in cases.loop_grid(name, batch)]
        out_dtype = dt if rv.dtype == "floatX" else rv.dtype
        before = mod.LAUNCHES
        got = rv.draw(key, None, params, out_dtype)[1]
        assert mod.LAUNCHES > before
        saved = {m: m.draw for m in mods.values()}
        try:
            for m in mods.values():
                m.draw = m.plain
            want = rv.draw(key, None, params, out_dtype)[1]
        finally:
            for m, draw in saved.items():
                m.draw = draw
        torch.cuda.synchronize()
        same = (got == want) | (torch.isnan(got) & torch.isnan(want)) if got.is_floating_point() \
            else got == want
        assert bool(same.all()), (name, dt, int((~same).sum()))


@pytest.mark.parametrize("grid", ["typical", "edges", "boosted"])
def test_gamma_kernel_across_its_tiles_and_drains(card, grid):
    """The gamma kernel against its plain version, bit for bit, at sizes
    around its block's share and tiles (one element; a block's first
    round; a share of several tiles ending mid-tile; 2**20 + 7, where the
    queue of the boosted grid fills and drains mid-share), in both
    ``log_space`` modes."""
    from pytensor_tpu_torch.link.cuda import gamma_kernel

    vals = {"typical": cases.LOOP_TYPICAL["gamma"], "edges": cases.LOOP_GAMMA_ALPHA,
            "boosted": [1e-3, 0.5]}[grid]
    key = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64, device=card)
    for n in (1, 255, 257, 4097, 135_173, 2 ** 20 + 7):
        alpha = torch.from_numpy(np.resize(np.array(vals, "float64"), n)).to(card)
        for log_space in (False, True):
            got = gamma_kernel.launch(key, alpha, log_space)
            want = gamma_kernel.plain(key, alpha, log_space)
            torch.cuda.synchronize()
            same = (got == want) | (torch.isnan(got) & torch.isnan(want))
            assert bool(same.all()), (n, log_space, int((~same).sum()))


def test_binomial_kernel_int64_draws_are_the_cast_float64_draws(card):
    """The binomial kernel's int64 draws (the binomial RVs') are its float64
    draws cast as XLA casts them, and its plain version's, on the edge grid
    (NaN draws to 0, an infinite count to the largest int64)."""
    from pytensor_tpu_torch.link.cuda import binomial_kernel
    from pytensor_tpu_torch.tensor.random.samplers import saturating_cast

    key = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64, device=card)
    for dt in (torch.float32, torch.float64):
        count, prob = (torch.from_numpy(a).to(dt).to(card).contiguous()
                       for a in cases.loop_grid("binomial", (4096,)))
        got = binomial_kernel.launch(key, count, prob, torch.int64)
        wide = binomial_kernel.launch(key, count, prob, torch.float64)
        want = binomial_kernel.plain(key, count, prob, torch.int64)
        torch.cuda.synchronize()
        assert got.dtype == torch.int64
        assert torch.equal(got, saturating_cast(wide, torch.int64))
        assert torch.equal(got, want)


def test_gibbs_chain_is_one_replay_and_matches_the_cpu(card):
    """The RBM Gibbs chain at the JAX package's test sizes (20 x 30, 3
    chains, 10 steps): one captured CUDA graph launching the binomial
    kernel, which makes each draw's split, and no threefry launch, and {0,
    1} draws of the chain's shape; with the products exact in float32 on
    both devices (W of halves, zero biases), the card's draws are the
    CPU's at the same keys."""
    from pytensor_tpu_torch.link.cuda import binomial_kernel
    from pytensor_tpu_torch.link.cuda import threefry_kernel as tk
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.models.rbm import make_gibbs_chain

    rng = np.random.default_rng(41)
    W = (rng.integers(-2, 3, (20, 30)) * 0.5).astype("float32")
    zeros_h, zeros_v = np.zeros(30, "float32"), np.zeros(20, "float32")
    v0 = rng.binomial(1, 0.5, size=(3, 20)).astype("float32")
    f, _ = make_gibbs_chain(W, zeros_h, zeros_v, n_steps=10, device=card)
    g, _ = make_gibbs_chain(W, zeros_h, zeros_v, n_steps=10, device="cpu")
    assert isinstance(f.linked, CapturedFunction)
    for call in range(2):
        if call == 1:
            binomial_kernel.LAUNCHES = tk.LAUNCHES = 0
        a, b = f(torch.from_numpy(v0).to(card)), g(v0)
        torch.cuda.synchronize()
        assert tuple(a.shape) == (3, 20) and bool(((a == 0) | (a == 1)).all())
        assert torch.equal(a.cpu(), b)
    # one cooperative launch a draw, two draws a step
    assert binomial_kernel.LAUNCHES == 20 and tk.LAUNCHES == 0 and len(f.linked.graphs) == 1


@pytest.mark.parametrize("kernel", ["poisson", "binomial"])
def test_loop_kernel_launch_and_capture(card, kernel):
    """The Poisson and binomial kernels' draw, one cooperative launch
    counted, is the plain loops' draw, on the timed grid
    (``cases.LOOP_TYPICAL``) and, for binomial, the Gibbs chain's
    binomial(1, p) (phases B and C do nothing: the flag and N stay 0);
    captured into a CUDA graph it replays the same bits."""
    from pytensor_tpu_torch.link.cuda import binomial_kernel, loop_state, poisson_kernel

    mod = poisson_kernel if kernel == "poisson" else binomial_kernel
    key = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64, device=card)
    if kernel == "binomial":
        pairs = np.array(cases.LOOP_TYPICAL["binomial"], "float32")
        grids = {"typical": [torch.from_numpy(np.resize(pairs[:, j], 16384)).to(card)
                             for j in (0, 1)],
                 "gibbs": [torch.ones(15680, device=card),
                           torch.linspace(0.01, 0.99, 15680, device=card)]}
    else:
        grids = {"typical": [torch.from_numpy(np.resize(np.array(
            cases.LOOP_TYPICAL["poisson"], "float32"), 16384)).to(card)]}
    extra = (torch.int64,) if kernel == "binomial" else ()
    for tag, args in grids.items():
        want = mod.plain(key, *args, *extra)
        out = torch.empty(args[0].shape, dtype=torch.int64, device=card)
        state = torch.empty(loop_state.STATE_WORDS, dtype=torch.int32, device=card)
        before = mod.LAUNCHES
        mod.run(key, *args, out, state)
        torch.cuda.synchronize()
        assert mod.LAUNCHES == before + 1
        assert torch.equal(out, want), tag
        assert (int(state[loop_state.STATE_FLAG]) == 0) == (tag == "gibbs")
        assert (int(state[loop_state.STATE_N]) == 0) == (tag == "gibbs")
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            mod.launch(key, *args, *extra)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = mod.launch(key, *args, *extra)
        torch.cuda.current_stream().wait_stream(stream)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(replayed, want), tag


def test_pickled_function_relinks_on_the_card(card):
    """A function pickled with its shared value loads on the card it was
    made for, captures its own graph and launches K1 as the original does,
    with the original's bits; ``pkl_utils.load_function`` does the same
    from its zip."""
    import io
    import pickle

    import pytensor_tpu_torch as ptt
    from pytensor_tpu_torch.misc import pkl_utils

    (theta,), (logp, dlogp), n = make_radon_graphs(40, 5, "float32")
    scale = ptt.shared(np.float32(1.5), name="scale", device=card)
    f = ptt.function([theta], [logp * scale, dlogp], device=card)
    th = as_torch(theta_start(n, "float32"), card)
    want = f(th)
    want = f(th)  # a replay
    for g in (pickle.loads(pickle.dumps(f)), _zip_round_trip(f, pkl_utils, io)):
        assert g.device == f.device and g.shared_vars[0].device == card
        g(th)  # captures
        before = fused_kernel.LAUNCHES
        got = g(th)
        assert fused_kernel.LAUNCHES > before
        for a, b in zip(got, want):
            assert torch.equal(a, b)


def _zip_round_trip(f, pkl_utils, io):
    buf = io.BytesIO()
    pkl_utils.dump_function(f, buf)
    buf.seek(0)
    return pkl_utils.load_function(buf)


def test_a_copy_replays_its_own_shared_tensors(card):
    """A copy's CUDA graph reads and updates its own shared tensor: the
    original's graph, captured first, is never replayed with the copy's
    state, and each moves only its own."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt

    s = ptt.shared(np.arange(4, dtype="float32"), name="s", device=card)
    x = pt.tensor("x", dtype="float32", shape=(4,))
    f = ptt.function([x], pt.sum(s * x), updates={s: s * 2 + x}, device=card)
    ones = torch.ones(4, device=card)
    f(ones)
    f(ones)  # captured, then replayed
    g = f.copy()
    t = ptt.shared(np.full(4, 10, dtype="float32"), device=card)
    h = f.copy(swap={s: t})
    s_before = s.get_value()
    assert float(g(ones)) == float(s_before.sum())
    assert float(g(ones)) == float((s_before * 2 + 1).sum())
    assert float(h(ones)) == 40.0 and float(h(ones)) == 84.0
    assert torch.equal(s.get_value(), s_before)  # neither copy moved the original's
    assert torch.equal(t.get_value(), torch.full((4,), 43.0, device=card))
    assert type(g.linked).__name__ == "CapturedFunction" and g.linked is not f.linked


def _k1_nodes_match_plain(f, args, dtype):
    """Each FusedElemwise node of ``f``'s graph launched on the inputs the
    graph gives it, against its plain version."""
    from pytensor_tpu_torch.graph.fg import FunctionGraph as FG

    fg = f.maker.fgraph
    nodes = [nd for nd in fg.toposort() if isinstance(nd.op, FusedElemwise)]
    needed = [i for nd in nodes for i in nd.inputs]
    values = iter(fgraph_to_torch(FG(fg.inputs, needed, clone=False), args[0].device)(*args))
    for nd in nodes:
        ins = [next(values) for _ in nd.inputs]
        kern = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, args[0].device)
        for got, want in zip(kern.launch(*ins), kern.plain(*ins)):
            got, want = got.cpu(), want.cpu()  # a host value's plain result is on the host
            fin = torch.isfinite(want)
            np.testing.assert_array_equal(got[~fin].numpy(), want[~fin].numpy())
            assert _scaled(got[fin].double(), want[fin].double()) <= K1_RTOL[dtype], str(nd.op)
    return len(nodes)


@pytest.mark.parametrize("family", ["shape", "basic", "subtensor", "math"])
def test_rewrite_probe_graphs_on_the_card(card, family):
    """The probe graphs of ``link/cuda/rewrite_cases.py`` (side 64, float32)
    linked for the card: the ops of the same graph linked for the CPU, its
    values within K1's float32 tolerance of the CPU's (the products and
    sums at 1e-5 of max(1, max|cpu|)), each K1 node against its plain
    version."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.compile.mode import get_mode
    from pytensor_tpu_torch.link.cuda.rewrite_cases import CASES

    for case in [c for c in CASES if c.family == family]:
        vals = case.inputs(64, "float32")
        fs = {}
        for dev in (card, "cpu"):
            ins = [pt.tensor(f"x{k}", dtype=np.asarray(v).dtype, shape=(None,) * np.ndim(v))
                   for k, v in enumerate(vals)]
            fs[str(dev)] = ptt.function(ins, case.build(pt, 64, *ins),
                                        mode=get_mode(None).excluding(*case.exclude),
                                        device=dev)
        f, cpu = fs[str(card)], fs["cpu"]
        assert [type(n.op) for n in f.maker.fgraph.toposort()] == \
            [type(n.op) for n in cpu.maker.fgraph.toposort()], case.label
        args = [as_torch(v, card) for v in vals]
        got, want = f(*args).cpu(), cpu(*vals)
        assert got.dtype == want.dtype and got.shape == want.shape
        if got.dtype.is_floating_point:
            fin = torch.isfinite(want)
            np.testing.assert_array_equal(got[~fin].numpy(), want[~fin].numpy(), case.label)
            assert _scaled(got[fin].double(), want[fin].double()) <= 1e-5, case.label
        else:
            assert torch.equal(got, want), case.label
        _k1_nodes_match_plain(f, args, "float32")


def test_print_on_the_card_prints_once_a_call(card, capsys):
    """A plan holding ``Print`` runs eagerly on the card (``reads_back``)
    and prints the value once a call; the values are the CPU's."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.printing import Print

    x = pt.dvector("x")
    y = Print("y")(pt.exp(x) * 2)
    f = ptt.function([x], [y.sum(), y + 1], device=card)
    assert not isinstance(f.linked, CapturedFunction)
    assert any("Print" in r for r in f.linked.host_reads)
    v = np.array([0.0, 1.0])
    for _ in range(3):
        s, t = f(as_torch(v, card))
    out = capsys.readouterr().out
    assert out.count("y [") == 3 and out.splitlines()[0] == f"y {np.exp(v) * 2}"
    assert abs(float(s) - float((np.exp(v) * 2).sum())) <= 1e-15 * 8


def test_check_blas_on_the_card(card):
    from pytensor_tpu_torch.misc.check_blas import execute

    for dtype in ("float32", "bfloat16"):
        assert execute(N=512, iters=3, dtype=dtype, verbose=False, device=card) > 0


# --- control and debug ops -------------------------------------------------------------

def _guarded(card, asserts, conditional, n_obs=50, n_counties=6):
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.models.radon import guarded_graphs

    ins, outs, n, y = guarded_graphs(ptt, pt, n_obs, n_counties, "float64", asserts=asserts,
                                     conditional=conditional)
    return ptt.function(ins, outs, device=card), n, y


def test_deferred_assert_flag_captures_and_raises(card):
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.models.radon import DATA_MESSAGE

    torch.use_deterministic_algorithms(True, warn_only=True)  # dlogp's index_add_
    try:
        fa, n, y = _guarded(card, asserts=True, conditional=False)
        fu, _, _ = _guarded(card, asserts=False, conditional=False)
        assert isinstance(fa.linked, CapturedFunction) and fa.linked.plan.owns_checks
        th = as_torch(theta_start(n, "float64"), card)
        y_d = as_torch(y, card)
        first = fa(th, y_d)
        for _ in range(2):  # a replay after the capture
            got = fa(th, y_d)
            assert all(torch.equal(a, b) for a, b in zip(got, fu(th, y_d)))
            assert all(torch.equal(a, b) for a, b in zip(got, first))
        bad = y.copy()
        bad[3] = np.nan
        with pytest.raises(AssertionError, match=DATA_MESSAGE):
            fa(th, as_torch(bad, card))
        assert all(torch.equal(a, b) for a, b in zip(fa(th, y_d), first))  # flags zeroed
    finally:
        torch.use_deterministic_algorithms(False)


@pytest.mark.parametrize("solver", ["minimize", "root"])
def test_assert_in_an_optimizer_objective_raises_on_the_card(card, solver):
    """A data assert inside BFGS's or Newton's objective raises on the card
    as on the CPU: the inner plans write into the outer plan's flags."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.raise_op import Assert
    from pytensor_tpu_torch.tensor.optimize import minimize, root

    x, d = pt.dvector("x"), pt.dvector("d")
    target = Assert("the data must be finite")(d, pt.all(pt.isfinite(d)))
    if solver == "minimize":
        (x_star, _), _ = minimize(pt.sum((x - target) ** 2), x)
    else:
        (x_star, _), _ = root(x - target, x)
    data = np.array([1.0, -2.0, 3.0])
    bad = data.copy()
    bad[1] = np.nan
    for device in ("cpu", card):
        f = ptt.function([x, d], x_star, device=device)
        np.testing.assert_allclose(np.asarray(f(np.zeros(3), data).cpu()), data, rtol=1e-6)
        with pytest.raises(AssertionError, match="the data must be finite"):
            f(np.zeros(3), bad)


def _condition_k1(f):
    """The fused nodes computing ``f``'s ``IfElse`` condition and its
    asserts' conditions (``isfinite`` fuses into one K1 node each)."""
    from pytensor_tpu_torch.graph.traversal import applys_between
    from pytensor_tpu_torch.ifelse import IfElse
    from pytensor_tpu_torch.raise_op import CheckAndRaise

    conds = [c for nd in f.fgraph.apply_nodes for c in (
        nd.inputs[:1] if isinstance(nd.op, IfElse)
        else nd.inputs[1:] if isinstance(nd.op, CheckAndRaise) else [])]
    fused = [nd for nd in applys_between(f.fgraph.inputs, conds)
             if isinstance(nd.op, FusedElemwise)]
    return len(fused)


def test_lazy_ifelse_launches_nothing_of_the_untaken_branch(card):
    fg, n, y = _guarded(card, asserts=True, conditional=True)
    fu, _, _ = _guarded(card, asserts=False, conditional=False)
    th = as_torch(theta_start(n, "float64"), card)
    y_d = as_torch(y, card)
    torch.use_deterministic_algorithms(True, warn_only=True)  # dlogp's index_add_
    try:
        fu(th, y_d)
        fused_kernel.LAUNCHES = 0
        want = fu(th, y_d)
        k1 = fused_kernel.LAUNCHES
        fused_kernel.LAUNCHES = 0
        got = fg(th, y_d)
        torch.cuda.synchronize()
    finally:
        torch.use_deterministic_algorithms(False)
    assert _condition_k1(fg) == 2 and fused_kernel.LAUNCHES == k1 + 2 and k1 > 0
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    bad = th.clone()
    bad[0] = float("nan")
    fused_kernel.LAUNCHES = 0
    lp, g = fg(bad, y_d)
    torch.cuda.synchronize()
    # the IfElse's condition alone runs: one fused isfinite node
    assert fused_kernel.LAUNCHES == 1 and float(lp) == -np.inf and not bool(g.any())


def test_debug_mode_holds_every_k1_node_on_the_card(card):
    import pytensor_tpu_torch as ptt
    from pytensor_tpu_torch.compile.debug import DebugMode

    ins, outs, n = make_radon_graphs(50, 6, "float64")
    f = ptt.function(ins, outs, mode=DebugMode(), device=card)
    fused_kernel.LAUNCHES = 0
    lp, g = f(as_torch(theta_start(n, "float64"), card))
    torch.cuda.synchronize()
    k1 = [(how, err) for nd, how, err in f.linked.holds if isinstance(nd.op, FusedElemwise)]
    assert k1 and fused_kernel.LAUNCHES == len(k1)
    assert all(how == "the CPU lowering" and err <= 1e-10 for how, err in k1)
    ins, outs, n = make_radon_graphs(50, 6, "float64")
    want = ptt.function(ins, outs, device="cpu")(theta_start(n, "float64"))
    for got, w in zip((lp, g), want):
        w = w.numpy()
        assert np.max(np.abs(got.cpu().numpy() - w) / np.maximum(1.0, np.abs(w))) <= 1e-12


def test_inner_function_defaults_to_the_card(card):
    from pytensor_tpu_torch.compile.inner_function import HasInnerFunction
    import pytensor_tpu_torch.tensor as pt

    class Inner(HasInnerFunction):
        def __init__(self, fgraph):
            self.fgraph = fgraph

    x = pt.dvector("x")
    op = Inner(FunctionGraph([x], [pt.exp(x) * 1.0]))
    fn = op.fn()
    assert fn.device.type == "cuda" and fn is op.fn(card)
    (out,) = fn(np.zeros(2))
    np.testing.assert_array_equal(out.cpu().numpy(), np.ones(2))

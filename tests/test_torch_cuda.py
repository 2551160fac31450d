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
``tests/test_torch_sparse.py`` holds them.
"""

import numpy as np
import pytest
import torch

from pytensor_tpu_torch.compile.mode import FAST_RUN
from pytensor_tpu_torch.graph.fg import FunctionGraph
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

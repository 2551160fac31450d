"""K2's generated CUDA source, run on the CPU under a host emulation.

There is no nvcc here, so K2 cannot be compiled for the card; but its
generated source is C++ apart from a few CUDA features.  With
``tests/k2_host.h`` in place of ``<cuda_runtime.h>`` (one block of
``std::thread``s, ``__syncthreads()`` and ``__syncthreads_or()`` as
barriers, warp shuffles through a per-warp buffer, the dynamic shared
memory as a per-launch buffer of garbage, ``clock64()``), g++ compiles
the source and runs it on CPU tensors.  So the emitter's index
arithmetic, its barrier placement, its slot reuse, its runs and its
reductions are held here against the plain step loop, with real threads
racing wherever a barrier is missing.  What this cannot show is that
nvcc accepts the source, or the card's rounding: ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` show those on the card.  Tolerance: 1e-6 of
``max(1, max|loop|)``, float32 summed in other orders.  Libraries go to
the gitignored ``build/k2_host/``.
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

import pytensor_tpu_torch as ptt
import pytensor_tpu_torch.tensor as pt
from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.link.cuda.scan_kernel import (
    STAMP_FROM,
    STAMP_STEPS,
    ScanKernelSource,
    scan_kernel_eligible,
)
from pytensor_tpu_torch.link.torch.convert import torch_dtype
from pytensor_tpu_torch.link.torch.dispatch import scan_loop
from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch
from pytensor_tpu_torch.tensor.basic import Alloc, MakeVector

BUILD = Path(__file__).resolve().parents[1] / "build" / "k2_host"
HEADER = Path(__file__).resolve().parent / "k2_host.h"
LAUNCH = "k2_kernel<<<1, K2_THREADS, K2_SMEM, (cudaStream_t)stream>>>(a);"
TOL = 1e-6


@pytest.fixture(scope="module")
def gxx():
    found = shutil.which("g++")
    if found is None:
        pytest.skip("needs g++ to compile K2's source for the host")
    return found


def _host_library(gxx, source):
    assert LAUNCH in source
    src = source.replace("#include <cuda_runtime.h>", f'#include "{HEADER}"')
    src = src.replace(LAUNCH, "k2_host_launch(K2_THREADS, K2_SMEM, [&] { k2_kernel(a); });")
    key = hashlib.sha256(src.encode()).hexdigest()[:16]
    lib = BUILD / f"libk2_host_{key}.so"
    if not lib.exists():
        BUILD.mkdir(parents=True, exist_ok=True)
        cpp = BUILD / f"k2_host_{key}.{os.getpid()}.cpp"
        cpp.write_text(src)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        proc = subprocess.run([gxx, "-std=c++20", "-O1", "-w", "-shared", "-fPIC", "-pthread",
                               "-o", str(tmp), str(cpp)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr[:4000]
        os.replace(tmp, lib)
    handle = ctypes.CDLL(str(lib))
    handle.k2_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
    handle.k2_launch.restype = ctypes.c_int
    return handle


def _fused(op):
    """The same Scan with the fusion pass run on a copy of its inner graph
    (the rewrite pipeline keeps fusion out of inner graphs; a hand-built
    Scan may still hold FusedElemwise nodes)."""
    from pytensor_tpu_torch.compile.mode import fusedb
    from pytensor_tpu_torch.graph.rewriting.db import RewriteDatabaseQuery
    from pytensor_tpu_torch.scan.op import Scan
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    new = Scan(op.fgraph.clone(), op.info, name=op.name)
    fusedb.query(RewriteDatabaseQuery(include=["fast_run"])).rewrite(new.fgraph)
    assert any(isinstance(n.op, FusedElemwise) for n in new.fgraph.apply_nodes)
    return new


def _emulated_vs_loop(gxx, f, values, fuse_inner=False, stamps=None):
    """Run f's Scan node as K2 under the emulation and as the step loop,
    on the outer inputs the graph gives it; returns the two output lists.
    With ``stamps`` (a list), the stamped source runs and appends its
    stamp buffer and labels."""
    (node,) = [nd for nd in f.fgraph.apply_nodes if type(nd.op).__name__ == "Scan"]
    op = _fused(node.op) if fuse_inner else node.op
    assert scan_kernel_eligible(op, node)
    feed = fgraph_to_torch(FunctionGraph(f.fgraph.inputs, node.inputs, clone=False), "cpu")
    n_steps, *outer = feed(*[torch.as_tensor(np.asarray(v)) for v in values])
    src = ScanKernelSource(op, node, stamps=stamps is not None)
    T = int(n_steps)

    def empty(v, lead=()):
        return torch.empty((*lead, *v.type.shape), dtype=torch_dtype(v.type.dtype))

    ins = [t.contiguous() for t in outer]
    outs = ([empty(v, (T,)) for v in src.state_outs] + [empty(v) for v in src.unt_outs]
            + [empty(v, (T,)) for v in src.nit_outs])
    # a scratch arena of garbage: every slot is written before it is read
    scratch = torch.full((src.arena if src.placement == "device" else 16,), 0xAB,
                         dtype=torch.uint8)
    consts = torch.frombuffer(bytearray(src.const_bytes), dtype=torch.uint8)
    ptrs = [t.data_ptr() for t in ins + outs] + [scratch.data_ptr(), consts.data_ptr()]
    if stamps is not None:
        buf = torch.zeros((STAMP_STEPS, len(src.stamp_labels)), dtype=torch.int64)
        ptrs.append(buf.data_ptr())
        stamps += [buf, src.stamp_labels]
    lib = _host_library(gxx, src.source)
    assert lib.k2_launch((ctypes.c_ulonglong * len(ptrs))(*ptrs), T, None) == 0
    return outs, scan_loop(op, "cpu")(n_steps, *outer)


class _Raw:
    """The graph of a scan as built, unrewritten, in the place of a
    function's (``_emulated_vs_loop`` reads ``fgraph``)."""

    def __init__(self, inputs, outputs):
        self.fgraph = FunctionGraph(inputs, outputs, clone=True)


def _check(gxx, build, values, fuse_inner=False, raw=False):
    with config.change_flags(scan__pallas=True):
        inputs, outputs = build()
        f = (_Raw(inputs, outputs) if raw
             else ptt.function(inputs, outputs, device="cpu"))
    got, want = _emulated_vs_loop(gxx, f, values, fuse_inner)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        scale = max(1.0, float(w.abs().max())) if w.numel() else 1.0
        assert float((g - w).abs().max() if w.numel() else 0.0) <= TOL * scale


def _scalar_carry():
    z = pt.tensor("z", dtype="float32", shape=())
    tr, _ = ptt.scan(lambda acc: acc * np.float32(1.1) + np.float32(0.5), outputs_info=[z],
                     n_steps=6)
    return [z], tr


def _vector_state_and_nitsot():
    v0 = pt.tensor("v0", dtype="float32", shape=(4,))
    (tr, sq), _ = ptt.scan(lambda acc: (acc + np.float32(1.0), (acc ** 2).sum()),
                           outputs_info=[v0, None], n_steps=3)
    return [v0], [tr, sq]


def _tanh_dot():
    v0 = pt.tensor("v0", dtype="float32", shape=(5,))
    W = pt.as_tensor_variable((np.eye(5) * 0.9 + 0.01).astype("float32"))
    tr, _ = ptt.scan(lambda acc: pt.tanh(pt.dot(W, acc)) + np.float32(0.01),
                     outputs_info=[v0], n_steps=10)
    return [v0], tr


def _sequences():
    x = pt.tensor("x", dtype="float32", shape=(4, 3))
    tr, _ = ptt.scan(lambda xt, acc: acc * np.float32(0.5) + xt, sequences=[x],
                     outputs_info=[pt.constant(np.zeros(3, "float32"))])
    return [x], tr


def _every_op():
    """A body with every op family K2 emits: the three reduction shapes
    (warp, thread and block), both Dot strategies, strided and reversed
    Subtensor copies, a stepped IncSubtensor with a broadcast update, a
    transposing DimShuffle, Alloc, MakeVector, casts through int32, and
    sigmoid/tanh/maximum/sin."""
    M0 = pt.tensor("M0", dtype="float32", shape=(6, 40))

    def step(M):
        r1 = pt.sum(M, axis=1)
        r0 = pt.sum(M, axis=0)
        tot = pt.sum(M)
        d1 = pt.dot(M, r0 * np.float32(0.01))
        d2 = pt.dot(r1 * np.float32(0.01), M)
        sub = M[::-2, 1:30:3]
        inc = pt.inc_subtensor(M[1:5:2, 3:40:4], sub[:2, :1] * np.float32(0.5))
        ints = pt.cast(pt.cast(M * np.float32(10.0), "int32") * 3, "float32")
        new = (inc * np.float32(0.5) + pt.tanh(d1).dimshuffle(0, "x")
               + pt.sigmoid(d2).dimshuffle("x", 0) * np.float32(0.1)
               + Alloc()(tot, 6, 40) * np.float32(0.001)
               + pt.maximum(M, -M) * np.float32(0.1) + ints * np.float32(0.001)
               + pt.sin(pt.transpose(M)).T * np.float32(0.01))
        vec = MakeVector("float32")(tot, r1[0], d1[2])
        return new, sub.sum() + vec.sum(), pt.transpose(M)[3]

    (tr, s, col), _ = ptt.scan(step, outputs_info=[M0, None, None], n_steps=3)
    return [M0], [tr, s, col]


def _abs_max():
    """abs (float32 and int32) and Max in each reduction shape K2 emits:
    one warp per row (axis 1), one thread per column (axis 0) and the
    block (all): the normalisation of the power iteration."""
    M0 = pt.tensor("M0", dtype="float32", shape=(6, 40))

    def step(M):
        a = pt.abs(M)
        top = pt.max(a)
        ia = pt.cast(pt.abs(pt.cast(M * np.float32(10.0), "int32")), "float32")
        new = (M / (top + np.float32(1e-9)) * np.float32(1.5)
               + pt.max(a, axis=1).dimshuffle(0, "x") * np.float32(0.01)
               - pt.max(M, axis=0).dimshuffle("x", 0) * np.float32(0.01)
               + ia * np.float32(0.001))
        return new, top

    (tr, top), _ = ptt.scan(step, outputs_info=[M0, None], n_steps=4)
    return [M0], [tr, top]


def _blas_products():
    """Dot22 on the thread and the warp path, Gemm and Dot22Scalar, each
    product an FMA loop, the epilogues rounded op by op."""
    from pytensor_tpu_torch.tensor import blas

    M0 = pt.tensor("M0", dtype="float32", shape=(4, 6))
    v0 = pt.tensor("v0", dtype="float32", shape=(300,))
    rng = np.random.default_rng(3)
    W = pt.as_tensor_variable((rng.standard_normal((6, 6)) * 0.3).astype("float32"))
    A = pt.as_tensor_variable((rng.standard_normal((2, 300)) * 0.1).astype("float32"))
    B = pt.as_tensor_variable((rng.standard_normal((300, 3)) * 0.1).astype("float32"))

    def step(M, v):
        d = blas._dot22(M, W)
        g = blas.gemm(M, np.float32(0.5), M, W, np.float32(0.25))
        s = blas._dot22scalar(M, W, np.float32(0.1))
        wide = blas._dot22(A * v.dimshuffle("x", 0), B)  # 6 outputs of 300 terms: a warp each
        return pt.tanh(d * np.float32(0.1) + g * np.float32(0.1) + s), v * np.float32(0.9), \
            wide.sum()

    (trM, trv, sw), _ = ptt.scan(step, outputs_info=[M0, v0, None], n_steps=4)
    return [M0, v0], [trM, trv, sw]


def _static_split(x, sizes, axis):
    """A Split whose outputs have static types.  ``Split.make_node`` leaves
    the split axis's length unknown, in both packages, so a scan whose
    body holds a Split takes the step loop there; these types stand for a
    body whose lengths are known."""
    from pytensor_tpu_torch.graph.basic import Apply
    from pytensor_tpu_torch.tensor.basic import Split, constant
    from pytensor_tpu_torch.tensor.type import TensorType

    outs = []
    for n in sizes:
        shape = list(x.type.shape)
        shape[axis] = n
        outs.append(TensorType(x.type.dtype, tuple(shape))())
    node = Apply(Split(len(sizes)), [x, constant(np.int64(axis)),
                                     constant(np.asarray(sizes, "int64"))], outs)
    return node.outputs


def _join_split_arange():
    """Join and Split along both axes (a view and a strided copy), ARange
    of floats and ints as index arithmetic, DeepCopyOp and ViewOp as
    aliases.  Run on the Scan node as built (``RAW``): the rewrites would
    fold the constant ARanges."""
    from pytensor_tpu_torch.compile.ops import deep_copy_op, view_op
    from pytensor_tpu_torch.tensor.basic import ARange

    v0 = pt.tensor("v0", dtype="float32", shape=(6,))
    M0 = pt.tensor("M0", dtype="float32", shape=(3, 4))
    ax0, ax1 = np.int64(0), np.int64(1)

    def step(v, M):
        a, b = _static_split(v, [2, 4], 0)
        j = pt.join(ax0, b, a)
        p, q = _static_split(M, [1, 3], 1)
        jm = pt.join(ax1, q * np.float32(0.5), p)
        r = ARange("float32")(np.float32(0.5), np.float32(3.5), np.float32(0.5))
        ri = pt.cast(ARange("int64")(np.int64(-5), np.int64(13), np.int64(3)), "float32")
        top, bottom = _static_split(M, [2, 1], 0)
        jr = pt.join(ax0, bottom, top)
        return (deep_copy_op(j) * np.float32(0.5) + r * np.float32(0.1) + ri * np.float32(0.01),
                view_op(jm + jr * np.float32(0.25)))

    (trv, trM), _ = ptt.scan(step, outputs_info=[v0, M0], n_steps=3)
    return [v0, M0], [trv, trM]


RAW = {"join_split_arange"}


def _new_scalar_ops():
    """The scalar ops of this slice in a scan body: selection, rounding,
    exponentials, trigonometry, integer division and shifts, bitwise ops
    and comparisons, in float32, int32 and bool."""
    x0 = pt.tensor("x0", dtype="float32", shape=(16,))
    k0 = pt.tensor("k0", dtype="int32", shape=(16,))

    def step(x, k):
        c = pt.gt(x, np.float32(0.0))
        y = pt.switch(c, pt.expm1(x * np.float32(0.1)), pt.log1p(pt.abs(x)))
        y = y + pt.floor(x) * np.float32(0.01) + pt.ceil(x) * np.float32(0.01) \
            + pt.trunc(x) * np.float32(0.01) + pt.round_half_to_even(x * np.float32(2.0)) \
            * np.float32(0.01) + pt.round_half_away_from_zero(x * np.float32(2.0)) * np.float32(0.01)
        y = y + pt.clip(x, np.float32(-0.5), np.float32(0.5)) + pt.minimum(x, np.float32(0.2))
        y = y + pt.arctan2(x, np.float32(1.5)) * np.float32(0.1) + pt.tan(x * np.float32(0.1)) \
            + pt.cosh(x * np.float32(0.1)) * np.float32(0.01) + pt.sinh(x * np.float32(0.1))
        y = y + pt.exp2(x * np.float32(0.1)) * np.float32(0.01) + pt.log2(pt.abs(x) + 1) \
            * np.float32(0.01) + pt.log10(pt.abs(x) + 1) * np.float32(0.01)
        y = y + pt.deg2rad(x) + pt.rad2deg(x) * np.float32(0.001) \
            + pt.arcsinh(x) * np.float32(0.01) + pt.arctan(x) * np.float32(0.01)
        y = y + pt.cast(pt.and_(pt.le(x, np.float32(1.0)), pt.neq(x, np.float32(0.0))),
                        "float32") * np.float32(0.01)
        kn = (pt.int_div(k * 7 - 40, 3) + pt.mod(k * 5 - 17, 6) + pt.left_shift(k, 2)
              - pt.right_shift(k * 16, k % 35) + pt.xor(k, 5) + pt.or_(k, 1) - pt.invert(k))
        kn = pt.switch(pt.isnan(y), 0, pt.mod(kn, 97))
        return y * np.float32(0.5), pt.cast(kn, "int32")

    (tx, tk), _ = ptt.scan(step, outputs_info=[x0, k0], n_steps=4)
    return [x0, k0], [tx, tk]


CASES = {
    "blas_products": (_blas_products, [
        np.random.default_rng(4).standard_normal((4, 6)).astype("float32"),
        np.random.default_rng(5).standard_normal(300).astype("float32")]),
    "join_split_arange": (_join_split_arange, [
        np.arange(6, dtype="float32"), np.arange(12, dtype="float32").reshape(3, 4)]),
    "new_scalar_ops": (_new_scalar_ops, [
        np.concatenate([[0.5, -0.5, 1.5, -2.5, 0.0, -0.0, 2.5, 0.49999997],
                        np.random.default_rng(6).standard_normal(8) * 3]).astype("float32"),
        np.arange(-8, 8, dtype="int32")]),
    "abs_max": (_abs_max, [np.random.default_rng(2).standard_normal((6, 40))
                           .astype("float32")]),
    "scalar_carry": (_scalar_carry, [np.float32(1.0)]),
    "vector_state_and_nitsot": (_vector_state_and_nitsot, [np.arange(4, dtype="float32")]),
    "tanh_dot": (_tanh_dot, [np.random.default_rng(0).standard_normal(5).astype("float32")]),
    "sequences": (_sequences, [np.arange(12, dtype="float32").reshape(4, 3)]),
    "every_op": (_every_op, [np.random.default_rng(1).standard_normal((6, 40))
                             .astype("float32")]),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_emulated_k2_matches_loop(gxx, case):
    build, values = CASES[case]
    _check(gxx, build, values, raw=case in RAW)


def test_k2_emits_the_jax_whitelist_ops():
    """Each op of the JAX package's kernel whitelist (scan_pallas.py:40)
    that the port has is emitted: the scans above are eligible, and their
    sources hold the product loops and no library call."""
    for case in ("blas_products", "join_split_arange", "new_scalar_ops"):
        with config.change_flags(scan__pallas=True):
            inputs, outputs = CASES[case][0]()
            f = (_Raw(inputs, outputs) if case in RAW
                 else ptt.function(inputs, outputs, device="cpu"))
        (node,) = [nd for nd in f.fgraph.apply_nodes if type(nd.op).__name__ == "Scan"]
        names = {type(n.op).__name__ for n in node.op.fgraph.apply_nodes}
        assert scan_kernel_eligible(node.op, node), (case, names)
        src = ScanKernelSource(node.op, node).source
        if case == "blas_products":
            assert {"Dot22", "Gemm", "Dot22Scalar"} <= names
            assert src.count("fmaf(") >= 3 and "k2_warp_add(acc)" in src
        if case == "join_split_arange":
            assert {"Join", "Split", "ARange", "DeepCopyOp", "ViewOp"} <= names


def test_k2_budget_refuses_a_full_width_product_and_keeps_the_chains():
    """The JAX package's 4 MiB budget (scan_pallas.py:86-98): a scan over a
    full-width (8,192 x 8,192) float32 weight takes the step loop, as it
    does in the JAX package, though its offsets fit 32 bits; the radon
    leapfrog chain at full width and benchsuite's cumsum and EWMA scans at
    n = 4,096 take the kernel."""
    from pytensor_tpu_torch.link.cuda.scan_kernel import BUDGET_BYTES, _budget_bytes
    from pytensor_tpu_torch.models.radon import make_leapfrog_chain
    from pytensor_tpu_torch.scan.op import Scan

    def scan_node(out):
        out = out[0] if isinstance(out, (list, tuple)) else out
        while not isinstance(out.owner.op, Scan):
            out = out.owner.inputs[0]
        return out.owner

    x0 = pt.tensor("x0", dtype="float32", shape=(8192, 8192))
    W = pt.tensor("W", dtype="float32", shape=(8192, 8192))
    tr, _ = ptt.scan(lambda x, w: pt.dot(x, w), outputs_info=[x0], non_sequences=[W],
                     n_steps=4)
    node = scan_node(tr)
    assert _budget_bytes(node.op, node) > BUDGET_BYTES
    assert not scan_kernel_eligible(node.op, node)
    # the models' own loops at full width, built on the meta device (no
    # memory): the GEMM chain and the MFU step's train_loop take the step loop
    from pytensor_tpu_torch.models.mlp import make_gemm_chain, make_mlp_mfu_step

    with config.change_flags(scan__pallas=True):
        loops = [make_gemm_chain(dtype="float32", n_steps_per_call=4, device="meta")[0],
                 make_mlp_mfu_step(dtype="float32", n_steps_per_call=4, device="meta")[0]]
    for f in loops:
        (node,) = [nd for nd in f.fgraph.apply_nodes if isinstance(nd.op, Scan)]
        assert not scan_kernel_eligible(node.op, node)
    f = make_leapfrog_chain("float32", None, 8, 919, 85, device="cpu")
    (node,) = [nd for nd in f.fgraph.apply_nodes if isinstance(nd.op, Scan)]
    assert scan_kernel_eligible(node.op, node)
    x = pt.tensor("x", dtype="float32", shape=(4096,))
    zero = pt.constant(0.0, dtype="float32")
    for body in (lambda xt, acc: acc + xt,
                 lambda xt, acc: np.float32(0.98) * acc + np.float32(0.02) * xt):
        tr, _ = ptt.scan(body, sequences=[x], outputs_info=[zero])
        node = scan_node(tr)
        assert scan_kernel_eligible(node.op, node)


def test_k2_radon_chain_source_keeps_its_sha256():
    """chip_smoke.py's chain holds are calibrated on K2's bits: the source
    of the full-width radon body keeps the sha256 they were calibrated on."""
    from pytensor_tpu_torch.models.radon import make_leapfrog_chain

    f = make_leapfrog_chain("float32", None, 64, 919, 85, device="cpu")
    (node,) = [nd for nd in f.fgraph.apply_nodes if type(nd.op).__name__ == "Scan"]
    digest = hashlib.sha256(ScanKernelSource(node.op, node).source.encode()).hexdigest()
    assert digest == "fac11e834075ed385020492fb9e0ea46b1bbffe3cd879d1e1f3fa8e3f5938c2e"


def test_emulated_k2_flattens_fused_elemwise(gxx):
    """A FusedElemwise in the inner graph (an op of the JAX package's
    whitelist) is emitted as its inner nodes."""
    build, values = CASES["every_op"]
    _check(gxx, build, values, fuse_inner=True)


def test_emulated_k2_leapfrog_chain_matches_loop(gxx):
    """The radon leapfrog body (40 observations, 5 counties, 4 steps)."""
    from pytensor_tpu_torch.models.radon import make_leapfrog_chain, theta_start

    f = make_leapfrog_chain("float32", None, 4, 40, 5, device="cpu")
    th = theta_start(9, "float32")
    m = np.random.default_rng(0).standard_normal(9).astype("float32")
    got, want = _emulated_vs_loop(gxx, f, [th, m])
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= TOL * max(1.0, float(w.abs().max()))


def test_emulated_k2_stamped_source(gxx):
    """The stamped variant (chip_smoke.py's breakdown by op) computes the
    same bits, and thread 0 stamps every op and barrier of steps
    STAMP_FROM.. in order; the other steps leave the buffer alone."""
    from pytensor_tpu_torch.models.radon import make_leapfrog_chain, theta_start

    f = make_leapfrog_chain("float32", None, STAMP_FROM + STAMP_STEPS + 2, 40, 5, device="cpu")
    th = theta_start(9, "float32")
    m = np.random.default_rng(0).standard_normal(9).astype("float32")
    got, _ = _emulated_vs_loop(gxx, f, [th, m])
    stamps = []
    got_s, _ = _emulated_vs_loop(gxx, f, [th, m], stamps=stamps)
    assert all(torch.equal(a, b) for a, b in zip(got, got_s))
    buf, labels = stamps
    classes = {c for c, _ in labels}
    assert labels[0] == ("start", "step start")
    assert {"barrier", "end_of_step", "careduce", "elemwise_0d", "elemwise_vec"} <= classes
    assert bool((buf > 0).all()) and bool((buf.diff(dim=1) >= 0).all())


# --- the redesign: one-hot products, placement, merged runs ------------------------

def _onehot_matrix(rows, cols, seed):
    idx = np.random.default_rng(seed).integers(0, cols, size=rows)
    idx[:cols] = np.arange(cols)  # every column has a row
    M = np.zeros((rows, cols), dtype="float32")
    M[np.arange(rows), idx] = 1.0
    return M


# (the Dot of the body, the operand's length) for a (50, 7) one-hot C,
# whose rows each hold one 1: both directions, each with C and with C.T
_ONEHOT_DOTS = {
    "gather": (lambda C, v: pt.dot(pt.as_tensor_variable(C), v), 7),
    "segsum": (lambda C, v: pt.dot(v[None, :], pt.as_tensor_variable(C)), 50),
    "gather_ct": (lambda C, v: pt.dot(v, pt.as_tensor_variable(np.ascontiguousarray(C.T))), 7),
    "segsum_ct": (lambda C, v: pt.dot(pt.as_tensor_variable(np.ascontiguousarray(C.T)), v), 50),
}


def _onehot_values(n, kind):
    """Small integers (every sum exact in float32, so any order gives the
    same bits), with a -0.0 or an inf where asked."""
    v = np.random.default_rng(4).integers(-8, 9, size=n).astype("float32")
    if kind == "negzero":
        v[3] = -0.0
    elif kind == "inf":
        v[2] = np.inf
    return v


@pytest.mark.parametrize("kind", ["finite", "negzero", "inf"])
@pytest.mark.parametrize("direction", sorted(_ONEHOT_DOTS))
def test_emulated_k2_onehot_dot_matches_loop(gxx, direction, kind):
    """A Dot against a one-hot constant is emitted as index loads (the
    matrix leaves the constants) and gives the step loop's bits: exactly
    for finite operands, +0.0 for a -0.0, and NaN where an inf meets a 0
    (an inf itself where it meets its 1)."""
    C = _onehot_matrix(50, 7, 5)
    dot, n = _ONEHOT_DOTS[direction]
    v0 = pt.tensor("v0", dtype="float32", shape=(n,))
    with config.change_flags(scan__pallas=True):
        (tr, y), _ = ptt.scan(lambda v: (v * np.float32(0.5), dot(C, v)),
                              outputs_info=[v0, None], n_steps=3)
        f = ptt.function([v0], [tr, y], device="cpu")
    (node,) = [nd for nd in f.fgraph.apply_nodes if type(nd.op).__name__ == "Scan"]
    src = ScanKernelSource(node.op, node)
    assert len(src.const_bytes) < C.nbytes
    got, want = _emulated_vs_loop(gxx, f, [_onehot_values(n, kind)])
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        assert torch.equal(g.isnan(), w.isnan())
        assert torch.equal(torch.nan_to_num(g, nan=7.0), torch.nan_to_num(w, nan=7.0))
        assert torch.equal(torch.signbit(g[~g.isnan()]), torch.signbit(w[~w.isnan()]))
    if kind == "inf":
        assert bool(got[1].isnan().any()) and bool(got[1].isinf().any() or "segsum" in direction)


def test_emulated_k2_device_placement(gxx):
    """A body whose arena exceeds the shared memory a block may use keeps
    its slots in device memory, and still runs."""
    from pytensor_tpu_torch.link.cuda.scan_kernel import SMEM_LIMIT

    n = 40000  # two 160 KB halves of the carried state
    v0 = pt.tensor("v0", dtype="float32", shape=(n,))

    def build():
        (tr, s), _ = ptt.scan(lambda v: (v * np.float32(0.5) + np.float32(1.0), v.sum()),
                              outputs_info=[v0, None], n_steps=3)
        return [v0], [tr, s]

    with config.change_flags(scan__pallas=True):
        inputs, outputs = build()
        f = ptt.function(inputs, outputs, device="cpu")
    (node,) = [nd for nd in f.fgraph.apply_nodes if type(nd.op).__name__ == "Scan"]
    src = ScanKernelSource(node.op, node)
    assert src.placement == "device" and src.arena > SMEM_LIMIT
    assert src.smem_bytes <= SMEM_LIMIT
    _check(gxx, build, [np.random.default_rng(6).standard_normal(n).astype("float32")])


def test_emulated_k2_merged_run_read_across_a_barrier(gxx):
    """A run of element-wise ops keeps its values in registers; the one
    that another thread reads (reversed) gets a slot and a barrier."""
    v0 = pt.tensor("v0", dtype="float32", shape=(40,))

    def build():
        def step(v):
            w = pt.tanh(v * np.float32(0.5)) + np.float32(0.1)
            return w[::-1] * np.float32(0.9) + w * np.float32(0.05)

        tr, _ = ptt.scan(step, outputs_info=[v0], n_steps=4)
        return [v0], tr

    with config.change_flags(scan__pallas=True):
        inputs, outputs = build()
        f = ptt.function(inputs, outputs, device="cpu")
    (node,) = [nd for nd in f.fgraph.apply_nodes if type(nd.op).__name__ == "Scan"]
    src = ScanKernelSource(node.op, node)
    assert src.n_ops < src.n_units and src.placement == "shared"
    assert "__syncthreads();" in src.source.split("for (long long t")[1]
    _check(gxx, build, [np.random.default_rng(7).standard_normal(40).astype("float32")])


def test_k2_radon_body_source_at_full_width():
    """The radon leapfrog body at 919 observations and 85 counties: the
    four one-hot products are index loads and segment sums (no loop of 85
    or 919 multiply-adds over the one-hot constant remains), the constants
    are a few KB, the arena sits in shared memory, and the step has fewer
    loops and barriers than one per op (131 and 26)."""
    from pytensor_tpu_torch.link.cuda.scan_kernel import SMEM_LIMIT
    from pytensor_tpu_torch.models.radon import make_leapfrog_chain

    f = make_leapfrog_chain("float32", None, 4, 919, 85, device="cpu")
    (node,) = [nd for nd in f.fgraph.apply_nodes if type(nd.op).__name__ == "Scan"]
    src = ScanKernelSource(node.op, node)
    body = src.source.split("for (long long t")[1]
    assert "fmaf(" not in body and "k < 85" not in body and "k < 919" not in body
    # two gathers and two segment sums, the sums a warp a county as the
    # plain Dot would sum them
    assert body.count("__syncthreads_or(") == 4 and body.count("k2_warp_add(acc[r])") == 2
    assert len(src.const_bytes) < 16 * 1024
    assert src.placement == "shared" and src.arena + len(src.const_bytes) < SMEM_LIMIT
    assert src.smem_bytes <= SMEM_LIMIT and src.smem_const_bytes == len(src.const_bytes)
    assert src.n_ops < 131 and src.n_barriers < 26

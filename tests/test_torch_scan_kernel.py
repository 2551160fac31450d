"""K2's generated CUDA source, run on the CPU under a host emulation.

There is no nvcc here, so K2 cannot be compiled for the card; but its
generated source is C++ apart from a few CUDA features.  With
``tests/k2_host.h`` in place of ``<cuda_runtime.h>`` (one block of 1,024
``std::thread``s, ``__syncthreads()`` as a barrier, warp shuffles through
a per-warp buffer), g++ compiles the source and runs it on CPU tensors.
So the emitter's index arithmetic, its barrier placement and its
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
from pytensor_tpu_torch.link.cuda.scan_kernel import ScanKernelSource, scan_kernel_eligible
from pytensor_tpu_torch.link.torch.convert import torch_dtype
from pytensor_tpu_torch.link.torch.dispatch import scan_loop
from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch
from pytensor_tpu_torch.tensor.basic import Alloc, MakeVector

BUILD = Path(__file__).resolve().parents[1] / "build" / "k2_host"
HEADER = Path(__file__).resolve().parent / "k2_host.h"
LAUNCH = "k2_kernel<<<1, K2_THREADS, 0, (cudaStream_t)stream>>>(a);"
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
    src = src.replace(LAUNCH, "k2_host_launch(K2_THREADS, [&] { k2_kernel(a); });")
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


def _emulated_vs_loop(gxx, f, values, fuse_inner=False):
    """Run f's Scan node as K2 under the emulation and as the step loop,
    on the outer inputs the graph gives it; returns the two output lists."""
    (node,) = [nd for nd in f.fgraph.apply_nodes if type(nd.op).__name__ == "Scan"]
    op = _fused(node.op) if fuse_inner else node.op
    assert scan_kernel_eligible(op, node)
    feed = fgraph_to_torch(FunctionGraph(f.fgraph.inputs, node.inputs, clone=False), "cpu")
    n_steps, *outer = feed(*[torch.as_tensor(np.asarray(v)) for v in values])
    src = ScanKernelSource(op, node)
    T = int(n_steps)

    def empty(v, lead=()):
        return torch.empty((*lead, *v.type.shape), dtype=torch_dtype(v.type.dtype))

    ins = [t.contiguous() for t in outer]
    outs = ([empty(v, (T,)) for v in src.state_outs] + [empty(v) for v in src.unt_outs]
            + [empty(v, (T,)) for v in src.nit_outs])
    # a scratch arena of garbage: every slot is written before it is read
    scratch = torch.full((max(src.arena, 16),), 0xAB, dtype=torch.uint8)
    consts = torch.frombuffer(bytearray(src.const_bytes), dtype=torch.uint8)
    ptrs = [t.data_ptr() for t in ins + outs] + [scratch.data_ptr(), consts.data_ptr()]
    lib = _host_library(gxx, src.source)
    assert lib.k2_launch((ctypes.c_ulonglong * len(ptrs))(*ptrs), T, None) == 0
    return outs, scan_loop(op, "cpu")(n_steps, *outer)


def _check(gxx, build, values, fuse_inner=False):
    with config.change_flags(scan__pallas=True):
        inputs, outputs = build()
        f = ptt.function(inputs, outputs, device="cpu")
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


CASES = {
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
    _check(gxx, build, values)


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

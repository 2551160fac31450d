"""Drive the torch port's radon and sparse paths on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Phases, one line or more each, and any failure raises:

1. device: require CUDA; print the card's name and power limit.
2. build: the fused elementwise kernels (K1) of the four radon graphs in
   one library, the radon leapfrog kernel (K3), its stamped variant and
   both again with every county's rows in shared memory, the whole-loop
   scan kernel (K2) of the leapfrog chain at full width, K2's stamped
   variant and the CSR matvec kernel (K4), with nvcc, the compilers
   started together; print K2's loops, barriers, arena bytes, placement
   and source sha256, each build's seconds and the ``-Xptxas -v``
   register and spill lines (for K1, a summary of each library's).
3. K1: every FusedElemwise of the single-chain graph and of the batched
   graph at 1,024 chains, in float32 and float64, launched on the inputs
   the graph gives it and held against its plain torch version; each
   node's input layout classes and wall µs a launch, kernel against
   plain; per graph call the device and wall times against the bound.
4. K3: the leapfrog chain at full width (919 observations, 85 counties),
   1,024 steps, held against its plain torch version; sha256 digests of
   its outputs (one chain and 1,024 chains), the same kernel walking every
   county from shared memory (bit-identical, and its time), and K3's step
   split by part from the stamped variants (block 0's thread 0's
   ``clock64()`` after each part of steps 16-31; the stamped launch must
   give K3's bits).
5. slice: ``entry("cuda")`` logp and dlogp against a float64 NumPy
   evaluation of the closed form; the batched graph at 1,024 chains; 64
   leapfrog steps through ``leapfrog()``; then one trajectory through K3's
   entry point, ``make_radon_leapfrog_kernel``.  Kernel launch counts are
   set to 0 before this phase and must be positive after it.
6. K2: the chain of ``make_leapfrog_chain`` at full width, one float32
   chain, 64 steps: K2 (one launch) against its plain step loop on the
   card, and the chain against the float64 loop; relative errors of
   theta, m and logp.  Then K2's step split by op: the stamped variant
   (thread 0's ``clock64()`` after each loop and barrier of steps 16-31),
   which must give K2's bits, as cycles a step by op class and the ten
   costliest loops with their lines in the generated source.
7. chain: ``make_leapfrog_chain(n_steps=8192, device="cuda")`` through
   ``scan`` and ``function()``; launch counts are set to 0 before the
   call, and K2 must have launched exactly once after it.  Its final
   theta, m and logp are held against K3's 8,192 steps from the same
   start.  The batched chain at 1,024 chains takes the step loop for 16
   steps and is held against K3 at 1,024 chains.
8. profile: wall time per call of each linked function, its time on the
   card from ``torch.profiler``, the card's busy share, and the kernels
   that take the card's time; for the 8,192-step chain the device and
   wall ms, µs a step and dlogp evals/s, and the kernels of one call (K2
   once, nothing per step); the plain loop's time a step at 64 steps.
9. K4: the 65,536 x 65,536 CSR matrix of ``benchsuite.py:160
   ours_sparse`` (ten nonzeros a row, float32, seed 0): K4 against its
   plain version for A and its transpose, per row within
   ``4 * D2 * 2**-24 * sum_j |a_ij x_j|``; two launches bit-identical;
   the launch (rows a tile, tiles and blocks, waves) and the sha256 of K4's
   output for each; device times with L2 warm (back-to-back launches)
   and cold (128 MB written before each launch; K4's kernel alone), wall
   and cuSPARSE times against the bound.  With ``--parent DIR`` (a
   checkout of an earlier commit) it also builds K4 from DIR's
   ``pytensor_tpu_torch/csrc/spmv_csr.cu``, requires its output to have
   this tree's bits for A and its transpose, and times the two kernels
   in turn, twice, warm and cold.
10. sparse: at that size, ``function()`` of ``sum(y*y)`` and its
   gradient (two RoutedSpMV nodes, two K4 launches) against float64
   scipy, then the power iteration ``train_loop(..., n_steps=64)`` (64
   K4 launches in one call) against a float64 scipy loop; launch counts
   are set to 0 before each call.  Profile of one 64-step call: wall ms,
   matvecs/s, device ms, busy share, kernels by name, K4's µs a launch.

Two clocks are kept apart.  ``wall_ms`` is CUDA events around
back-to-back calls: with kernels of a few microseconds it measures the
host's launch path, not the card.  ``device_ms`` takes the durations of
the CUDA kernels that ``torch.profiler`` traces, per launch, so that a
launch the trace missed does not shorten a kernel.  The kernel line's
``ms`` and ``plain_ms`` are device times; ``wall_ms`` and
``plain_wall_ms`` beside them are wall times.

The second-to-last line is a JSON object with one entry per kernel, the
last ``{"ok": true, "device": {...}}``.  Each entry has ``bound_ms``, the
least time the card could take for the kernel's work (the larger of its
bytes, each input read once and each output written once, over 3.35 TB/s
and its float32 operations over 67 TFLOP/s, the H100 SXM data sheet's
rates; ``bound_by`` names the larger; K2 and K3, which run a chain on one
block, also carry ``bound_one_sm_ms``, the same work at one SM's share of
those rates), and ``library_ms``, the device
time of one PyTorch call computing the same function (cuSPARSE's CSR
matvec for K4; none exists for K1-K3).  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

N_OBS, N_COUNTIES, N_CHAINS = 919, 85, 1024
K3_STEPS, LEAPFROG_STEPS, EPS = 1024, 64, 1e-3
# K1 vs its plain version, relative to the output's magnitude: the kernel
# and torch round the same IEEE operations (K1 is built with -fmad=false),
# but an n-ary add may associate differently and a math function may
# differ from torch's by an ulp
K1_RTOL = {"float32": 1e-5, "float64": 1e-12}
# K3 vs its plain version after 1,024 float32 steps, over max(1, max|ref|):
# the two sum in different orders and the trajectory carries the rounding
# forward (on an H100 80GB HBM3 at 700 W the kernel ended 4.3e-5 / 3.6e-4 /
# 9.5e-5 from the float32 plain chain in theta / m / logp, and 7.1e-5 /
# 6.0e-4 / 1.6e-4 from the float64 one); the kernel is held to both at
# 3-5x those readings
K3_RTOL = {"theta": 3e-4, "m": 3e-3, "logp": 5e-4}
# K3 built to walk every county's rows from shared memory, not registers
K3_SHARED_WALK = ("-DK3_ROW_CAP=0",)
# the linked float32 graph vs the float64 closed form: sums of 919 float32
# terms; atol scaled to max|dlogp| because some entries are near zero
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4
K2_STEPS, CHAIN_STEPS, BATCH_STEPS = 64, 8192, 16
# K2 after 64 float32 steps, over max(1, max|ref|), against its plain step
# loop and against the float64 loop: both sum in other orders than K2 (on
# an H100 80GB HBM3 at 700 W K2 ended 0 / 1.1e-7 / 0 from the loop and
# 3.6e-7 / 5.4e-7 / 3.6e-7 from the float64 loop in theta / m / logp);
# held at ~4x those readings
K2_RTOL = {"theta": 1.5e-6, "m": 2.5e-6, "logp": 1.5e-6}
# the chain through function() against K3 from the same start: the same
# leapfrog with the graph's dlogp in K2 and the analytic one in K3.  At
# 1,024 steps the states are held to ~4x the H100 readings (3.7e-6 /
# 2.8e-5 / 7.5e-6).  Past ~2,000 steps the trajectory amplifies rounding
# (two float64 versions of the 8,192-step chain end 0.40 apart in theta),
# so at 8,192 steps the chain is held to the energy leapfrog conserves,
# H = -logp + |m|^2 / 2: each chain's drift from H(start), and the gap
# between K2's and K3's H, over |H(start)| (on the H100: -2.5e-4, -3.6e-4
# and 1.1e-4; float64 chains on the CPU drift by up to 4.1e-4)
CHAIN_RTOL = {"theta": 1.5e-5, "m": 1.2e-4, "logp": 3e-5}
ENERGY_TOL = 1.5e-3
# the batched chain (step loop, 16 steps) against K3 at 1,024 chains, at
# ~5x the H100 readings (1.6e-7 / 2.7e-7 / 6.9e-8)
BATCH_RTOL = {"theta": 8e-7, "m": 1.4e-6, "logp": 3.5e-7}
# the sparse power iteration of benchsuite.py:160 ours_sparse
SPARSE_N, SPARSE_NNZ_ROW, SPARSE_STEPS = 65536, 10, 64
# the sparse slice against float64 scipy: the cost sum(y*y) (relative),
# the gradient (max error over max|g|), and after 64 power-iteration steps
# the final x (max abs error, |x| <= 1) and the output sum(y) (relative).
# On an H100 80GB HBM3 at 700 W: 3.97e-8, 8.61e-8, 1.35e-7 and 5.42e-9;
# held at ~4x those readings, and at no less than 4 float32 ulps of the
# value (2.4e-7 relative) where a reading fell below one ulp
SPARSE_TOL = {"cost": 2.4e-7, "grad": 3.5e-7, "x": 5.4e-7, "out": 2.4e-7}
# the H100 SXM data sheet's rates, for the bound of each kernel
HBM_BYTES_S, F32_OPS_S = 3.35e12, 67e12
# written between K4 launches to time it with L2 cold (the H100's is 50 MB)
L2_FLUSH_BYTES = 128 * 2 ** 20


def say(*parts):
    print(*parts, flush=True)


def wall_ms(fn, n_iter, warmup=2):
    """Wall time of one call, from CUDA events around back-to-back calls.

    The card waits on the host whenever a call's kernels are shorter than
    their launches, so for small kernels this is the host's launch path.
    """
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def device_ms(fn, n_iter, warmup=2):
    """Time on the card of one call, and the same split by kernel name.

    From the CUDA kernels, copies and fills that ``torch.profiler``
    traces over ``n_iter`` calls.  The trace can miss launches (on the
    H100 it missed up to 2 of 5 launches of a kernel of milliseconds), so
    a name's time a launch is the mean over its traced launches, and its
    launches a call, the same in every call, are its traced count over
    ``n_iter`` rounded up.  Returns ``(ms, {name: (ms, launches)})``, both
    per call.  A trace that holds no CUDA kernel at all (on the H100 one of
    some twenty traces in a run did) is taken again, up to three times.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n_iter):
                fn()
            torch.cuda.synchronize()
        by_name: dict = {}
        for e in prof.events():
            if e.device_type == torch.autograd.DeviceType.CUDA:
                ms, count = by_name.get(e.name, (0.0, 0))
                by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
        if by_name:
            break
        say(f"  (torch.profiler traced no CUDA kernel, trace {attempt + 1} of 3)")
    else:
        raise AssertionError("torch.profiler traced no CUDA kernel in three traces")
    by_name = {k: (ms / c * -(-c // n_iter), -(-c // n_iter)) for k, (ms, c) in by_name.items()}
    return sum(ms for ms, _ in by_name.values()), by_name


def errors(a, b):
    """(max |a - b|, the same over max(1, max |b|))."""
    a = np.asarray(a, dtype="float64")
    b = np.asarray(b, dtype="float64")
    abs_err = float(np.max(np.abs(a - b)))
    return abs_err, abs_err / max(1.0, float(np.max(np.abs(b))))


def rel_err(a, b):
    return errors(a, b)[1]


def _fmt(errs):
    return {k: float(f"{v:.2e}") for k, v in errs.items()}


def bound(n_bytes, n_ops):
    """(ms, "bytes" or "operations"): the least time for this work."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, n_ops / F32_OPS_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def inner_ops(fgraph):
    """Float operations of one run of an inner graph: an elementwise op
    one per output element, a reduction one per input element, a Dot two
    per multiply-add; views, copies and shapes none."""
    from pytensor_tpu_torch.tensor.elemwise import CAReduce, Elemwise
    from pytensor_tpu_torch.tensor.math import Dot

    total = 0
    for nd in fgraph.apply_nodes:
        if isinstance(nd.op, Dot):
            x, y = (i.type.shape for i in nd.inputs)
            total += 2 * int(np.prod(x)) * (y[-1] if len(y) == 2 else 1)
        elif isinstance(nd.op, CAReduce):
            total += int(np.prod(nd.inputs[0].type.shape))
        elif isinstance(nd.op, Elemwise):
            total += int(np.prod(nd.outputs[0].type.shape))
    return total


def k2_stamp_breakdown(kern, k2_ms, plain_outs, n_steps, outer):
    """Phase 6's split of K2's step by op, from the stamped variant: thread
    0's clock64() after each op and barrier of steps STAMP_FROM.., as
    cycles a step by op class and the ten costliest ops with their lines in
    the generated source.  The stamps change no arithmetic, so the stamped
    launch must give K2's bits."""
    import torch
    from pytensor_tpu_torch.link.cuda.scan_kernel import STAMP_FROM, STAMP_STEPS

    got = kern.launch(n_steps, *outer)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, plain_outs)):
        raise AssertionError("the stamped K2 differs from K2")
    stamped_ms = wall_ms(lambda: kern.launch(n_steps, *outer), 3)
    cyc = kern.stamp_buf.cpu().numpy().astype("float64")
    labels = kern.src.stamp_labels
    if not (np.all(cyc > 0) and np.all(np.diff(cyc, axis=1) >= 0)):
        raise AssertionError("K2's stamps are missing or out of order")
    per_op = np.diff(cyc, axis=1).mean(axis=0)  # stamp k - stamp k-1, k >= 1
    step = float(cyc[:, -1].mean() - cyc[:, 0].mean())
    steps = int(n_steps)
    us_step = stamped_ms / steps * 1e3
    lines = kern.src.source.splitlines()
    at = {int(ln.split("K2_STAMP(")[1].split(")")[0]): no + 1
          for no, ln in enumerate(lines) if "K2_STAMP(" in ln and "#define" not in ln}
    by_class: dict = {}
    for k, (cls, _) in enumerate(labels[1:], start=1):
        c, n = by_class.get(cls, (0.0, 0))
        by_class[cls] = (c + per_op[k - 1], n + 1)
    say(f"K2 stamps (thread 0's clock64(), steps {STAMP_FROM}-{STAMP_FROM + STAMP_STEPS - 1} "
        f"of {steps}): {step:.0f} cycles a step; the stamped launch {us_step:.2f} us/step "
        f"wall, K2 {k2_ms / steps * 1e3:.2f} us/step device; {len(labels) - 1} stamps a step")
    for cls, (c, n) in sorted(by_class.items(), key=lambda kv: -kv[1][0]):
        say(f"  {cls:14s} {n:4d} stamps {c:10.0f} cycles/step {c / step:6.3f} of the step "
            f"(~{c / step * us_step:.2f} us)")
    say("  top 10 ops (cycles/step, class, source lines, op):")
    for k in sorted(range(1, len(labels)), key=lambda k: -per_op[k - 1])[:10]:
        first = at[k - 1] + 1
        say(f"    {per_op[k - 1]:8.0f}  {labels[k][0]:14s} lines {first}-{at[k]}  {labels[k][1]}")


def k4_ms(launch, n_iter, flush=None):
    """Device time a launch of K4's kernel alone, from the profile, with
    ``flush`` written before each launch when given, so that the launch
    finds L2 cold."""
    def call():
        if flush is not None:
            flush.zero_()
        return launch()

    _, by_name = device_ms(call, n_iter)
    return next(ms / count for kn, (ms, count) in by_name.items() if "spmv_csr_kernel" in kn)


def parent_k4(root):
    """K4's launch as built from the tree at ``root``: its
    ``csrc/spmv_csr.cu`` through the same C entry, with this tree's build
    flags and lane count.  Its launches are not counted."""
    import torch

    from pytensor_tpu_torch.link.cuda.build import build_library
    from pytensor_tpu_torch.link.cuda.spmv_kernel import group_size

    src = Path(root, "pytensor_tpu_torch", "csrc", "spmv_csr.cu")
    lib, _ = build_library(src.read_text(), "spmv_csr_parent", src)
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.spmv_csr.argtypes = [p, p, p, p, p, i, i, p]
    lib.spmv_csr.restype = i

    def launch(indptr, indices, data, x):
        M = indptr.shape[0] - 1
        y = torch.empty(M, dtype=torch.float32, device=x.device)
        err = lib.spmv_csr(indptr.data_ptr(), indices.data_ptr(), data.data_ptr(), x.data_ptr(),
                           y.data_ptr(), M, group_size(M, indices.shape[0]),
                           torch.cuda.current_stream(x.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"the parent's K4 launch failed: CUDA error {err}")
        return y

    return launch


def digest(*tensors):
    """sha256 of the tensors' bytes, in order: the same bits give the same
    digest."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().cpu().contiguous().numpy().tobytes())
    return h.hexdigest()


def k3_stamp_breakdown(data, th0, m0, want, k3_ms, tag="K3", flags=()):
    """K3's step split by part, from the stamped variant (of the build that
    ``flags`` pick): block 0's thread 0 records clock64() after each part of
    steps STAMP_FROM.. of the 1,024-step chain.  The stamps change no
    arithmetic, so the stamped launch must give K3's bits."""
    import torch
    from pytensor_tpu_torch.models import radon_kernel

    labels = radon_kernel.stamp_labels()
    buf = torch.zeros((radon_kernel.STAMP_STEPS, len(labels)), dtype=torch.int64,
                      device=th0.device)

    def run():
        return radon_kernel.leapfrog_launch(th0, m0, data, K3_STEPS, EPS, stamps=buf,
                                            flags=flags)

    got = run()
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"the stamped {tag} differs from K3")
    stamped_ms = wall_ms(run, 5)
    cyc = buf.cpu().numpy().astype("float64")
    if not (np.all(cyc > 0) and np.all(np.diff(cyc, axis=1) >= 0)):
        raise AssertionError("K3's stamps are missing or out of order")
    step = float(np.diff(cyc[:, 0]).mean())
    parts = np.diff(cyc, axis=1).mean(axis=0)
    rest = step - float(parts.sum())
    say(f"{tag} stamps (block 0's thread 0, clock64(), steps {radon_kernel.STAMP_FROM}-"
        f"{radon_kernel.STAMP_FROM + radon_kernel.STAMP_STEPS - 1} of {K3_STEPS}): "
        f"{step:.0f} cycles a step; the stamped launch {stamped_ms / K3_STEPS * 1e3:.3f} us/step "
        f"wall, K3 {k3_ms / K3_STEPS * 1e3:.3f} us/step device; bit-identical to K3")
    for label, c in zip(labels[1:] + ["to the next step"], list(parts) + [rest]):
        say(f"  {label:28s} {c:8.0f} cycles/step {c / step:6.3f} of the step")


def main(opts):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import scipy.sparse as sp

    import pytensor_tpu_torch as ptt  # (fails outside a checkout)
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.compile.mode import FAST_RUN
    from pytensor_tpu_torch.entry import entry
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.cuda import scan_kernel, spmv_kernel
    from pytensor_tpu_torch.link.torch.convert import as_torch, sparse_as_torch
    from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch
    from pytensor_tpu_torch.models import radon_kernel
    from pytensor_tpu_torch.models.radon import (
        leapfrog,
        make_leapfrog_chain,
        make_radon_graphs,
        make_radon_logp_batched,
        radon_logp_dlogp_reference,
        theta_start,
    )
    from pytensor_tpu_torch.scan.op import Scan
    from pytensor_tpu_torch.sparse import RoutedSpMV, as_sparse_variable, structured_dot
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    dev = torch.device("cuda")

    # 1. device -------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    # the one-SM bound of K2 and K3, which run a chain on one block: the
    # card's rates shared among its SMs
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"device: {name}, {torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, capability {torch.cuda.get_device_capability(0)}")
    say(smi)

    # 2. build --------------------------------------------------------------
    # K2 for the leapfrog chain at full width: the Scan node of the linked
    # 64-step chain (the 8,192-step chain has the same body, so the same
    # source and library)
    t0 = time.perf_counter()
    chain64 = make_leapfrog_chain("float32", None, K2_STEPS, N_OBS, N_COUNTIES, device=dev)
    scan_node = next(nd for nd in chain64.fgraph.apply_nodes if isinstance(nd.op, Scan))
    k2 = scan_kernel.ScanKernel(scan_node.op, scan_node, dev)
    # the same kernel with clock64() stamps, for phase 6's breakdown only
    k2_stamped = scan_kernel.ScanKernel(scan_node.op, scan_node, dev, stamps=True)
    src = k2.src
    say(f"K2 source: {len(scan_node.op.fgraph.apply_nodes)} inner nodes -> {src.n_units} "
        f"emitted ops in {src.n_ops} loops and {src.n_barriers} barriers a step; arena "
        f"{src.arena} bytes, placement {src.placement}; constants {len(src.const_bytes)} bytes, "
        f"{src.smem_const_bytes} of them in shared memory; {src.smem_bytes} bytes of dynamic "
        f"shared memory; graph, rewrite and emit in {time.perf_counter() - t0:.2f} s")
    say(f"K2 source sha256 {hashlib.sha256(src.source.encode()).hexdigest()} "
        f"({len(src.source)} bytes)")

    # the graphs of the slice, rewritten once; their K1 kernels are built
    # below, with the other kernels, and linked for the card where used
    def rewritten(dtype, batched):
        if batched:
            theta, logp, dlogp, n = make_radon_logp_batched(N_OBS, N_COUNTIES, dtype)
            inputs, outputs = [theta], [logp, dlogp]
        else:
            inputs, outputs, n = make_radon_graphs(N_OBS, N_COUNTIES, dtype)
        fg = FunctionGraph(inputs, outputs, clone=True)
        FAST_RUN.optimizer.rewrite(fg)
        return fg, n

    graphs = {(dtype, batched): rewritten(dtype, batched)
              for dtype in ("float32", "float64") for batched in (False, True)}
    # the K1 kernels of each graph, one library a graph as linking builds it
    k1_kernels = {key: [fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
                        for nd in fg.toposort() if isinstance(nd.op, FusedElemwise)]
                  for key, (fg, _) in graphs.items()}

    def linked(dtype, batched):
        fg, n = graphs[dtype, batched]
        return fg, fgraph_to_torch(fg, dev), n

    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    with ThreadPoolExecutor(11) as pool:
        k1_jobs = [pool.submit(fused_kernel.build, kerns, verbose=True)
                   for kerns in k1_kernels.values()]
        jobs = {"K3": pool.submit(timed, lambda: radon_kernel.build(verbose=True)),
                "K3 stamped": pool.submit(timed, lambda: radon_kernel.build(
                    verbose=True, flags=radon_kernel.STAMPED)),
                "K3, rows in shared memory": pool.submit(timed, lambda: radon_kernel.build(
                    verbose=True, flags=K3_SHARED_WALK)),
                "K3 stamped, rows in shared memory": pool.submit(timed, lambda: radon_kernel.build(
                    verbose=True, flags=radon_kernel.STAMPED + K3_SHARED_WALK)),
                "K2": pool.submit(timed, lambda: k2.build(verbose=True)),
                "K2 stamped": pool.submit(timed, lambda: k2_stamped.build(verbose=True)),
                "K4": pool.submit(timed, lambda: spmv_kernel.build(verbose=True))}
        build_s = {tag: job.result() for tag, job in jobs.items()}
        for job in k1_jobs:
            job.result()
    logs = {"K3": radon_kernel.BUILD_LOGS[()],
            "K3 stamped": radon_kernel.BUILD_LOGS[radon_kernel.STAMPED],
            "K3, rows in shared memory": radon_kernel.BUILD_LOGS[K3_SHARED_WALK],
            "K3 stamped, rows in shared memory":
                radon_kernel.BUILD_LOGS[radon_kernel.STAMPED + K3_SHARED_WALK],
            "K2": k2.build_log, "K2 stamped": k2_stamped.build_log, "K4": spmv_kernel.BUILD_LOG}
    for tag, log in logs.items():
        say(f"build: {tag} nvcc sm_90a in {build_s[tag]:.2f} s (started together)")
        for line in log.splitlines():
            if "ptxas info" in line and "registers" in line or "bytes stack frame" in line:
                say(f"  {tag} ptxas:", line.strip())
    # K1: one library for the kernels of a linked function that no library
    # holds yet; the chain's were built when phase 2 linked it, each slice
    # graph's in the pool above
    for count, secs, log in fused_kernel.BUILDS:
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores", log))
        frames = [int(b) for b in re.findall(r"(\d+) bytes stack frame", log)]
        report = (f"; ptxas: {len(regs)} functions, {min(regs)}-{max(regs)} registers, stack "
                  f"frames up to {max(frames, default=0)} bytes, {spills} bytes of spill stores, "
                  f"no shared memory" if regs else "")
        say(f"build: K1 nvcc sm_90a, {count} kernels in one library in {secs:.2f} s{report}")

    def start_point(n, dtype, chains=None, seed=1):
        rng = np.random.default_rng(seed)
        th = theta_start(n, dtype)
        if chains is not None:
            th = np.tile(th, (chains, 1))
        return (th + 0.1 * rng.standard_normal(th.shape)).astype(dtype)

    # 3. K1 -----------------------------------------------------------------
    k1 = {"max_abs_err": 0.0}
    t0 = time.perf_counter()
    for dtype in ("float32", "float64"):
        for batched in (False, True):
            fg, _, n = linked(dtype, batched)
            nodes = [nd for nd in fg.toposort() if isinstance(nd.op, FusedElemwise)]
            # the inputs the graph gives each fused node, computed on the card
            needed = [i for nd in nodes for i in nd.inputs]
            feed = fgraph_to_torch(FunctionGraph(fg.inputs, needed, clone=False), dev)
            theta = as_torch(start_point(n, dtype, N_CHAINS if batched else None), dev)
            values = iter(feed(theta))
            tag = f"{dtype} {'batched x%d' % N_CHAINS if batched else 'single'}"
            worst, worst_abs, ms, plain_ms = 0.0, 0.0, 0.0, 0.0
            work_bytes, work_ops = 0, 0
            jobs, classes = [], set()
            for nd in nodes:
                args = [next(values) for _ in nd.inputs]
                kern = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
                got = kern.launch(*args)
                # each input and constant read once, each output written
                # once; one operation per inner op and element
                work_bytes += nbytes(*args, *kern.const_tensors, *got)
                lay = kern._layout(kern._args(args))
                work_ops += len(kern.order) * lay.n
                classes.update(lay.classes[0])
                want = kern.plain(*args)
                torch.cuda.synchronize()
                pairs = [errors(g.cpu(), w.cpu()) for g, w in zip(got, want)]
                err = max(p[1] for p in pairs)
                worst_abs = max([worst_abs] + [p[0] for p in pairs])
                if not err <= K1_RTOL[dtype]:
                    raise AssertionError(f"K1 {tag} {nd.op}: rel err {err} > {K1_RTOL[dtype]}")
                node_ms = wall_ms(lambda: kern.launch(*args), 50)
                node_plain = wall_ms(lambda: kern.plain(*args), 50)
                say(f"  K1 {tag} {str(nd.op)[:70]:70s} out {tuple(got[0].shape)} "
                    f"classes {lay.classes[0]} err {err:.2e} wall: kernel {node_ms * 1e3:.1f} us "
                    f"plain {node_plain * 1e3:.1f} us")
                worst = max(worst, err)
                ms += node_ms
                plain_ms += node_plain
                jobs.append((kern, args))
            dev_ms, _ = device_ms(lambda: [k.launch(*a) for k, a in jobs], 20)
            dev_plain, _ = device_ms(lambda: [k.plain(*a) for k, a in jobs], 20)
            b_ms, b_by = bound(work_bytes, work_ops)
            names = {fused_kernel.CONTIG: "contiguous", fused_kernel.SCALAR: "0-d",
                     fused_kernel.STRIDED: "strided"}
            say(f"K1 {tag}: {len(nodes)} fused nodes, max rel err {worst:.3e} "
                f"(tol {K1_RTOL[dtype]:g}); input classes {sorted(names[c] for c in classes)}; "
                f"per graph call, device: kernels {dev_ms:.4f} ms, plain {dev_plain:.4f} ms, "
                f"bound {b_ms * 1e3:.4f} us ({b_by}); wall: kernels {ms:.4f} ms "
                f"({ms / len(nodes) * 1e3:.1f} us a launch), plain {plain_ms:.4f} ms "
                f"({plain_ms / len(nodes) * 1e3:.1f} us a launch)")
            if dtype == "float32" and not batched:
                k1.update(ms=dev_ms, plain_ms=dev_plain, wall_ms=ms, plain_wall_ms=plain_ms)
                k1["bound_ms"], k1["bound_by"] = b_ms, b_by
            k1["max_abs_err"] = max(k1["max_abs_err"], worst_abs)
    say(f"K1 phase done in {time.perf_counter() - t0:.1f} s")

    # 4. K3 -----------------------------------------------------------------
    fn3, th0, m0, _ = radon_kernel.make_radon_leapfrog_kernel(
        K3_STEPS, N_OBS, N_COUNTIES, EPS, device=dev)
    th0_d, m0_d = as_torch(th0, dev), as_torch(m0, dev)
    got = radon_kernel.leapfrog_launch(th0_d, m0_d, fn3.data, K3_STEPS, EPS)
    want = radon_kernel.leapfrog_plain(th0_d, m0_d, fn3.data, K3_STEPS, EPS)
    ref = radon_kernel.leapfrog_plain(th0_d.double(), m0_d.double(), fn3.data, K3_STEPS, EPS)
    torch.cuda.synchronize()
    keys = ("theta", "m", "logp")
    pairs = {k: errors(g.cpu(), w.cpu()) for k, g, w in zip(keys, got, want)}
    errs = {k: p[1] for k, p in pairs.items()}
    k3_abs = max(p[0] for p in pairs.values())
    errs64 = {k: rel_err(g.cpu(), r.cpu()) for k, g, r in zip(keys, got, ref)}
    plain64 = {k: rel_err(w.cpu(), r.cpu()) for k, w, r in zip(keys, want, ref)}
    for k in keys:
        if not (errs[k] <= K3_RTOL[k] and errs64[k] <= K3_RTOL[k]):
            raise AssertionError(f"K3 {k}: rel err {errs[k]} vs plain, {errs64[k]} vs "
                                 f"float64 plain; tol {K3_RTOL[k]}")
    def k3():
        return radon_kernel.leapfrog_launch(th0_d, m0_d, fn3.data, K3_STEPS, EPS)

    def k3_plain():
        return radon_kernel.leapfrog_plain(th0_d, m0_d, fn3.data, K3_STEPS, EPS)

    k3_wall = wall_ms(k3, 20)
    k3_plain_wall = wall_ms(k3_plain, 2, warmup=1)
    k3_ms, _ = device_ms(k3, 5)
    k3_plain_ms, _ = device_ms(k3_plain, 1, warmup=0)
    th0_c = as_torch(np.tile(th0, (N_CHAINS, 1)), dev)
    m0_c = as_torch(np.tile(m0, (N_CHAINS, 1)), dev)
    k3_chains_ms, _ = device_ms(lambda: radon_kernel.leapfrog_launch(
        th0_c, m0_c, fn3.data, K3_STEPS, EPS), 5)
    # K3's bits: digests of its outputs, one chain and 1,024 chains from
    # seeded starts, to compare with other builds of K3 on any card
    rng_d = np.random.default_rng(4)
    th_d = as_torch((np.tile(th0, (N_CHAINS, 1))
                     + 0.1 * rng_d.standard_normal((N_CHAINS, th0.size))).astype("float32"), dev)
    m_d = as_torch(rng_d.standard_normal((N_CHAINS, th0.size)).astype("float32"), dev)
    many = radon_kernel.leapfrog_launch(th_d, m_d, fn3.data, K3_STEPS, EPS)
    torch.cuda.synchronize()
    say(f"K3 digests, sha256 of theta, m, logp after {K3_STEPS} steps: one chain "
        f"{digest(*got)}, {N_CHAINS} chains {digest(*many)}")
    # K3's work: per gradient ~10 operations an observation (residual,
    # scale, segment sum, two products summed), ~8 a county and, per step,
    # ~6 a parameter for the two kicks and the drift; 1,025 gradients
    n_par = N_COUNTIES + 4
    k3_bound = bound(nbytes(th0_d, m0_d, fn3.data.y_sorted, fn3.data.floor_sorted,
                            fn3.data.county_ptr, *got),
                     (10 * N_OBS + 8 * N_COUNTIES + 6 * n_par) * (K3_STEPS + 1))
    say(f"K3 {K3_STEPS} steps, 919/85: logp {float(got[2]):.6f} vs plain {float(want[2]):.6f}; "
        f"rel err theta {errs['theta']:.2e} m {errs['m']:.2e} logp {errs['logp']:.2e} "
        f"(tol {K3_RTOL}); vs the float64 plain chain: kernel "
        f"{ {k: float(f'{v:.2e}') for k, v in errs64.items()} }, float32 plain "
        f"{ {k: float(f'{v:.2e}') for k, v in plain64.items()} }; "
        f"device: kernel {k3_ms:.4f} ms ({k3_ms / K3_STEPS * 1e3:.3f} us/step), "
        f"plain {k3_plain_ms:.2f} ms, {N_CHAINS} chains in one launch {k3_chains_ms:.4f} ms; "
        f"wall: kernel {k3_wall:.4f} ms, plain {k3_plain_wall:.2f} ms")
    say(f"K3 bound for all {K3_STEPS} steps ({k3_bound[1]}): the card {k3_bound[0] * 1e3:.4f} us, "
        f"one SM {k3_bound[0] * n_sms * 1e3:.2f} us ({k3_bound[0] * n_sms / K3_STEPS * 1e6:.1f} "
        f"ns a step); K3 runs a chain on one block")
    # the rows in registers against the same kernel walking shared memory
    shared = radon_kernel.leapfrog_launch(th0_d, m0_d, fn3.data, K3_STEPS, EPS,
                                          flags=K3_SHARED_WALK)
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(shared, got)):
        raise AssertionError("K3 walking shared memory differs from K3")
    k3_shared_ms, _ = device_ms(lambda: radon_kernel.leapfrog_launch(
        th0_d, m0_d, fn3.data, K3_STEPS, EPS, flags=K3_SHARED_WALK), 5)
    say(f"K3 threads a block {radon_kernel.build().radon_leapfrog_threads(N_COUNTIES)}, largest "
        f"county {fn3.data.max_rows} rows; the same kernel walking every county from shared "
        f"memory: device {k3_shared_ms:.4f} ms ({k3_shared_ms / K3_STEPS * 1e3:.3f} us/step), "
        f"bit-identical")
    k3_stamp_breakdown(fn3.data, th0_d, m0_d, got, k3_ms)
    k3_stamp_breakdown(fn3.data, th0_d, m0_d, got, k3_shared_ms,
                       "K3 with rows in shared memory", K3_SHARED_WALK)

    # 5. slice --------------------------------------------------------------
    fn, (theta0,) = entry("cuda")
    _, fn_b, n = linked("float32", batched=True)
    theta = start_point(n, "float32")
    theta_b = start_point(n, "float32", N_CHAINS)
    rng = np.random.default_rng(2)
    m_start = rng.standard_normal(n).astype("float32")
    fused_kernel.LAUNCHES = 0
    radon_kernel.LAUNCHES = 0
    scan_kernel.LAUNCHES = 0
    # the linked graph, as a sampler calls it: entry(), batched, leapfrog()
    lp, g = fn(as_torch(theta, dev))
    lp_b, g_b = fn_b(as_torch(theta_b, dev))
    lf_theta, lf_m, lf_lp = leapfrog(fn, as_torch(theta, dev), as_torch(m_start, dev),
                                     LEAPFROG_STEPS, EPS)
    torch.cuda.synchronize()
    graph_launches = {"fused_elemwise": fused_kernel.LAUNCHES,
                      "radon_leapfrog": radon_kernel.LAUNCHES}
    # a whole trajectory through K3's own entry point, from its start point
    chain = fn3(th0_d, m0_d)
    torch.cuda.synchronize()
    launches = {"fused_elemwise": fused_kernel.LAUNCHES, "radon_leapfrog": radon_kernel.LAUNCHES}
    say(f"slice launches, linked graph (entry fn, batched fn, leapfrog()): {graph_launches}")
    say(f"slice launches, K3 trajectory (make_radon_leapfrog_kernel, {K3_STEPS} steps): "
        f"{launches['radon_leapfrog'] - graph_launches['radon_leapfrog']}")
    if not all(v > 0 for v in launches.values()):
        raise AssertionError(f"a kernel of the path was not launched: {launches}")
    # the same start as phase 4, so the plain chain computed there holds it
    chain_err = {k: rel_err(a.cpu(), b.cpu()) for k, a, b in zip(keys, chain, want)}
    for k, e in chain_err.items():
        if not (bool(torch.isfinite(chain[keys.index(k)]).all()) and e <= K3_RTOL[k]):
            raise AssertionError(f"K3 trajectory {k}: rel err {e} vs plain > {K3_RTOL[k]}")
    say(f"K3 trajectory: logp {float(chain[2]):.6f}, rel err vs plain "
        f"{ {k: float(f'{v:.2e}') for k, v in chain_err.items()} }")

    def check_slice(tag, lp, g, theta_np):
        rlp, rg = radon_logp_dlogp_reference(theta_np.astype("float64"), N_OBS, N_COUNTIES)
        lp, g = lp.cpu().numpy(), g.cpu().numpy()
        if not (np.all(np.isfinite(lp)) and np.all(np.isfinite(g))
                and g.shape == theta_np.shape and lp.shape == theta_np.shape[:-1]):
            raise AssertionError(f"{tag}: non-finite or misshapen output")
        atol = SLICE_ATOL * float(np.max(np.abs(rg)))
        np.testing.assert_allclose(lp, rlp, rtol=SLICE_RTOL)
        np.testing.assert_allclose(g, rg, rtol=SLICE_RTOL, atol=atol)
        e_lp = float(np.max(np.abs(lp - rlp) / np.abs(rlp)))
        e_g = float(np.max(np.abs(g - rg)) / np.max(np.abs(rg)))
        say(f"{tag}: logp rel err {e_lp:.2e}, max|dlogp err|/max|dlogp| {e_g:.2e} "
            f"vs float64 closed form (rtol {SLICE_RTOL}, atol {SLICE_ATOL}*max|dlogp|)")

    check_slice("entry single", lp, g, theta)
    check_slice(f"batched x{N_CHAINS}", lp_b, g_b, theta_b)
    # leapfrog() through the graph vs the same trajectory in K3's plain version
    pl_theta, pl_m, pl_lp = radon_kernel.leapfrog_plain(
        as_torch(theta, dev), as_torch(m_start, dev), fn3.data, LEAPFROG_STEPS, EPS)
    lf_err = {k: rel_err(a.cpu(), b.cpu()) for k, a, b in
              (("theta", lf_theta, pl_theta), ("m", lf_m, pl_m), ("logp", lf_lp, pl_lp))}
    for k, e in lf_err.items():
        if not e <= K3_RTOL[k]:
            raise AssertionError(f"leapfrog() {k}: rel err {e} > {K3_RTOL[k]}")
    say(f"leapfrog() {LEAPFROG_STEPS} steps via the linked graph: logp {float(lf_lp):.6f}, "
        f"rel err vs analytic chain {lf_err}")

    # 6. K2 against plain ---------------------------------------------------
    # the Scan node's outer inputs, computed on the card from K3's start
    feed = fgraph_to_torch(FunctionGraph(chain64.fgraph.inputs, scan_node.inputs,
                                         clone=False), dev)
    n_steps, *outer = feed(th0_d, m0_d)
    n_steps = n_steps.cpu()
    got2 = k2.launch(n_steps, *outer)
    want2 = k2.plain(n_steps, *outer)
    res64 = chain64(th0_d, m0_d)
    ref64 = make_leapfrog_chain("float64", None, K2_STEPS, N_OBS, N_COUNTIES, device=dev)(
        th0_d.double(), m0_d.double())
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(res64[:2], got2)):
        raise AssertionError("K2 through function() differs from the same launch by hand")
    plain_lp = fn(want2[0])[0]  # the plain chain's logp, from the linked logp graph
    pairs2 = {k: errors(a.cpu(), b.cpu()) for k, a, b in
              zip(keys, (got2[0], got2[1], res64[2]), (want2[0], want2[1], plain_lp))}
    err2 = {k: p[1] for k, p in pairs2.items()}
    k2_abs = max(pairs2["theta"][0], pairs2["m"][0])
    err2_64 = {k: rel_err(a.cpu(), b.cpu()) for k, a, b in zip(keys, res64, ref64)}
    for k in keys:
        if not (err2[k] <= K2_RTOL[k] and err2_64[k] <= K2_RTOL[k]):
            raise AssertionError(f"K2 {k}: rel err {err2[k]} vs its plain loop, "
                                 f"{err2_64[k]} vs the float64 loop; tol {K2_RTOL[k]}")
    k2_ms, _ = device_ms(lambda: k2.launch(n_steps, *outer), 5)
    k2_plain_ms, _ = device_ms(lambda: k2.plain(n_steps, *outer), 1, warmup=1)
    k2_wall = wall_ms(lambda: k2.launch(n_steps, *outer), 10)
    k2_plain_wall = wall_ms(lambda: k2.plain(n_steps, *outer), 2, warmup=1)
    # K2's work: the outer inputs, the graph constants and the traces once;
    # the inner graph's operations every step
    k2_bound = bound(nbytes(*outer, k2.consts, *got2),
                     inner_ops(scan_node.op.fgraph) * K2_STEPS)
    say(f"K2 {K2_STEPS} steps, 919/85, float32: logp {float(res64[2]):.6f}; rel err vs its "
        f"plain loop {_fmt(err2)}, vs the float64 loop {_fmt(err2_64)} (tol {K2_RTOL}); "
        f"device: kernel {k2_ms:.4f} ms ({k2_ms / K2_STEPS * 1e3:.2f} us/step), plain "
        f"{k2_plain_ms:.2f} ms ({k2_plain_ms / K2_STEPS * 1e3:.1f} us/step); wall: kernel "
        f"{k2_wall:.4f} ms, plain {k2_plain_wall:.2f} ms "
        f"({k2_plain_wall / K2_STEPS * 1e3:.1f} us/step)")
    say(f"K2 bound for {K2_STEPS} steps ({k2_bound[1]}): the card {k2_bound[0] * 1e3:.4f} us, one "
        f"SM {k2_bound[0] * n_sms * 1e3:.2f} us ({k2_bound[0] * n_sms / K2_STEPS * 1e3:.3f} us a "
        f"step); K2 runs a chain on one block")
    k2_stamp_breakdown(k2_stamped, k2_ms, got2, n_steps, outer)

    # 7. chain through scan + function() --------------------------------------
    chain = make_leapfrog_chain("float32", None, CHAIN_STEPS, N_OBS, N_COUNTIES, device=dev)
    fused_kernel.LAUNCHES = 0
    radon_kernel.LAUNCHES = 0
    scan_kernel.LAUNCHES = 0
    c_theta, c_m, c_lp = chain(th0_d, m0_d)
    torch.cuda.synchronize()
    chain_launches = {"fused_elemwise": fused_kernel.LAUNCHES,
                      "radon_leapfrog": radon_kernel.LAUNCHES,
                      "scan_whole_loop": scan_kernel.LAUNCHES}
    say(f"chain launches, make_leapfrog_chain({CHAIN_STEPS} steps) one call: {chain_launches}")
    if chain_launches["scan_whole_loop"] != 1 or chain_launches["fused_elemwise"] < 1:
        raise AssertionError(f"the chain must launch K2 once and K1: {chain_launches}")
    fn3_chain = radon_kernel.make_radon_leapfrog_kernel(
        CHAIN_STEPS, N_OBS, N_COUNTIES, EPS, device=dev)[0]
    k3_chain = fn3_chain(th0_d, m0_d)
    # the same chain at K3_STEPS against K3's trajectory of phase 4
    chain_short = make_leapfrog_chain("float32", None, K3_STEPS, N_OBS, N_COUNTIES, device=dev)
    short = chain_short(th0_d, m0_d)
    torch.cuda.synchronize()
    s_err = {k: rel_err(a.cpu(), b.cpu()) for k, a, b in zip(keys, short, got)}
    for k, e in s_err.items():
        if not e <= CHAIN_RTOL[k]:
            raise AssertionError(f"chain {K3_STEPS} steps {k}: rel err {e} vs K3 > "
                                 f"{CHAIN_RTOL[k]}")

    def energy(th, m, lp):
        return -float(lp) + 0.5 * float((m.double() ** 2).sum())

    h0 = energy(None, torch.from_numpy(m0), radon_logp_dlogp_reference(
        th0.astype("float64"), N_OBS, N_COUNTIES)[0])
    h_k2, h_k3 = energy(c_theta, c_m, c_lp), energy(*k3_chain)
    drift = {"K2": (h_k2 - h0) / abs(h0), "K3": (h_k3 - h0) / abs(h0),
             "K2-K3": (h_k2 - h_k3) / abs(h0)}
    finite = all(bool(torch.isfinite(v).all()) for v in (c_theta, c_m, c_lp, *k3_chain))
    if not (finite and all(abs(v) <= ENERGY_TOL for v in drift.values())):
        raise AssertionError(f"chain {CHAIN_STEPS} steps: energy drift {drift} > "
                             f"{ENERGY_TOL} (finite: {finite})")
    c_err = {k: rel_err(a.cpu(), b.cpu()) for k, a, b in zip(keys, (c_theta, c_m, c_lp),
                                                                k3_chain)}
    say(f"chain {K3_STEPS} steps: rel err vs K3 {_fmt(s_err)} (tol {CHAIN_RTOL}); chain "
        f"{CHAIN_STEPS} steps: logp {float(c_lp):.6f} vs K3 {float(k3_chain[2]):.6f}, energy "
        f"drift over |H(start)| {_fmt(drift)} (tol {ENERGY_TOL}); state rel err vs K3 "
        f"{_fmt(c_err)} (not held: the trajectory amplifies rounding)")
    rng_b = np.random.default_rng(3)
    th_b = as_torch((np.tile(th0, (N_CHAINS, 1))
                     + 0.1 * rng_b.standard_normal((N_CHAINS, th0.size))).astype("float32"), dev)
    m_b = as_torch(rng_b.standard_normal((N_CHAINS, th0.size)).astype("float32"), dev)
    chain_b = make_leapfrog_chain("float32", N_CHAINS, BATCH_STEPS, N_OBS, N_COUNTIES, device=dev)
    b_out = chain_b(th_b, m_b)
    k3_b = radon_kernel.make_radon_leapfrog_kernel(
        BATCH_STEPS, N_OBS, N_COUNTIES, EPS, device=dev)[0](th_b, m_b)
    torch.cuda.synchronize()
    b_err = {k: rel_err(a.cpu(), b.cpu()) for k, a, b in
             zip(keys, b_out, (k3_b[0], k3_b[1], k3_b[2].sum()))}
    for k, e in b_err.items():
        if not e <= BATCH_RTOL[k]:
            raise AssertionError(f"batched chain {k}: rel err {e} vs K3 > {BATCH_RTOL[k]}")
    say(f"batched chain x{N_CHAINS}, {BATCH_STEPS} steps (step loop): sum logp "
        f"{float(b_out[2]):.3f}; rel err vs K3 {_fmt(b_err)} (tol {BATCH_RTOL})")

    # 8. profile -------------------------------------------------------------
    theta_b_d = as_torch(theta_b, dev)
    theta_d, m_d = as_torch(theta, dev), as_torch(m_start, dev)
    t_single = wall_ms(lambda: fn(theta0), 200)
    t_batched = wall_ms(lambda: fn_b(theta_b_d), 100)
    t_leap = wall_ms(lambda: leapfrog(fn, theta_d, m_d, LEAPFROG_STEPS, EPS), 3, warmup=1)
    say(f"linked entry fn: wall {t_single:.4f} ms/call ({1e3 / t_single:,.0f} logp+dlogp "
        f"evals/s); batched x{N_CHAINS}: wall {t_batched:.4f} ms/call "
        f"({N_CHAINS * 1e3 / t_batched:,.0f} chain-evals/s); "
        f"leapfrog() {LEAPFROG_STEPS} steps: wall {t_leap:.2f} ms")
    for tag, call, wall in (("entry fn", lambda: fn(theta0), t_single),
                            (f"batched x{N_CHAINS}", lambda: fn_b(theta_b_d), t_batched)):
        dev_ms, by_name = device_ms(call, 50)
        top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]
        say(f"profile {tag}: device {dev_ms:.4f} ms/call, {sum(c for _, c in by_name.values()):.0f} "
            f"kernels/call, busy {dev_ms / wall:.3f} of wall {wall:.4f} ms")
        for kname, (ms, count) in top:
            say(f"  {ms:.4f} ms/call  {count:.0f} launches/call  {kname[:90]}")
    say(f"K1 per single-chain f32 graph call: device {k1['ms']:.4f} ms vs plain "
        f"{k1['plain_ms']:.4f} ms, wall {k1['wall_ms']:.4f} ms vs plain "
        f"{k1['plain_wall_ms']:.4f} ms; K3 {K3_STEPS} steps: device {k3_ms:.4f} ms vs plain "
        f"{k3_plain_ms:.2f} ms, wall {k3_wall:.4f} ms vs plain {k3_plain_wall:.2f} ms")
    # the 8,192-step chain: one call is one K2 launch plus the outer graph
    def clocks():
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,temperature.gpu",
             "--format=csv,noheader"], capture_output=True, text=True).stdout.strip()

    clocks_before = clocks()
    t_chain = wall_ms(lambda: chain(th0_d, m0_d), 3, warmup=1)
    chain_dev, chain_by = device_ms(lambda: chain(th0_d, m0_d), 3, warmup=1)
    clocks_after = clocks()
    k2_names = [kn for kn in chain_by if "k2_kernel" in kn]
    per_call = sum(c for _, c in chain_by.values())
    # the launch counter showed one K2 launch a call (phase 7); the trace
    # must show it and no kernel a step
    if len(k2_names) != 1 or chain_by[k2_names[0]][1] != 1 or per_call > 64:
        raise AssertionError(
            f"the chain call must hold one K2 launch and no per-step kernels: {per_call:.2f} "
            f"kernels a call, {[(kn[:40], c) for kn, (_, c) in chain_by.items()]}")
    k2_chain_ms = chain_by[k2_names[0]][0]
    say(f"chain {CHAIN_STEPS} steps (make_leapfrog_chain, function()): wall {t_chain:.2f} "
        f"ms/call, {t_chain / CHAIN_STEPS * 1e3:.2f} us/step, "
        f"{2 * CHAIN_STEPS * 1e3 / t_chain:,.0f} dlogp evals/s; device {chain_dev:.2f} "
        f"ms/call ({k2_chain_ms / CHAIN_STEPS * 1e3:.2f} us/step in K2), "
        f"{per_call:.0f} kernels/call, busy {chain_dev / t_chain:.3f}")
    for kname, (ms, count) in sorted(chain_by.items(), key=lambda kv: -kv[1][0]):
        say(f"  {ms:.4f} ms/call  {count:.0f} launches/call  {kname[:90]}")
    # K2's time a step against the chain's length and its state
    k2_step = {}
    for tag, call, steps in ((f"{K3_STEPS} from the start", lambda: chain_short(th0_d, m0_d),
                              K3_STEPS),
                             (f"{K2_STEPS} from the {CHAIN_STEPS}-step end",
                              lambda: chain64(c_theta, c_m), K2_STEPS)):
        _, by = device_ms(call, 3, warmup=1)
        k2_step[tag] = next(ms for kn, (ms, _) in by.items() if "k2_kernel" in kn) / steps * 1e3
    say(f"K2 device us/step: {K2_STEPS} from the start {k2_ms / K2_STEPS * 1e3:.2f}, "
        + ", ".join(f"{k} {v:.2f}" for k, v in k2_step.items())
        + f", {CHAIN_STEPS} from the start {k2_chain_ms / CHAIN_STEPS * 1e3:.2f}; "
        f"SM clock, max, power, temperature before {clocks_before} / after {clocks_after}")
    say(f"plain step loop ({K2_STEPS} steps, 919/85): {k2_plain_ms / K2_STEPS * 1e3:.1f} "
        f"us/step device, {k2_plain_wall / K2_STEPS * 1e3:.1f} us/step wall; K2 "
        f"{k2_ms / K2_STEPS * 1e3:.2f} us/step device, {k2_wall / K2_STEPS * 1e3:.2f} "
        f"us/step wall")

    # 9. K4 at full size ---------------------------------------------------------
    t0 = time.perf_counter()
    n = SPARSE_N
    rng_s = np.random.default_rng(0)  # benchsuite.py's SUITE_SEED
    A = sp.random(n, n, density=SPARSE_NNZ_ROW / n, format="csr", random_state=rng_s,
                  dtype="float32")
    x0 = rng_s.standard_normal((n, 1)).astype("float32")
    x0_d = as_torch(x0[:, 0], dev)
    say(f"sparse: A {n} x {n}, {A.nnz} nonzeros, rows of {np.diff(A.indptr).min()}-"
        f"{np.diff(A.indptr).max()}, made in {time.perf_counter() - t0:.2f} s")
    k4 = {}
    parent = parent_k4(opts.parent) if opts.parent else None
    # written between launches for the cold-L2 time: 128 MB, over twice L2
    flush = torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for tag, M in (("A", A), ("A^T", A.T.tocsr())):
        c = sparse_as_torch(M, dev)
        args = (c.indptr, c.indices, c.data, x0_d)
        got4 = spmv_kernel.launch(*args)
        again = spmv_kernel.launch(*args)
        want4 = spmv_kernel.plain(*args)
        torch.cuda.synchronize()
        if not torch.equal(got4, again):
            raise AssertionError(f"K4 {tag}: two launches differ")
        d2 = int(np.diff(M.indptr).max())
        row_tol = 4 * d2 * 2.0 ** -24 * (abs(M) @ np.abs(x0[:, 0].astype("float64")))
        diff = np.abs(got4.cpu().numpy().astype("float64") - want4.cpu().numpy())
        if not (np.all(np.isfinite(got4.cpu().numpy())) and np.all(diff <= row_tol)):
            worst = int(np.argmax(diff - row_tol))
            raise AssertionError(f"K4 {tag}: row {worst} off by {diff[worst]}, tol "
                                 f"{row_tol[worst]}")
        lib_mat = torch.sparse_csr_tensor(c.indptr, c.indices, c.data, size=M.shape)
        lib_err = float((lib_mat @ x0_d - want4).abs().max())
        G = spmv_kernel.group_size(n, M.nnz)
        plan4 = spmv_kernel.plan(n, G)
        ms4 = k4_ms(lambda: spmv_kernel.launch(*args), 50)
        cold4 = k4_ms(lambda: spmv_kernel.launch(*args), 50, flush)
        plain4, _ = device_ms(lambda: spmv_kernel.plain(*args), 20)
        lib4, _ = device_ms(lambda: lib_mat @ x0_d, 50)
        wall4 = wall_ms(lambda: spmv_kernel.launch(*args), 200)
        plain_wall4 = wall_ms(lambda: spmv_kernel.plain(*args), 50)
        b4 = bound(nbytes(c.indptr, c.indices, c.data, x0_d, got4), 2 * M.nnz)
        say(f"K4 {tag}: G {G}, D2 {d2}, max|err| vs plain {diff.max():.3e} (per-row tol "
            f"4*D2*2^-24*sum|a x|, worst share "
            f"{float(np.max(diff[row_tol > 0] / row_tol[row_tol > 0])):.3f}), "
            f"cuSPARSE vs plain {lib_err:.3e}, bit-identical relaunch; device: kernel "
            f"{ms4 * 1e3:.2f} us (L2 warm), {cold4 * 1e3:.2f} us (L2 cold), plain "
            f"{plain4 * 1e3:.2f} us, cuSPARSE {lib4 * 1e3:.2f} us, bound {b4[0] * 1e3:.3f} us "
            f"({b4[1]}, {b4[0] / ms4:.3f} of it reached warm, {b4[0] / cold4:.3f} cold); wall: "
            f"kernel {wall4 * 1e3:.2f} us, plain {plain_wall4 * 1e3:.2f} us")
        say(f"K4 {tag}: tiles of {plan4['rows']} rows, a tile a block: {plan4['blocks']} tiles "
            f"and blocks of {plan4['rows'] * G} threads, {plan4['waves']} wave(s) of the "
            f"{plan4['resident']} blocks the card holds at once; output sha256 {digest(got4)}")
        if parent is not None:
            got_p = parent(*args)
            torch.cuda.synchronize()
            if not torch.equal(got_p.view(torch.int32), got4.view(torch.int32)):
                raise AssertionError(f"K4 {tag}: the parent's K4 gives other bits")
            turns = {"this": [], "parent": []}
            for _ in range(2):
                for who, fn in (("this", spmv_kernel.launch), ("parent", parent)):
                    turns[who].append((k4_ms(lambda: fn(*args), 50),
                                       k4_ms(lambda: fn(*args), 50, flush)))
            say(f"K4 {tag} beside the parent's ({opts.parent}), in turn, 50 launches a timing, "
                "warm / cold us: " + "; ".join(
                    f"{who} " + ", ".join(f"{w * 1e3:.2f} / {c * 1e3:.2f}" for w, c in t)
                    for who, t in turns.items())
                + f"; the parent's output sha256 {digest(got_p)}, this tree's bits")
        say("  kernels of the cuSPARSE call: " + ", ".join(
            kn[:60] for kn in device_ms(lambda: lib_mat @ x0_d, 5)[1]))
        if tag == "A":
            k4 = {"max_abs_err": float(diff.max()), "ms": ms4, "plain_ms": plain4,
                  "wall_ms": wall4, "plain_wall_ms": plain_wall4, "cold_ms": cold4,
                  "library_ms": lib4, "bound_ms": b4[0], "bound_by": b4[1]}
        else:
            k4["max_abs_err"] = max(k4["max_abs_err"], float(diff.max()))
    del flush

    # 10. the sparse slice: gradient function and the power iteration ----------
    A_var = as_sparse_variable(A)
    x_var = pt.tensor("x", dtype="float32", shape=(n,))
    y_var = structured_dot(A_var, x_var)
    cost = pt.sum(y_var * y_var)
    t0 = time.perf_counter()
    f_grad = ptt.function([x_var], [cost, ptt.grad(cost, x_var)], device=dev)
    n_routed = sum(isinstance(nd.op, RoutedSpMV) for nd in f_grad.fgraph.apply_nodes)
    say(f"sparse gradient function built in {time.perf_counter() - t0:.2f} s: "
        f"{[type(nd.op).__name__ for nd in f_grad.fgraph.toposort()]}")
    if n_routed != 2:
        raise AssertionError(f"the gradient graph holds {n_routed} RoutedSpMV nodes, not 2")
    fused_kernel.LAUNCHES = radon_kernel.LAUNCHES = scan_kernel.LAUNCHES = 0
    spmv_kernel.LAUNCHES = 0
    c_val, g_val = f_grad(x0_d)
    torch.cuda.synchronize()
    grad_launches = spmv_kernel.LAUNCHES
    if grad_launches != 2:
        raise AssertionError(f"the gradient function launched K4 {grad_launches} times, not 2")
    A64 = A.astype("float64")
    y64 = A64 @ x0[:, 0].astype("float64")
    g64 = 2 * (A64.T @ y64)
    e_cost = abs(float(c_val) - float(y64 @ y64)) / float(y64 @ y64)
    g_np = g_val.cpu().numpy()
    e_grad = float(np.max(np.abs(g_np - g64)) / np.max(np.abs(g64)))
    if not (np.all(np.isfinite(g_np)) and g_np.shape == (n,) and e_cost <= SPARSE_TOL["cost"]
            and e_grad <= SPARSE_TOL["grad"]):
        raise AssertionError(f"sparse gradient: cost rel err {e_cost}, grad {e_grad}; "
                             f"tol {SPARSE_TOL}")
    say(f"sparse gradient function: {grad_launches} K4 launches; cost rel err {e_cost:.2e}, "
        f"max|grad err|/max|grad| {e_grad:.2e} vs float64 scipy (tol {SPARSE_TOL})")

    xsh = ptt.shared(x0, name="x", device=dev)
    y_sh = structured_dot(A_var, xsh)
    t0 = time.perf_counter()
    power = ptt.train_loop([], pt.sum(y_sh), {xsh: y_sh / (pt.max(pt.abs(y_sh)) + 1e-9)},
                           n_steps=SPARSE_STEPS, device=dev)
    loop_node = next(nd for nd in power.fgraph.apply_nodes if isinstance(nd.op, Scan))
    say(f"power iteration built in {time.perf_counter() - t0:.2f} s: outer "
        f"{[type(nd.op).__name__ for nd in power.fgraph.toposort()]}, inner "
        f"{[type(nd.op).__name__ for nd in loop_node.op.fgraph.toposort()]}")
    fused_kernel.LAUNCHES = radon_kernel.LAUNCHES = scan_kernel.LAUNCHES = 0
    spmv_kernel.LAUNCHES = 0
    out = power()
    torch.cuda.synchronize()
    power_launches = {"spmv_csr": spmv_kernel.LAUNCHES, "fused_elemwise": fused_kernel.LAUNCHES,
                      "scan_whole_loop": scan_kernel.LAUNCHES}
    say(f"power iteration launches, train_loop({SPARSE_STEPS} steps) one call: {power_launches}")
    if power_launches["spmv_csr"] != SPARSE_STEPS:
        raise AssertionError(f"the power iteration launched K4 {power_launches['spmv_csr']} "
                             f"times, not {SPARSE_STEPS}")
    v = x0.astype("float64")
    for _ in range(SPARSE_STEPS):
        yv = A64 @ v
        v = yv / (np.max(np.abs(yv)) + 1e-9)
    x_end = xsh.get_value().cpu().numpy()
    e_x = float(np.max(np.abs(x_end - v)))
    e_out = abs(float(out) - float(yv.sum())) / abs(float(yv.sum()))
    if not (np.all(np.isfinite(x_end)) and x_end.shape == (n, 1) and e_x <= SPARSE_TOL["x"]
            and e_out <= SPARSE_TOL["out"]):
        raise AssertionError(f"power iteration: x max err {e_x}, out rel err {e_out}; "
                             f"tol {SPARSE_TOL}")
    say(f"power iteration {SPARSE_STEPS} steps: out {float(out):.6f} vs float64 "
        f"{float(yv.sum()):.6f} (rel err {e_out:.2e}), max|x err| {e_x:.2e} (tol {SPARSE_TOL})")
    t_power = wall_ms(power, 5, warmup=1)
    power_dev, power_by = device_ms(power, 3, warmup=1)
    say(f"power iteration {SPARSE_STEPS} steps (train_loop, function()): wall {t_power:.3f} "
        f"ms/call, {SPARSE_STEPS * 1e3 / t_power:,.0f} matvecs/s; device {power_dev:.4f} "
        f"ms/call, {sum(c for _, c in power_by.values()):.0f} kernels/call, busy "
        f"{power_dev / t_power:.3f}")
    for kname, (ms, count) in sorted(power_by.items(), key=lambda kv: -kv[1][0])[:10]:
        say(f"  {ms:.4f} ms/call  {count:.0f} launches/call  {kname[:90]}")
    k4_power = [(ms, count) for kn, (ms, count) in power_by.items() if "spmv_csr_kernel" in kn]
    say(f"K4 inside the power iteration: {k4_power[0][0] / k4_power[0][1] * 1e3:.2f} us a launch "
        f"(device), {k4_power[0][1]:.0f} launches a call")

    kernels = [
        {"name": "fused_elemwise (K1)", "route": "cuda",
         "source": "pytensor_tpu_torch/tensor/fused_kernel.py",
         "replaces": "pytensor_tpu/tensor/fused.py:33",
         "launches": launches["fused_elemwise"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "wall_ms": k1["wall_ms"], "plain_wall_ms": k1["plain_wall_ms"],
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None},
        {"name": "radon_leapfrog (K3)", "route": "cuda",
         "source": "pytensor_tpu_torch/csrc/radon_leapfrog.cu",
         "replaces": "pytensor_tpu/models/radon_pallas.py:28",
         "launches": launches["radon_leapfrog"], "max_abs_err": k3_abs,
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "wall_ms": k3_wall, "plain_wall_ms": k3_plain_wall,
         "bound_ms": k3_bound[0], "bound_by": k3_bound[1],
         "bound_one_sm_ms": k3_bound[0] * n_sms, "library_ms": None},
        {"name": "scan_whole_loop (K2)", "route": "cuda",
         "source": "pytensor_tpu_torch/link/cuda/scan_kernel.py",
         "replaces": "pytensor_tpu/link/pallas/scan_pallas.py:101",
         "launches": chain_launches["scan_whole_loop"], "max_abs_err": k2_abs,
         "ms": k2_ms, "plain_ms": k2_plain_ms,
         "wall_ms": k2_wall, "plain_wall_ms": k2_plain_wall,
         "bound_ms": k2_bound[0], "bound_by": k2_bound[1],
         "bound_one_sm_ms": k2_bound[0] * n_sms, "library_ms": None},
        {"name": "spmv_csr (K4)", "route": "cuda",
         "source": "pytensor_tpu_torch/csrc/spmv_csr.cu",
         "replaces": "pytensor_tpu/link/pallas/route.py:194",
         "launches": power_launches["spmv_csr"], **k4},
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    cli = argparse.ArgumentParser(description="Drive the torch port on one NVIDIA GPU.")
    cli.add_argument("--parent", metavar="DIR",
                     help="a checkout of an earlier commit whose K4 phase 9 holds and times "
                          "beside this tree's")
    sys.exit(main(cli.parse_args()))

"""Drive the torch port's radon, sparse, logistic-regression, MLP, Elman
RNN and linalg (GP, Kalman filter, batched Cholesky) paths on one NVIDIA
GPU.

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
   register and spill lines (for K1, a summary of each library's).  With
   them: K1 for one fused node a dtype holding every scalar op of the
   expression table, K2 for three scans of the slice's new ops, and the K1
   kernels of the logreg and MFU steps (their graphs rewritten on the CPU
   give the same sources, so linking them in phase 11 finds them built),
   and the K1 kernels of the Elman step with K2 of the static BPTT's
   forward scan (phase 12 finds them built).
3. K1: every FusedElemwise of the single-chain graph and of the batched
   graph at 1,024 chains, in float32 and float64, launched on the inputs
   the graph gives it and held against its plain torch version; each
   node's input layout classes and wall µs a launch, kernel against
   plain; per graph call the device and wall times against the bound.
   Then every scalar op of the expression table in each of K1's dtypes on
   numpy's edges (NaN, +-inf, +-0.0, halves, negative integers, divisors
   of 0, shift counts at and past the width): the exact ops with the plain
   version's bits, the others within ``K1_RTOL``.
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
   set to 0 before this phase and must be positive after it.  Each linked
   function is a CUDA graph (``TorchLinker``, ``config.xla__jit``) and is
   called once before the counts are set to 0, so that the counted calls
   are replays (a wrapper's count goes up at each replay by what the
   capture recorded), and in phases 7 and 10 the same.
6. K2: the chain of ``make_leapfrog_chain`` at full width, one float32
   chain, 64 steps: K2 (one launch) against its plain step loop on the
   card, and the chain against the float64 loop; relative errors of
   theta, m and logp.  Then K2's step split by op: the stamped variant
   (thread 0's ``clock64()`` after each loop and barrier of steps 16-31),
   which must give K2's bits, as cycles a step by op class and the ten
   costliest loops with their lines in the generated source.  Then K2 on
   ``tanh(dot(W, acc))`` with a 5 x 5 W, on a body of Dot22, Gemm and
   Dot22Scalar and on a body of Join, Split, ARange, DeepCopyOp and
   ViewOp, each against its step loop (``K2_CASE_TOL``).
7. chain: ``make_leapfrog_chain(n_steps=8192, device="cuda")`` through
   ``scan`` and ``function()``; launch counts are set to 0 before the
   call, and K2 must have launched exactly once after it.  Its final
   theta, m and logp are held against K3's 8,192 steps from the same
   start.  The batched chain at 1,024 chains takes the step loop for 16
   steps and is held against K3 at 1,024 chains.
8. profile: each linked function of the radon path (single chain, 1,024
   chains, the 64-step ``leapfrog()`` loop, the 8,192-step chain) captured
   and eager (linked with ``xla__jit`` off), in turn in this process: wall
   and device ms a call, the busy share, the nodes a call runs and the
   kernels it launches, the seconds of the warm-up and the capture, the
   peak memory of a call; the float32 ``entry`` function's outputs,
   replayed and eager, must have the same sha256.  The peak memory of the
   eager batched graph with its free lists emptied (the linker before free
   lists) beside it; a 1,024-step float64 chain through the step loop
   (~120,000 nodes) as the longest capture.  Then the kernels that take
   the card's time; for the 8,192-step chain the device and wall ms, µs a
   step and dlogp evals/s, and the kernels of one call (K2 once, nothing
   per step); the plain loop's time a step at 64 steps.
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
   are set to 0 before each call.  Both captured and eager as in phase 8
   (the power iteration's also with its free lists emptied); the power
   iteration's replayed output and final x must have the eager call's
   sha256.  Profile of one 64-step call: wall ms, matvecs/s, device ms,
   busy share, kernels by name, K4's µs a launch.
11. models: the logistic-regression SGD step of ``benchsuite.py:64
   ours_logreg`` (n = 8,192, d = 256, float32) through ``function()`` and
   as a 32-step ``train_loop``, and ``make_mlp_mfu_step`` (float32, batch
   4,096, d 4,096, depth 4) through ``function()`` and as a 4-step
   ``train_loop``, all captured (``phase_models``).  Counts are set to 0
   before one replayed call of each and read after (K1 launches in the
   ``function()`` steps; a ``train_loop`` fuses nothing inside its scan);
   the replay and the eager plan give the same sha256 from the same
   state; the losses and parameters hold against a float64 NumPy
   evaluation of the same steps (``MODEL_TOL``); the MFU step's gradients
   (its graph linked with them as outputs) against the float64 step on
   the card's sides of relu's kink, and its update where it shows beyond
   the weights' float32 rounding (the step against that float64 step, the
   loop against as many calls of the step); K1 on each fused node of the
   steps, on the inputs the first step gives it, against its plain
   version (these launches come after the counted calls); wall and device ms a
   call, busy share, steps/s, K1's launches and device time a call, the
   kernels that take the card's time, and the MFU step's float32 TFLOP/s
   beside the card's float32 peak.  K1's ``launches`` in the kernel line
   add these paths' counts to the radon slice's (``launches_by_path``).
12. Elman: the BPTT step of ``benchsuite.py:121 ours_elman``
   (``models/rnn.py``: seq 64, n_in 32, hidden 128, float32, batch 4)
   through ``function()`` and as a 16-step ``train_loop`` (the RNN's four
   forward and two reverse scans inside the loop's scan), both captured
   (``phase_elman``).  Counts are set to 0 before one replayed call of
   each (K1 on the step's fused nodes, K2 on no Elman scan); the replay
   against the eager plan by sha256; the loss, the gradients (the step's
   graph linked with them as outputs) and the weights after 1 and 16
   steps against ``rnn_reference``, float64 NumPy BPTT, and the loop
   against 16 calls of the step (``ELMAN_TOL``); each of the step's four
   K1 nodes against its plain version at the step's shapes.  Then a
   static BPTT under ``scan__pallas`` (``tanh(dot(W, h))``, W 128 x 128,
   64 steps): K2 takes the forward scan and not the reverse one, launches
   once in a replayed call, and K2 and the gradient hold against the step
   loop.  Then wall and device ms a call, captured and eager, busy share,
   steps/s, kernels a call with the top ones by name, the index kernels of
   the reversed sequences' copies a call, and the step at batch 1,024.
   K1's and K2's ``launches_by_path`` gain these three paths.
13. linalg: the three paths of ``tensor/linalg.py`` (``phase_linalg``):
   (a) the GP SGD step of ``benchsuite.py:143 ours_gp`` (n 256, float32)
   through ``function()`` and as its 64-step ``train_loop``, and the GP
   marginal likelihood with its gradient in float64; (b) the Kalman
   log-likelihood and gradient (64 steps, k 4, p 2, float32) and the SGD
   loop of ``benchsuite.py:1129 ours_kalman`` on a shared T, its step and
   its 16-step ``train_loop``; (c) the batched Cholesky step of
   ``benchsuite.py:978 ours_blockwise_chol`` (batch 128, 64 x 64, float32)
   and its 32-step ``train_loop``.  Each captured, with
   ``Plan.capturable`` printed; counts set to 0 before one replayed call of
   each (K1 once a fused node, none in a loop; K2 never); the replay
   against the eager plan by sha256; the values against float64 NumPy
   (``LINALG_TOL``); each loop against as many calls of its step; every
   K1 node of the paths against its plain version at the path's shapes;
   the Cholesky calls of path (c), one a step of 128 matrices; wall and
   device ms a call, captured and eager, busy share, steps/s, kernels a
   call with the top ones by name and cuSOLVER's factorisation kernels a step.
   K1's and K2's ``launches_by_path`` gain these eight paths.

Two clocks are kept apart.  ``wall_ms`` is CUDA events around
back-to-back calls: with kernels of a few microseconds it measures the
host's launch path, not the card.  ``device_ms`` takes the durations of
the CUDA kernels that ``torch.profiler`` traces, per launch, so that a
launch the trace missed does not shorten a kernel.  The kernel line's
``ms`` and ``plain_ms`` are device times; ``wall_ms`` and
``plain_wall_ms`` beside them are wall times.  A replayed CUDA graph's
kernels are traced one by one, as the eager ones are.

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


def peak_mb(call):
    """MiB allocated at the peak of one call above what was allocated
    before it (``torch.cuda.max_memory_allocated``)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = call()
    torch.cuda.synchronize()
    del out
    return (torch.cuda.max_memory_allocated() - base) / 2 ** 20


def without_free_lists(plan):
    """An eager plan with its free lists emptied, and those of its scan
    step loops' inner plans: the linker as it ran before free lists, kept
    here to measure what they save."""
    plan.steps = [(fn, node, spec, ()) for fn, node, spec, _ in plan.steps]
    for fn, *_ in plan.steps:
        if getattr(fn, "inner", None) is not None:
            without_free_lists(fn.inner)
    return plan


def captured_vs_eager(tag, captured, eager, functions, n_iter, n_dev=None, extra="",
                      eager_calls=None):
    """One linked function captured (``functions``: the CapturedFunctions a
    call replays) and eager, in turn: wall and device ms a call, the busy
    share, kernels a call, nodes a call, warm-up and capture seconds, peak
    MiB of a call; ``n_iter`` calls a wall time, ``n_dev`` (a quarter of
    them by default) a device time.  With ``eager_calls`` the eager side
    takes the wall time of that many calls alone (no warm-up, no trace: a
    call of hundreds of thousands of kernels takes seconds to trace).
    Returns ``{"captured": ..., "eager": ...}``, each with ``wall``, ``dev``
    and ``by`` (device ms and launches by kernel)."""
    from pytensor_tpu_torch.link.torch import linker as torch_linker

    torch_linker.NODES_RUN = 0
    eager()
    nodes = torch_linker.NODES_RUN
    graphs = [g for f in functions for g in f.graphs.values()]
    row = {}
    for kind, call in (("captured", captured), ("eager", eager)):
        if kind == "eager" and eager_calls:
            row[kind] = {"wall": wall_ms(call, eager_calls, warmup=0), "dev": float("nan"),
                         "by": {}, "peak": float("nan")}
            continue
        wall = wall_ms(call, n_iter)
        dev, by = device_ms(call, n_dev or max(1, n_iter // 4))
        row[kind] = {"wall": wall, "dev": dev, "by": by, "peak": peak_mb(call)}
    c, e = row["captured"], row["eager"]

    def kernels(r):
        return f"{sum(n for _, n in r['by'].values()):.0f}" if r["by"] else "(not traced)"

    say(f"linked {tag}: captured wall {c['wall']:.4f} ms/call, device {c['dev']:.4f} ms, "
        f"busy {c['dev'] / c['wall']:.3f}, {kernels(c)} kernels/call, peak "
        f"{c['peak']:.3f} MiB a call; eager wall {e['wall']:.4f} ms/call, device "
        f"{e['dev']:.4f} ms, busy {e['dev'] / e['wall']:.3f}, {kernels(e)} kernels/call, peak "
        f"{e['peak']:.3f} MiB; {nodes} nodes a call; {len(graphs)} graph(s): warm-up "
        + ", ".join(f"{g.warmup_s:.3f}" for g in graphs) + " s, capture "
        + ", ".join(f"{g.capture_s:.3f}" for g in graphs) + f" s{extra}")
    return row


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


# --- the logistic-regression and MLP slice ----------------------------------------

# the logistic-regression step of benchsuite.py:64 ours_logreg and the MLP
# "MFU" step of models/mlp.py at benchsuite's widths, float32
LOGREG_N, LOGREG_D, LOGREG_STEPS, LOGREG_LR = 8192, 256, 32, 0.1
MFU_BATCH, MFU_D, MFU_DEPTH, MFU_STEPS, MFU_LR = 4096, 4096, 4, 4, 1e-3
# the steps against a float64 NumPy evaluation of the same SGD steps:
# float32 sums of 8,192 (logreg) and 4,096 (MFU) products, carried over 32
# and 4 steps.  The loss relative; the logreg parameters (from 0) over
# max(1, max|ref|); the MFU weights over max|ref|.  An MFU step (lr 1e-3,
# the mean of 16.7M squares) moves most weights by less than half a float32
# ulp, so the weights hold to float32 resolution and the losses hold the
# steps; the line prints the reference's update beside that rounding.
# So the MFU step is held twice more.  Its gradients at the start (the
# same graph linked with them as outputs) over max|ref| a layer, against a
# float64 step that takes the card's side of relu's kink where a product
# lies within rounding of 0 (else one product moves a row of each earlier
# layer's gradient: on the CPU at widths 256-2048 such runs read 2e-3 to
# 2e-1, and the matched ones 2e-6 to 2.3e-4, the largest where the last
# layer's sums cancel).  And its update, where it shows: each weight's
# error beyond its float32 rounding over the largest update of its layer,
# which a dropped update raises to O(1); the step against that float64
# step, the loop against as many calls of the step
MODEL_TOL = {"logreg_loss": 2e-5, "logreg_params": 2e-5, "mfu_loss": 2e-5, "mfu_params": 1e-6,
             "mfu_grads": 1e-3, "mfu_update": 1e-3}
# the K2 cases of the new ops against their step loops, over max(1, max|loop|)
K2_CASE_TOL = 1e-6


def logreg_reference(X, y, lr, steps):
    """The logistic-regression SGD steps in float64 NumPy from w = 0, b = 0:
    the loss of the last step (before its update) and the final w, b."""
    X, y = X.astype("float64"), y.astype("float64")
    w, b = np.zeros(X.shape[1]), 0.0
    eps = float(np.float32(1e-7))
    for _ in range(steps):
        p = 1.0 / (1.0 + np.exp(-(X @ w + b)))
        loss = -np.mean(y * np.log(p + eps) + (1 - y) * np.log(1 - p + eps))
        dp = -(y / (p + eps) - (1 - y) / (1 - p + eps)) / X.shape[0]
        gz = dp * p * (1 - p)
        w, b = w - lr * (X.T @ gz), b - lr * gz.sum()
    return loss, w, b


def phase_models(dev, smi_line):
    """Phase 11: the logistic-regression step (n = 8,192, d = 256) through
    ``function()`` and as a 32-step ``train_loop``, and the MFU step
    (float32, 4,096 x 4,096, depth 4) through ``function()`` and as a 4-step
    ``train_loop``, each captured: K1's launches in one replayed call, the
    replay's sha256 against the eager plan's from the same state, the loss
    and parameters against a float64 NumPy evaluation of the same steps,
    the MFU step's gradients and update (``MODEL_TOL``), each of the steps'
    K1 kernels on the inputs the first step gives it against its plain
    version, then wall and device ms, busy share, steps/s, the kernels that
    take the card's time and, for the MFU step, its float32 TFLOP/s.
    Returns the launches of each path and K1's largest absolute error.  On
    the CPU (a rehearsal at small sizes) it checks the values only."""
    import torch

    import pytensor_tpu_torch as ptt
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.cuda import scan_kernel, spmv_kernel
    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction, fgraph_to_torch
    from pytensor_tpu_torch.models import radon_kernel
    from pytensor_tpu_torch.models.logreg import make_logreg_training_step
    from pytensor_tpu_torch.models.mlp import make_mlp_mfu_step, mlp_mfu_graph, mlp_mfu_reference
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    on_card = dev.type == "cuda"
    t11 = time.perf_counter()

    def reset(params, values):
        # copies: a call updates the shared tensors in place
        for v, x in zip(params, values):
            v.set_value(x.clone())

    def state(params):
        return [v.get_value(borrow=True) for v in params]

    models = {}
    # logistic regression, n = 8,192, d = 256: the step through function()
    # and the 32-step train_loop of benchsuite.py:64 ours_logreg
    for tag, steps in (("logreg step", 1), (f"logreg train_loop x{LOGREG_STEPS}", LOGREG_STEPS)):
        f, (Xv, yv), params = make_logreg_training_step(
            LOGREG_N, LOGREG_D, "float32", LOGREG_LR, n_steps_per_call=steps, device=dev)
        with config.change_flags(xla__jit=False):
            f_e, _, params_e = make_logreg_training_step(
                LOGREG_N, LOGREG_D, "float32", LOGREG_LR, n_steps_per_call=steps, device=dev)
        models[tag] = (f, f_e, params, params_e, [as_torch(Xv, dev), as_torch(yv, dev)], steps,
                       8 * LOGREG_N * LOGREG_D * steps, (Xv, yv))
    # the MFU step, float32 at benchsuite's widths: function() and a
    # 4-step train_loop
    for tag, steps in (("mfu step", 1), (f"mfu train_loop x{MFU_STEPS}", MFU_STEPS)):
        f, flops, (Xd, Td) = make_mlp_mfu_step(MFU_BATCH, MFU_D, MFU_DEPTH, "float32", MFU_LR,
                                                n_steps_per_call=steps, device=dev)
        with config.change_flags(xla__jit=False):
            f_e = make_mlp_mfu_step(MFU_BATCH, MFU_D, MFU_DEPTH, "float32", MFU_LR,
                                    n_steps_per_call=steps, device=dev)[0]
        params = sorted((v for v in f.shared_vars if v.name.startswith("W")),
                        key=lambda v: v.name)
        params_e = sorted((v for v in f_e.shared_vars if v.name.startswith("W")),
                          key=lambda v: v.name)
        models[tag] = (f, f_e, params, params_e, [Xd, Td], steps, flops * steps, None)
    say(f"models linked for the card in {time.perf_counter() - t11:.2f} s: "
        + ", ".join(f"{tag} {type(m[0].linked).__name__}" for tag, m in models.items()))
    model_launches, model_rows = {}, {}
    for tag, (f, f_e, params, params_e, args, steps, work, _) in models.items():
        if on_card and not isinstance(f.linked, CapturedFunction):
            raise AssertionError(f"{tag}: not captured: {f.linked.host_reads}")
        init = [v.get_value() for v in params]
        f(*args)  # the capturing call
        reset(params, init)
        fused_kernel.LAUNCHES = radon_kernel.LAUNCHES = scan_kernel.LAUNCHES = 0
        spmv_kernel.LAUNCHES = 0
        loss = f(*args)
        if on_card:
            torch.cuda.synchronize()
        model_launches[tag] = {"fused_elemwise": fused_kernel.LAUNCHES,
                               "scan_whole_loop": scan_kernel.LAUNCHES}
        # a train_loop fuses nothing inside its scan (as in the JAX package)
        if on_card and steps == 1 and fused_kernel.LAUNCHES < 1:
            raise AssertionError(f"{tag}: K1 was not launched: {model_launches[tag]}")
        after = [v.get_value() for v in params]
        # the replayed call against the eager plan, from the same state
        reset(params_e, init)
        loss_e = f_e(*args)
        d_cap, d_eager = digest(loss, *after), digest(loss_e, *state(params_e))
        if d_cap != d_eager:
            raise AssertionError(f"{tag}: the replay differs from the eager plan")
        say(f"{tag}: one replayed call launched {model_launches[tag]}; sha256 of the loss and "
            f"the parameters after it: replayed {d_cap}, eager {d_eager}")
        models[tag] = models[tag] + (float(loss), after, init)
    # the MFU step's gradients at the start: the same graph, linked with
    # them and the products before each relu as outputs, from the same ramps
    t_ref = time.perf_counter()
    X, T, Ws, acts, g_loss, grads, _, (Xg, Tg) = mlp_mfu_graph(MFU_BATCH, MFU_D, MFU_DEPTH,
                                                               "float32", MFU_LR, dev)
    mfu_init = models["mfu step"][10]
    if not all(torch.equal(W.get_value(borrow=True), x) for W, x in zip(Ws, mfu_init)):
        raise AssertionError("the gradient graph's ramps are not the step's weights")
    f_g = ptt.function([X, T], [g_loss, *grads, *acts], device=dev, trust_input=True)
    got = f_g(Xg, Tg)
    g_loss, g_grads = float(got[0]), [g.cpu().numpy() for g in got[1:1 + MFU_DEPTH]]
    masks = [(a >= 0).cpu().numpy() for a in got[1 + MFU_DEPTH:]]
    kind = type(f_g.linked).__name__
    del f_g, got, Ws
    # the float64 steps, the first on the sides of relu's kink the card took
    mfu_ref = mlp_mfu_reference(Xg.cpu().numpy(), Tg.cpu().numpy(),
                                [x.cpu().numpy() for x in mfu_init], MFU_LR, MFU_STEPS, masks)
    r_grads = mfu_ref[2]
    e_grads = [float(np.max(np.abs(g.astype("float64") - r)) / np.max(np.abs(r)))
               for g, r in zip(g_grads, r_grads)]
    e_gl = abs(g_loss - mfu_ref[0][0]) / abs(mfu_ref[0][0])
    if not (max(e_grads) <= MODEL_TOL["mfu_grads"] and e_gl <= MODEL_TOL["mfu_loss"]
            and all(np.isfinite(g).all() for g in g_grads)):
        raise AssertionError(f"mfu gradients: max err over max|ref| {e_grads}, loss {e_gl}; "
                             f"tol {MODEL_TOL}")
    say(f"mfu gradients ({kind}): max err over max|ref| a layer "
        f"{', '.join(f'{e:.2e}' for e in e_grads)} (tol {MODEL_TOL['mfu_grads']:g}); loss rel "
        f"err {e_gl:.2e}; the float64 step on the card's sides of relu's kink "
        f"({sum(int(m.size - m.sum()) for m in masks):,} of {sum(m.size for m in masks):,} "
        f"products below 0)")
    del g_grads, masks

    def update_error(after, ref, init, rounding):
        """The weights' error beyond ``rounding`` float32 ulps of each
        weight, over the largest update of its layer, the largest over the
        layers; and the smallest over the layers that the start reads."""
        worst, dropped = 0.0, []
        for a, r, x in zip(after, ref, init):
            a, r, x = (np.asarray(v, dtype="float64") for v in (a, r, x))
            top = float(np.max(np.abs(r - x)))
            for w, sink in ((a, None), (x, dropped)):
                ulp = np.spacing(np.maximum(np.abs(w), np.abs(r)).astype("float32"))
                beyond = float(np.max(np.abs(w - r) - rounding * ulp.astype("float64")))
                if sink is None:
                    worst = max(worst, max(0.0, beyond) / top)
                else:
                    sink.append(max(0.0, beyond) / top)
        return worst, min(dropped)

    # against float64 NumPy: the logreg steps from w = 0, the MFU steps from
    # the ramps
    for tag, m in models.items():
        f, f_e, params, params_e, args, steps, work, data, loss, after, init = m
        if tag.startswith("logreg"):
            r_loss, r_w, r_b = logreg_reference(*data, LOGREG_LR, steps)
            ref_params, tol_l, tol_p = [r_w, np.asarray(r_b)], "logreg_loss", "logreg_params"
        else:
            losses, weights, _ = mfu_ref
            r_loss, ref_params = losses[steps - 1], weights[steps - 1]
            tol_l, tol_p = "mfu_loss", "mfu_params"
        e_loss = abs(loss - r_loss) / abs(r_loss)
        after_np = [a.cpu().numpy() for a in after]
        init_np = [x.cpu().numpy() for x in init]
        if tag.startswith("logreg"):
            e_par = max(errors(a, b)[1] for a, b in zip(after_np, ref_params))
            ok_par = e_par <= MODEL_TOL["logreg_params"]
        else:
            e_par, ref2, floor2 = 0.0, 0.0, 0.0
            for a, r, x in zip(after_np, ref_params, init_np):
                a, x = a.astype("float64"), x.astype("float64")
                e_par = max(e_par, float(np.max(np.abs(a - r)) / np.max(np.abs(r))))
                ref2 += float(np.sum((r - x) ** 2))
                floor2 += float(np.sum((0.5 * np.spacing(np.abs(r).astype("float32"))) ** 2))
            if steps == 1:
                # the update against the float64 step: half an ulp of rounding
                e_upd, e_drop = update_error(after_np, ref_params, init_np, 0.5)
                against = "the float64 step"
            else:
                # the loop against as many calls of the step from the same
                # start: two float32 trajectories, an ulp a step between them
                f1, p1 = models["mfu step"][0], models["mfu step"][2]
                reset(p1, init)
                for _ in range(steps):
                    f1(*args)
                by_calls = [v.get_value().cpu().numpy() for v in p1]
                e_upd, e_drop = update_error(after_np, by_calls, init_np, float(steps))
                against = f"{steps} calls of the step"
            ok_par = e_par <= MODEL_TOL["mfu_params"] and e_upd <= MODEL_TOL["mfu_update"]
            if not e_drop > MODEL_TOL["mfu_update"]:
                raise AssertionError(f"{tag}: the update hold cannot see the update: a dropped "
                                     f"update would read {e_drop}")
        finite = np.isfinite(loss) and all(np.isfinite(a).all() for a in after_np)
        if not (finite and ok_par and e_loss <= MODEL_TOL[tol_l]):
            raise AssertionError(f"{tag}: loss rel err {e_loss}, parameters {e_par}"
                                 + ("" if tag.startswith("logreg") else f", update {e_upd}")
                                 + f" vs float64 NumPy; tol {MODEL_TOL}")
        what = (f"parameters: max err over max(1, max|ref|) {e_par:.2e} (tol "
                f"{MODEL_TOL[tol_p]:g})" if tag.startswith("logreg") else
                f"weights: max err over max|ref| {e_par:.2e} (tol {MODEL_TOL[tol_p]:g}); the "
                f"reference's update is {(ref2 / floor2) ** 0.5:.3g} times half a float32 ulp "
                f"of the weights, norm-wise; the update against {against}, beyond the weights' "
                f"rounding, over the largest: {e_upd:.2e} (tol {MODEL_TOL['mfu_update']:g}; a "
                f"dropped update reads {e_drop:.3g})")
        say(f"{tag}: loss {loss:.7f} vs float64 NumPy {r_loss:.7f} (rel err {e_loss:.2e}, tol "
            f"{MODEL_TOL[tol_l]:g}); after {steps} step(s), {what}")
    del mfu_ref
    say(f"float64 NumPy references in {time.perf_counter() - t_ref:.1f} s")
    # K1 on the steps' own fused nodes, each on the inputs the first step
    # gives it (computed on the card from the initial state), against its
    # plain version; these launches come after the counted calls
    k1_abs, k1_rows = 0.0, []
    for tag, m in models.items():
        f, params, args, init = m[0], m[2], m[4], m[10]
        nodes = [nd for nd in f.fgraph.toposort() if isinstance(nd.op, FusedElemwise)]
        if not nodes:
            continue
        reset(params, init)
        needed = [i for nd in nodes for i in nd.inputs]
        feed = fgraph_to_torch(FunctionGraph(f.fgraph.inputs, needed, clone=True), dev)
        values = iter(feed(*args, *state(f.shared_vars)))
        for nd in nodes:
            xs = [next(values) for _ in nd.inputs]
            kern = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
            # (on the CPU the wrapper runs the plain version)
            got, want = (kern.launch if on_card else kern)(*xs), kern.plain(*xs)
            dt = nd.outputs[0].type.dtype
            pairs = [errors(g.cpu(), w.cpu()) for g, w in zip(got, want)]
            err = max(p[1] for p in pairs)
            k1_abs = max([k1_abs] + [p[0] for p in pairs])
            tol = K1_RTOL.get(dt, 0.0)
            if not (err <= tol and all(g.shape == w.shape for g, w in zip(got, want))):
                raise AssertionError(f"K1 {tag} {nd.op}: rel err {err} > {tol}")
            node_ms = wall_ms(lambda: kern.launch(*xs), 20) if on_card else 0.0
            node_plain = wall_ms(lambda: kern.plain(*xs), 20) if on_card else 0.0
            k1_rows.append(err)
            say(f"  K1 {tag} {str(nd.op)[:70]:70s} out {tuple(got[0].shape)} err {err:.2e} "
                f"wall: kernel {node_ms * 1e3:.1f} us plain {node_plain * 1e3:.1f} us")
    if not k1_rows:
        raise AssertionError("no fused node in the logreg and MFU steps")
    say(f"K1 on the steps' fused nodes: {len(k1_rows)} kernels held against their plain "
        f"version at the steps' shapes, max rel err {max(k1_rows):.2e} (tol {K1_RTOL})")
    for tag, m in models.items() if on_card else ():
        f, f_e, params, params_e, args, steps, work = m[:7]
        n_iter = 20 if tag.startswith("logreg") else 3
        row = captured_vs_eager(tag, lambda f=f, a=args: f(*a), lambda f=f_e, a=args: f(*a),
                                [f.linked], n_iter, n_dev=max(2, n_iter // 4))
        c = row["captured"]
        k1_by = [(ms, n) for kn, (ms, n) in c["by"].items() if "k1_" in kn]
        extra = ""
        if tag.startswith("mfu"):
            extra = (f"; {work / c['dev'] / 1e9:,.1f} TFLOP/s float32 on the card's time, "
                     f"{work / c['wall'] / 1e9:,.1f} on the wall ({work / 1e12:.3f} TFLOP a call), "
                     f"against the card's float32 peak of {F32_OPS_S / 1e12:.0f} TFLOP/s outside "
                     f"the tensor cores (TF32 off)")
        say(f"{tag} ({smi_line}): wall {c['wall']:.4f} ms/call, device {c['dev']:.4f} ms, busy "
            f"{c['dev'] / c['wall']:.3f}, {steps * 1e3 / c['wall']:,.1f} steps/s; K1 "
            f"{model_launches[tag]['fused_elemwise']} launches a call, "
            f"{sum(ms for ms, _ in k1_by):.4f} ms of device time{extra}")
        for kname, (ms, count) in sorted(c["by"].items(), key=lambda kv: -kv[1][0])[:5]:
            say(f"  {tag}: {ms:.4f} ms/call  {count:.0f} launches/call  {kname[:90]}")
        model_rows[tag] = row
    say(f"models phase done in {time.perf_counter() - t11:.1f} s")
    return model_launches, k1_abs


# --- the Elman RNN BPTT slice ------------------------------------------------------

# the Elman step of benchsuite.py:121 ours_elman (models/rnn.py), float32,
# batch 4 as the JAX package makes its data, through function() and as a
# 16-step train_loop; one more reading of the step at batch 1,024
ELMAN_SEQ, ELMAN_IN, ELMAN_HIDDEN, ELMAN_LR = 64, 32, 128, 0.01
ELMAN_LOOP, ELMAN_WIDE = 16, 1024
# the static BPTT under scan__pallas: tanh(dot(W, h)), W 128 x 128, 64 steps
BPTT_N, BPTT_STEPS = 128, 64
# the Elman step against rnn_reference (float64 NumPy BPTT): the first
# loss relative; each gradient over its max|ref|; the weights after one
# step and after 16 (the loop, and 16 calls of the step) over the largest
# update of each weight (a dropped update reads 1), the loop against 16
# calls of the step the same way; the loop's last loss is near 0 (the
# four samples are fitted), so it is held absolutely, over the first loss.
# On an H100 80GB HBM3 at 700 W: 4.9e-8, 5.8e-7, 4.5e-6, 3.3e-5, 9.8e-6
# and 7.9e-14; held at ~10x those readings (the loss at the CPU's 2.2e-7
# times 2).  The static BPTT's loss and gradients, and K2's forward scan,
# against the step loop over max(1, max|loop|): 6.6e-7 and 8.2e-7 there
ELMAN_TOL = {"loss": 5e-7, "grads": 6e-6, "update": 5e-5, "update16": 3e-4,
             "loop_vs_calls": 1e-4, "loop_loss": 1e-9, "bptt": 1e-5}


def static_bptt(ptt, pt):
    """The static-shaped BPTT of phase 12: ``(inputs, outputs)``."""
    v0 = pt.tensor("v0", dtype="float32", shape=(BPTT_N,))
    W = pt.tensor("W", dtype="float32", shape=(BPTT_N, BPTT_N))
    tr, _ = ptt.scan(lambda acc, w: pt.tanh(pt.dot(w, acc)), outputs_info=[v0],
                     non_sequences=[W], n_steps=BPTT_STEPS, name="bptt")
    loss = (tr ** 2).sum()
    return [v0, W], [loss, *ptt.grad(loss, [v0, W])]


def elman_kernels(dev):
    """The K1 kernels of the Elman step (its graph rewritten on the CPU, so
    the same sources as linking it for the card) and K2 of the static
    BPTT's forward scan, for the build pool of phase 2."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda import scan_kernel
    from pytensor_tpu_torch.models.rnn import elman_graph, make_elman_rnn_bptt
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    step = make_elman_rnn_bptt(ELMAN_SEQ, ELMAN_IN, ELMAN_HIDDEN, "float32", lr=ELMAN_LR,
                               device="cpu")[0]
    X, y, _, loss, grads, updates, _, _ = elman_graph(ELMAN_SEQ, ELMAN_IN, ELMAN_HIDDEN,
                                                      "float32", ELMAN_LR, device="cpu")
    with_grads = ptt.function([X, y], [loss, *grads], updates=updates, device="cpu")
    k1 = [fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
          for f in (step, with_grads) for nd in f.fgraph.toposort()
          if isinstance(nd.op, FusedElemwise)]
    with config.change_flags(scan__pallas=True):
        bptt = ptt.function(*static_bptt(ptt, pt), device="cpu")
    k2 = [scan_kernel.ScanKernel(nd.op, nd, dev) for nd in bptt.fgraph.toposort()
          if type(nd.op).__name__ == "Scan" and scan_kernel.scan_kernel_eligible(nd.op, nd)]
    return k1, k2


def phase_elman(dev, smi_line):
    """Phase 12: the Elman BPTT step of ``benchsuite.py:121 ours_elman``
    (seq 64, n_in 32, hidden 128, float32, batch 4) through ``function()``
    and as a 16-step ``train_loop``, each captured, with its eager twin:
    K1's and K2's launches in one replayed call (counts set to 0 just
    before it), the replay's sha256 against the eager plan's from the same
    state, the loss and weights against ``rnn_reference`` (float64 NumPy
    BPTT), the loop against 16 calls of the step, the step's gradients
    (its graph linked with them as outputs) against the reference, each
    of the step's K1 nodes against its plain version at the step's shapes;
    then the static BPTT under ``scan__pallas`` (K2 once for the forward
    scan, not for the reverse one; K2 against its step loop, the gradient
    against the step loop's); then wall and device ms a call, busy share,
    steps/s, kernels a call with the top ones by name, the flips' copies a
    call, and the step at batch 1,024.  Returns the launches of each path
    and K1's and K2's largest absolute errors.  On the CPU (a rehearsal at
    small sizes) it checks the values only."""
    import torch

    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.cuda import scan_kernel, spmv_kernel
    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction, fgraph_to_torch
    from pytensor_tpu_torch.models import radon_kernel
    from pytensor_tpu_torch.models.rnn import elman_graph, make_elman_rnn_bptt, rnn_reference
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    on_card = dev.type == "cuda"
    t12 = time.perf_counter()
    shape = (ELMAN_SEQ, ELMAN_IN, ELMAN_HIDDEN, "float32")

    def zero():
        fused_kernel.LAUNCHES = radon_kernel.LAUNCHES = scan_kernel.LAUNCHES = 0
        spmv_kernel.LAUNCHES = 0

    def counts():
        if on_card:
            torch.cuda.synchronize()
        return {"fused_elemwise": fused_kernel.LAUNCHES, "scan_whole_loop": scan_kernel.LAUNCHES}

    def weights(ws):
        return [w.get_value() for w in ws]

    def reset(ws, values):
        for w, v in zip(ws, values):
            w.set_value(v.clone())

    paths, launches = {}, {}
    for tag, steps in (("elman step", 1), ("elman loop", ELMAN_LOOP)):
        f, (Xv, yv), ws = make_elman_rnn_bptt(*shape, n_steps_per_call=steps, lr=ELMAN_LR,
                                              device=dev)
        with config.change_flags(xla__jit=False):
            f_e, _, ws_e = make_elman_rnn_bptt(*shape, n_steps_per_call=steps, lr=ELMAN_LR,
                                               device=dev)
        plan = f.linked.plan if isinstance(f.linked, CapturedFunction) else f.linked
        if plan.host_reads or (on_card and not isinstance(f.linked, CapturedFunction)):
            raise AssertionError(f"{tag}: not captured: {plan.host_reads}")
        args = [as_torch(Xv, dev), as_torch(yv, dev)]
        init = weights(ws)
        f(*args)  # the capturing call
        reset(ws, init)
        zero()
        loss = float(f(*args))
        launches[tag] = counts()
        if launches[tag]["scan_whole_loop"] or (on_card and steps == 1
                                                and launches[tag]["fused_elemwise"] < 1):
            raise AssertionError(f"{tag}: launched {launches[tag]}: K1 on the step's fused "
                                 "nodes, K2 on no Elman scan")
        after = weights(ws)
        reset(ws_e, init)
        loss_e = f_e(*args)
        d_cap, d_eager = digest(torch.tensor(loss), *after), digest(loss_e.cpu(), *weights(ws_e))
        if d_cap != d_eager:
            raise AssertionError(f"{tag}: the replay differs from the eager plan")
        say(f"{tag}: one replayed call launched {launches[tag]}; sha256 of the loss and the "
            f"weights after it: replayed {d_cap}, eager {d_eager}")
        paths[tag] = (f, f_e, ws, args, steps, loss, after, init, (Xv, yv))

    # against the float64 NumPy BPTT, from the weights the seed gives
    f, _, ws, args, _, loss, after, init, (Xv, yv) = paths["elman step"]
    w0 = [x.cpu().numpy() for x in init]
    losses, r_grads, r_after = rnn_reference(Xv, yv, *w0, ELMAN_LR, ELMAN_LOOP)

    def update_err(got, ref, start):
        """max over the weights of max|got - ref| over the largest update."""
        return max(float(np.max(np.abs(np.asarray(g, "float64") - r))
                         / np.max(np.abs(r - x))) for g, r, x in zip(got, ref, start))

    e_loss = abs(loss - losses[0]) / losses[0]
    e_upd = update_err([a.cpu().numpy() for a in after], r_after[0], w0)
    e_drop = update_err(w0, r_after[0], w0)
    # the step's gradients: its graph linked with them as outputs
    X, y, ws_g, g_loss, grads, updates, _, _ = elman_graph(*shape, ELMAN_LR, device=dev)
    f_g = ptt.function([X, y], [g_loss, *grads], updates=updates, device=dev)
    got = f_g(*args)
    e_gloss = abs(float(got[0]) - losses[0]) / losses[0]
    e_grads = [float(np.max(np.abs(g.cpu().numpy().astype("float64") - r)) / np.max(np.abs(r)))
               for g, r in zip(got[1:], r_grads)]
    e_gupd = update_err([w.get_value().cpu().numpy() for w in ws_g], r_after[0], w0)
    # the loop against the reference and against 16 calls of the step
    f_l, _, ws_l, _, _, loss_l, after_l, _, _ = paths["elman loop"]
    reset(ws, init)
    for _ in range(ELMAN_LOOP):
        f(*args)
    by_calls = [w.get_value().cpu().numpy() for w in ws]
    after_l = [a.cpu().numpy() for a in after_l]
    e_loop16 = update_err(after_l, r_after[-1], w0)
    e_calls16 = update_err(by_calls, r_after[-1], w0)
    e_loop_calls = max(float(np.max(np.abs(a.astype("float64") - c)) / np.max(np.abs(r - x)))
                       for a, c, r, x in zip(after_l, by_calls, r_after[-1], w0))
    e_loop_loss = abs(loss_l - losses[-1]) / losses[0]
    finite = all(np.isfinite(v).all() for v in [*after_l, *by_calls, loss, loss_l])
    checks = {"loss": max(e_loss, e_gloss), "grads": max(e_grads), "update": max(e_upd, e_gupd),
              "update16": max(e_loop16, e_calls16), "loop_vs_calls": e_loop_calls,
              "loop_loss": e_loop_loss}
    if not (finite and all(v <= ELMAN_TOL[k] for k, v in checks.items()) and e_drop > 0.5):
        raise AssertionError(f"elman against float64 NumPy: {checks} (a dropped update reads "
                             f"{e_drop}); tol {ELMAN_TOL}")
    say(f"elman step: loss {loss:.7f} vs float64 NumPy {losses[0]:.7f} (rel err {e_loss:.2e}); "
        f"the gradients linked as outputs: max err over max|ref| "
        f"{', '.join(f'{e:.2e}' for e in e_grads)} (Wx, Wh, Wo), loss {e_gloss:.2e}; the weights "
        f"after the step, over the largest update: {e_upd:.2e} ({e_gupd:.2e} with the "
        f"gradients as outputs; a dropped update reads {e_drop:.3g})")
    say(f"elman loop x{ELMAN_LOOP}: weights over the largest update of 16 float64 steps: "
        f"{e_loop16:.2e}, 16 calls of the step {e_calls16:.2e}, the loop against those calls "
        f"{e_loop_calls:.2e}; last loss {loss_l:.3e} vs {losses[-1]:.3e} (err over the first "
        f"loss {e_loop_loss:.2e}); tol {ELMAN_TOL}")
    del f_g, got

    # K1 on the step's fused nodes, on the inputs the first step gives them
    k1_abs, k1_rows = 0.0, []
    reset(ws, init)
    nodes = [nd for nd in f.fgraph.toposort() if isinstance(nd.op, FusedElemwise)]
    needed = [i for nd in nodes for i in nd.inputs]
    feed = fgraph_to_torch(FunctionGraph(f.fgraph.inputs, needed, clone=True), dev)
    values = iter(feed(*args, *[v.get_value(borrow=True) for v in f.shared_vars]))
    for nd in nodes:
        xs = [next(values) for _ in nd.inputs]
        kern = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
        got, want = (kern.launch if on_card else kern)(*xs), kern.plain(*xs)
        pairs = [errors(g.cpu(), w.cpu()) for g, w in zip(got, want)]
        err = max(p[1] for p in pairs)
        k1_abs = max([k1_abs] + [p[0] for p in pairs])
        tol = K1_RTOL.get(nd.outputs[0].type.dtype, 0.0)
        if not (err <= tol and all(g.shape == w.shape for g, w in zip(got, want))):
            raise AssertionError(f"K1 elman step {nd.op}: rel err {err} > {tol}")
        node_ms = wall_ms(lambda: kern.launch(*xs), 20) if on_card else 0.0
        node_plain = wall_ms(lambda: kern.plain(*xs), 20) if on_card else 0.0
        k1_rows.append(err)
        say(f"  K1 elman step {str(nd.op)[:70]:70s} out {tuple(got[0].shape)} "
            f"{nd.outputs[0].type.dtype} err {err:.2e} wall: kernel {node_ms * 1e3:.1f} us "
            f"plain {node_plain * 1e3:.1f} us")
    if len(k1_rows) != 4:
        raise AssertionError(f"the Elman step has {len(k1_rows)} fused nodes, the JAX package 4")
    say(f"K1 on the Elman step's fused nodes: {len(k1_rows)} kernels held against their plain "
        f"version, max rel err {max(k1_rows):.2e} (tol {K1_RTOL})")

    # the static BPTT under scan__pallas: K2 takes the forward scan only
    rng = np.random.default_rng(5)
    b_vals = [as_torch(rng.standard_normal(BPTT_N).astype("float32"), dev),
              as_torch((rng.standard_normal((BPTT_N, BPTT_N)) * 0.1).astype("float32"), dev)]
    fns = {}
    for pallas in (True, False):
        with config.change_flags(scan__pallas=pallas):
            fns[pallas] = ptt.function(*static_bptt(ptt, pt), device=dev)
    plan_b = fns[True].linked.plan if isinstance(fns[True].linked, CapturedFunction) \
        else fns[True].linked
    decisions = {nd.op.name: isinstance(fn, scan_kernel.ScanKernel)
                 for fn, nd, _, _ in plan_b.steps if type(nd.op).__name__ == "Scan"}
    if decisions != {"bptt": True, "grad_of_bptt": False}:
        raise AssertionError(f"static BPTT under scan__pallas: K2 takes {decisions}")
    fns[True](*b_vals)  # the capturing call
    zero()
    got = fns[True](*b_vals)
    launches["bptt (scan__pallas)"] = counts()
    if on_card and launches["bptt (scan__pallas)"]["scan_whole_loop"] != 1:
        raise AssertionError(f"static BPTT: {launches['bptt (scan__pallas)']}, K2 once expected")
    want = fns[False](*b_vals)
    e_b = [errors(g.cpu(), w.cpu())[1] for g, w in zip(got, want)]
    # K2 itself against its plain version, on the inputs the graph gives it
    kern, node_b = next((fn, nd) for fn, nd, _, _ in plan_b.steps
                        if isinstance(fn, scan_kernel.ScanKernel))
    feed = fgraph_to_torch(FunctionGraph(plan_b.fgraph.inputs, node_b.inputs, clone=False), dev)
    outer = feed(*b_vals)
    k2_got = (kern.launch if on_card else kern)(*outer)
    k2_want = kern.plain(*outer)
    k2_pairs = [errors(g.cpu(), w.cpu()) for g, w in zip(k2_got, k2_want)]
    k2_abs = max(p[0] for p in k2_pairs)
    if not (max(e_b) <= ELMAN_TOL["bptt"] and max(p[1] for p in k2_pairs) <= ELMAN_TOL["bptt"]):
        raise AssertionError(f"static BPTT: loss and gradients {e_b}, K2 {k2_pairs}; tol "
                             f"{ELMAN_TOL['bptt']}")
    say(f"static BPTT under scan__pallas (v {BPTT_N}, W {BPTT_N}x{BPTT_N}, {BPTT_STEPS} steps): "
        f"K2 takes {decisions}; one replayed call launched {launches['bptt (scan__pallas)']}; "
        f"loss and gradients against the step loop, over max(1, max|loop|): "
        f"{', '.join(f'{e:.2e}' for e in e_b)}; K2 against its plain version "
        f"{max(p[1] for p in k2_pairs):.2e} (tol {ELMAN_TOL['bptt']:g})")
    if not on_card:
        return launches, k1_abs, k2_abs

    # the times: captured and eager in turn, per call
    for tag, (f, f_e, ws, args, steps, *_rest) in paths.items():
        # an eager loop call takes ~1.9 s on the host
        n_iter = 20 if steps == 1 else 4
        row = captured_vs_eager(tag, lambda f=f, a=args: f(*a), lambda f=f_e, a=args: f(*a),
                                [f.linked], n_iter, n_dev=max(2, n_iter // 4))
        c = row["captured"]
        k1_by = [(ms, n) for kn, (ms, n) in c["by"].items() if "k1_" in kn]
        flips = sum(n for kn, (ms, n) in c["by"].items() if "index" in kn.lower())
        n_kern = sum(n for _, n in c["by"].values())
        say(f"{tag} ({smi_line}): wall {c['wall']:.4f} ms/call, device {c['dev']:.4f} ms, busy "
            f"{c['dev'] / c['wall']:.3f}, {steps * 1e3 / c['wall']:,.1f} steps/s; "
            f"{n_kern:.0f} kernels a call ({n_kern / steps:.0f} a step), "
            f"{c['dev'] / n_kern * 1e3:.2f} us of device time a kernel; K1 "
            f"{launches[tag]['fused_elemwise']} launches a call, "
            f"{sum(ms for ms, _ in k1_by):.4f} ms of device time; K2 "
            f"{launches[tag]['scan_whole_loop']}; index kernels (the flips' copies) "
            f"{flips:.0f} a call")
        for kname, (ms, count) in sorted(c["by"].items(), key=lambda kv: -kv[1][0])[:6]:
            say(f"  {tag}: {ms:.4f} ms/call  {count:.0f} launches/call  {kname[:90]}")
    # the step at batch 1,024: a new signature, so a new capture
    f, f_e, ws, *_ = paths["elman step"]
    wide = [as_torch(rng.standard_normal((ELMAN_SEQ, ELMAN_WIDE, ELMAN_IN)).astype("float32"), dev),
            as_torch(rng.standard_normal(ELMAN_WIDE).astype("float32"), dev)]
    row = captured_vs_eager(f"elman step batch {ELMAN_WIDE}", lambda: f(*wide),
                            lambda: f_e(*wide), [f.linked], 20, n_dev=5)
    c = row["captured"]
    say(f"elman step batch {ELMAN_WIDE} ({smi_line}): wall {c['wall']:.4f} ms/call, device "
        f"{c['dev']:.4f} ms, busy {c['dev'] / c['wall']:.3f}, {1e3 / c['wall']:,.1f} steps/s")
    for kname, (ms, count) in sorted(c["by"].items(), key=lambda kv: -kv[1][0])[:6]:
        say(f"  batch {ELMAN_WIDE}: {ms:.4f} ms/call  {count:.0f} launches/call  {kname[:90]}")
    say(f"elman phase done in {time.perf_counter() - t12:.1f} s")
    return launches, k1_abs, k2_abs


# --- the linalg slice ---------------------------------------------------------------

# paths (a)-(c) at benchsuite's widths: the GP SGD step of
# benchsuite.py:143 ours_gp (n 256, float32) and its 64-step train_loop,
# the GP marginal likelihood in float64; the Kalman log-likelihood and
# gradient (64 steps, k 4, p 2, float32) and the 16-step SGD loop of
# benchsuite.py:1129 ours_kalman (with its step); the batched Cholesky of
# benchsuite.py:978 ours_blockwise_chol (batch 128, 64 x 64, float32)
# through function() and its 32-step train_loop
GP_N, GP_LOOP, GP_LR = 256, 64, 1e-3
KALMAN_T, KALMAN_K, KALMAN_P, KALMAN_LOOP, KALMAN_LR = 64, 4, 2, 16, 1e-5
CHOL_BATCH, CHOL_N, CHOL_LOOP = 128, 64, 32
# the linalg paths against float64 NumPy, each relative: GP nmll and
# gradient (over max|g|) at the start, theta after 1 and 64 SGD steps
# over the largest update (a dropped update reads 1), the float64 mll and
# its gradient; the Kalman log-likelihood and its gradient (central
# differences), T after 16 SGD steps over the largest update; the batched
# Cholesky's loss, L over max|L| and its gradient against the identity;
# each loop against as many calls of its step (over max(1, |value|))
# each loop against as many calls of its step (over max(1, |value|)).
# On an H100 80GB HBM3 at 700 W (two runs, the same readings): 5.69e-8,
# 4.66e-8, 4.66e-8, 1.91e-5, 3.25e-17, 4.57e-9, 1.11e-6, 1.61e-5, 2.82e-8,
# 1.45e-7, 9.54e-7, 5.04e-5, 4.31e-8 and 0; held at ~10x those readings,
# and at no less than 4 ulps of the dtype where a reading fell below one
# (the float64 mll, the batched Cholesky's loop)
LINALG_TOL = {"gp_nmll": 6e-7, "gp_grad": 5e-7, "gp_update": 5e-7, "gp_update64": 2e-4,
              "mll64": 1e-15, "kalman_ll": 5e-8, "kalman_grad": 1.2e-5,
              "kalman_update16": 1.6e-4, "chol_loss": 3e-7, "chol_L": 1.5e-6,
              "chol_grad": 1e-5, "gp_loop_vs_calls": 5e-4, "kalman_loop_vs_calls": 4.3e-7,
              "chol_loop_vs_calls": 5e-7}


def linalg_paths(dev):
    """The functions of paths (a)-(c) on ``dev``: ``{tag: (f, state, args,
    steps)}`` with the shared variables a call updates and the arguments
    it takes (numpy values)."""
    from pytensor_tpu_torch.models.batched_cholesky import make_batched_cholesky_step
    from pytensor_tpu_torch.models.gp import make_gp_marginal_likelihood, make_gp_sgd_step
    from pytensor_tpu_torch.models.kalman import (
        make_kalman_loglike_and_grad,
        make_kalman_sgd_step,
    )

    paths = {}
    for tag, steps in (("gp step", 1), (f"gp loop x{GP_LOOP}", GP_LOOP)):
        f, params = make_gp_sgd_step(GP_N, dtype="float32", lr=GP_LR, n_steps_per_call=steps,
                                     device=dev)
        paths[tag] = (f, params, [], steps)
    f, theta0 = make_gp_marginal_likelihood(GP_N, dtype="float64", device=dev)
    paths["gp mll float64"] = (f, [], list(theta0), 1)
    f, theta0, _ = make_kalman_loglike_and_grad(KALMAN_T, KALMAN_K, KALMAN_P, "float32",
                                                device=dev)
    paths["kalman loglike+grad"] = (f, [], list(theta0), 1)
    for tag, steps in (("kalman step", 1), (f"kalman loop x{KALMAN_LOOP}", KALMAN_LOOP)):
        f, T, _ = make_kalman_sgd_step(KALMAN_T, KALMAN_K, KALMAN_P, KALMAN_LR,
                                       n_steps_per_call=steps, device=dev)
        paths[tag] = (f, [T], [], steps)
    for tag, steps in (("chol step", 1), (f"chol loop x{CHOL_LOOP}", CHOL_LOOP)):
        f, A = make_batched_cholesky_step(CHOL_BATCH, CHOL_N, n_steps_per_call=steps,
                                          device=dev)
        paths[tag] = (f, [A], [], steps)
    return paths


def linalg_kernels(dev):
    """The K1 kernels of the linalg paths' functions, their graphs
    rewritten on the CPU (the same sources as linking them for the card),
    for the build pool of phase 2 (phase 13 finds them built)."""
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    return [fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
            for f, *_ in linalg_paths("cpu").values() for nd in f.fgraph.toposort()
            if isinstance(nd.op, FusedElemwise)]


def op_calls(call, name):
    """Calls of the torch op ``name`` (``aten::...``) in one call, from a
    trace of its host side."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    return sum(e.count for e in prof.key_averages() if e.key == name)


def phase_linalg(dev, smi_line):
    """Phase 13: paths (a)-(c) of the linalg slice (``linalg_paths``), each
    captured, with its eager twin: ``Plan.capturable``, K1's and K2's
    launches in one replayed call (counts set to 0 just before it), the
    replay's sha256 against the eager plan's from the same state; the
    values against float64 NumPy (``LINALG_TOL``): the GP's nmll, gradient
    and updates (``models/gp.py gp_reference``), the float64 mll, the
    Kalman log-likelihood and gradient (``numpy_kalman_loglike``, central
    differences) and its loop's update, the batched Cholesky's loss, L and
    gradient, each loop against as many calls of its step; each K1 node of
    the ``function()`` paths against its plain version at the path's
    shapes; Cholesky calls and kernels a step of path (c) (one batched call,
    not 128); then wall and device ms a call, captured and eager, busy
    share, steps/s, kernels a call with the top ones by name.  Returns the
    launches of each path and K1's largest absolute error.  On the CPU (a
    rehearsal at small sizes) it checks the values only."""
    import torch

    import pytensor_tpu_torch as ptt
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.cuda import scan_kernel, spmv_kernel
    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction, fgraph_to_torch
    from pytensor_tpu_torch.models import radon_kernel
    from pytensor_tpu_torch.models.batched_cholesky import spd_stack
    from pytensor_tpu_torch.models.gp import gp_data, gp_reference
    from pytensor_tpu_torch.models.kalman import (
        kalman_sim,
        make_kalman_loglike_and_grad,
        numpy_kalman_grad,
        numpy_kalman_loglike,
    )
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor import linalg as ptl
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    on_card = dev.type == "cuda"
    t13 = time.perf_counter()

    def zero():
        fused_kernel.LAUNCHES = radon_kernel.LAUNCHES = scan_kernel.LAUNCHES = 0
        spmv_kernel.LAUNCHES = 0

    def counts():
        if on_card:
            torch.cuda.synchronize()
        return {"fused_elemwise": fused_kernel.LAUNCHES, "scan_whole_loop": scan_kernel.LAUNCHES}

    def values(state):
        return [v.get_value() for v in state]

    def reset(state, vals):
        for v, x in zip(state, vals):
            v.set_value(x.clone())

    def outs(res):
        return [r for r in (res if isinstance(res, (list, tuple)) else [res])]

    paths = linalg_paths(dev)
    with config.change_flags(xla__jit=False):
        eager = linalg_paths(dev)
    say(f"linalg paths linked for the card in {time.perf_counter() - t13:.2f} s: "
        + ", ".join(f"{tag} {type(p[0].linked).__name__}" for tag, p in paths.items()))
    launches, results = {}, {}
    for tag, (f, state, args, steps) in paths.items():
        f_e, state_e = eager[tag][0], eager[tag][1]
        plan = f.linked.plan if isinstance(f.linked, CapturedFunction) else f.linked
        say(f"{tag}: Plan.capturable {plan.capturable}; {len(f.fgraph.apply_nodes)} outer nodes")
        if plan.host_reads or (on_card and not isinstance(f.linked, CapturedFunction)):
            raise AssertionError(f"{tag}: not captured: {plan.host_reads}")
        a = [as_torch(np.asarray(v), dev) for v in args]
        init = values(state)
        f(*a)  # the capturing call
        reset(state, init)
        zero()
        res = outs(f(*a))
        launches[tag] = counts()
        after = values(state)
        reset(state_e, init)
        res_e = outs(f_e(*a))
        d_cap, d_eager = digest(*res, *after), digest(*res_e, *values(state_e))
        if d_cap != d_eager:
            raise AssertionError(f"{tag}: the replay differs from the eager plan")
        fused = sum(isinstance(nd.op, FusedElemwise) for nd in f.fgraph.apply_nodes)
        if launches[tag]["scan_whole_loop"] or (on_card
                                                and launches[tag]["fused_elemwise"] != fused):
            raise AssertionError(f"{tag}: launched {launches[tag]}: K1 once a fused node "
                                 f"({fused}), K2 on no linalg scan")
        say(f"{tag}: one replayed call launched {launches[tag]}; sha256 of the outputs and the "
            f"state after it: replayed {d_cap}, eager {d_eager}")
        results[tag] = (res, after, init, a)

    def rel(got, want):
        return float(np.max(np.abs(np.asarray(got, "float64") - want))
                     / max(1.0, float(np.max(np.abs(want)))))

    def n64(x):
        return x.detach().cpu().numpy().astype("float64")

    checks = {}
    # (a) the GP against gp_reference, from theta = 0
    X, y = gp_data(GP_N, 3, "float32")
    nmlls, grads, thetas = gp_reference(X, y, np.zeros(3), GP_LR, GP_LOOP)
    res, after, init, _ = results["gp step"]
    checks["gp_nmll"] = abs(float(res[0]) - nmlls[0]) / nmlls[0]
    upd = [float(n64(v)) for v in after]
    checks["gp_update"] = float(np.max(np.abs(np.array(upd) - thetas[0]))
                                / np.max(np.abs(thetas[0])))
    checks["gp_grad"] = float(np.max(np.abs(-np.array(upd) / GP_LR - grads[0]))
                              / np.max(np.abs(grads[0])))
    res_l, after_l, _, _ = results[f"gp loop x{GP_LOOP}"]
    checks["gp_update64"] = float(np.max(np.abs(np.array([float(n64(v)) for v in after_l])
                                                - thetas[-1])) / np.max(np.abs(thetas[-1])))
    f, state, _, _ = paths["gp step"]
    reset(state, init)
    for _ in range(GP_LOOP):
        last = f()
    calls = [float(n64(v)) for v in values(state)]
    checks["gp_loop_vs_calls"] = max([rel(n64(v), c) for v, c in zip(after_l, calls)]
                                     + [rel(n64(res_l[0]), n64(last))])
    say(f"gp step: nmll {float(res[0]):.6f} vs float64 {nmlls[0]:.6f} (rel {checks['gp_nmll']:.2e}); "
        f"gradient from the update {checks['gp_grad']:.2e} of max|g| (g = "
        f"{', '.join(f'{g:.5f}' for g in grads[0])}); theta after 1 step {checks['gp_update']:.2e}, "
        f"after {GP_LOOP} (the loop) {checks['gp_update64']:.2e} over the largest")
    res, _, _, _ = results["gp mll float64"]
    mll_ref = gp_reference(*gp_data(GP_N, 3, "float64"), np.zeros(3))
    checks["mll64"] = max(rel(n64(res[0]), mll_ref[0][0]),
                          rel(np.array([n64(r) for r in res[1:]]), mll_ref[1][0]))
    say(f"gp mll float64: nmll {float(res[0]):.12f} vs {mll_ref[0][0]:.12f}, gradient "
        f"{', '.join(f'{float(r):.9f}' for r in res[1:])}; max rel err {checks['mll64']:.2e}")
    # (b) the Kalman filter against numpy_kalman_loglike and central differences
    _, theta0, (ys, Zv) = make_kalman_loglike_and_grad(KALMAN_T, KALMAN_K, KALMAN_P, "float32",
                                                       device="cpu")
    res, _, _, _ = results["kalman loglike+grad"]
    T0, lq, lh = (np.asarray(v, "float64") for v in theta0)
    ll_ref = numpy_kalman_loglike(ys.astype("float64"), T0, Zv.astype("float64"), np.exp(lq),
                                  np.exp(lh))
    g_ref = numpy_kalman_grad(ys, T0, Zv, lq, lh)
    checks["kalman_ll"] = abs(float(res[0]) - ll_ref) / abs(ll_ref)
    checks["kalman_grad"] = max(float(np.max(np.abs(n64(r) - g)) / max(1.0, np.max(np.abs(g))))
                                for r, g in zip(res[1:], g_ref))
    say(f"kalman: loglike {float(res[0]):.8f} ({res[0].dtype}) vs float64 {ll_ref:.8f} (rel "
        f"{checks['kalman_ll']:.2e}); gradient vs central differences {checks['kalman_grad']:.2e}")
    ys2, T_true, Z2 = kalman_sim(KALMAN_T, KALMAN_K, KALMAN_P)
    q, h = float(np.float32(0.09)), float(np.float32(0.04))
    T = T_true.astype("float64")
    lls = []
    for _ in range(KALMAN_LOOP):
        lls.append(numpy_kalman_loglike(ys2.astype("float64"), T, Z2.astype("float64"), q, h))
        T = T + KALMAN_LR * numpy_kalman_grad(ys2, T, Z2, np.log(q), np.log(h))[0]
    res_l, after_l, init_l, _ = results[f"kalman loop x{KALMAN_LOOP}"]
    step_T = T_true.astype("float64")
    checks["kalman_update16"] = float(np.max(np.abs(n64(after_l[0]) - T))
                                      / np.max(np.abs(T - step_T)))
    drop = float(np.max(np.abs(step_T - T)) / np.max(np.abs(T - step_T)))
    f, state, _, _ = paths["kalman step"]
    reset(state, init_l)
    for _ in range(KALMAN_LOOP):
        last = f()
    checks["kalman_loop_vs_calls"] = max(rel(n64(after_l[0]), n64(values(state)[0])),
                                         rel(n64(res_l[0]), n64(last)))
    say(f"kalman loop x{KALMAN_LOOP}: last loglike {float(res_l[0]):.6f} vs float64 "
        f"{lls[-1]:.6f}; T over the largest update of {KALMAN_LOOP} float64 steps "
        f"{checks['kalman_update16']:.2e} (a dropped update reads {drop:.3g})")
    # (c) the batched Cholesky: loss = sum of the traces; L and the gradient
    A0 = spd_stack(CHOL_BATCH, CHOL_N).astype("float64")
    res, after, init, _ = results["chol step"]
    loss_ref = float(np.trace(A0, axis1=1, axis2=2).sum())
    checks["chol_loss"] = abs(float(res[0]) - loss_ref) / loss_ref
    A = paths["chol step"][1][0]
    reset([A], init)
    L_g = ptt.function([], [ptl.cholesky(A), ptt.grad(ptt.tensor.sum(ptl.cholesky(A) ** 2), A)],
                       device=dev)
    L, g = L_g()
    L_ref = np.linalg.cholesky(A0)
    checks["chol_L"] = float(np.max(np.abs(n64(L) - L_ref)) / np.max(np.abs(L_ref)))
    checks["chol_grad"] = float(np.max(np.abs(n64(g) - np.eye(CHOL_N))))
    res_l, after_l, _, _ = results[f"chol loop x{CHOL_LOOP}"]
    f, state, _, _ = paths["chol step"]
    reset(state, init)
    for _ in range(CHOL_LOOP):
        last = f()
    checks["chol_loop_vs_calls"] = max(rel(n64(after_l[0]), n64(values(state)[0])),
                                       rel(n64(res_l[0]), n64(last)))
    say(f"chol step: loss {float(res[0]):.3f} vs float64 {loss_ref:.3f} (rel "
        f"{checks['chol_loss']:.2e}); L over max|L| {checks['chol_L']:.2e}; the gradient of "
        f"sum(L**2) = trace(A) against the identity {checks['chol_grad']:.2e}; each loop against "
        f"as many calls of its step: gp {checks['gp_loop_vs_calls']:.2e}, kalman "
        f"{checks['kalman_loop_vs_calls']:.2e}, chol {checks['chol_loop_vs_calls']:.2e}")
    finite = all(np.isfinite(n64(r)).all() for res, after, _, _ in results.values()
                 for r in [*res, *after])
    if not (finite and all(v <= LINALG_TOL[k] for k, v in checks.items())):
        raise AssertionError(f"linalg against float64 NumPy: {checks}; tol {LINALG_TOL}")
    say(f"linalg against float64 NumPy: {json.dumps({k: float(f'{v:.3g}') for k, v in checks.items()})}"
        f"; tol {LINALG_TOL}")

    # path (c): one batched Cholesky a step
    f_e = eager["chol step"][0]
    chol_calls = op_calls(f_e, "aten::linalg_cholesky_ex")
    chol_loop_calls = op_calls(eager[f"chol loop x{CHOL_LOOP}"][0], "aten::linalg_cholesky_ex")
    if chol_calls != 1 or chol_loop_calls != CHOL_LOOP:
        raise AssertionError(f"chol: {chol_calls} Cholesky calls a step, {chol_loop_calls} a "
                             f"{CHOL_LOOP}-step loop; one a step expected")

    # K1 on the fused nodes of the function() paths, on the inputs a call
    # gives them
    k1_abs, k1_rows = 0.0, []
    for tag, (f, state, args, _) in paths.items():
        reset(state, results[tag][2])
        nodes = [nd for nd in f.fgraph.toposort() if isinstance(nd.op, FusedElemwise)]
        needed = [i for nd in nodes for i in nd.inputs]
        feed = fgraph_to_torch(FunctionGraph(f.fgraph.inputs, needed, clone=True), dev)
        vals = iter(feed(*results[tag][3], *[v.get_value(borrow=True) for v in f.shared_vars]))
        for nd in nodes:
            xs = [next(vals) for _ in nd.inputs]
            kern = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
            got, want = (kern.launch if on_card else kern)(*xs), kern.plain(*xs)
            pairs = [errors(g.cpu(), w.cpu()) for g, w in zip(got, want)]
            err = max(p[1] for p in pairs)
            k1_abs = max([k1_abs] + [p[0] for p in pairs])
            tol = K1_RTOL.get(nd.outputs[0].type.dtype, 0.0)
            if not (err <= tol and all(g.shape == w.shape for g, w in zip(got, want))):
                raise AssertionError(f"K1 {tag} {nd.op}: rel err {err} > {tol}")
            k1_rows.append(err)
            say(f"  K1 {tag:20s} {str(nd.op)[:64]:64s} in {[tuple(x.shape) for x in xs]} "
                f"{nd.outputs[0].type.dtype} err {err:.2e}")
    say(f"K1 on the linalg paths' fused nodes: {len(k1_rows)} kernels held against their plain "
        f"version, max rel err {max(k1_rows):.2e} (tol {K1_RTOL})")
    if not on_card:
        return launches, k1_abs

    # the times: captured and eager in turn, per call
    for tag, (f, state, args, steps) in paths.items():
        f_e = eager[tag][0]
        a = results[tag][3]
        n_iter = 20 if steps == 1 else 4
        # an eager call of the Kalman loop runs ~250,000 nodes (~8 s)
        row = captured_vs_eager(tag, lambda f=f, a=a: f(*a), lambda f=f_e, a=a: f(*a),
                                [f.linked], n_iter, n_dev=1 if "kalman loop" in tag else 2,
                                eager_calls=1 if "kalman loop" in tag else None)
        c = row["captured"]
        n_kern = sum(n for _, n in c["by"].values())
        chol = [(kn, n) for kn, (ms, n) in c["by"].items() if "potrf" in kn or "getrf" in kn]
        say(f"{tag} ({smi_line}): wall {c['wall']:.4f} ms/call, device {c['dev']:.4f} ms, busy "
            f"{c['dev'] / c['wall']:.3f}, {steps * 1e3 / c['wall']:,.1f} steps/s; "
            f"{n_kern:.0f} kernels a call ({n_kern / steps:.0f} a step); K1 "
            f"{launches[tag]['fused_elemwise']} launches a call, K2 "
            f"{launches[tag]['scan_whole_loop']}; cuSOLVER factorisation (potrf, getrf) kernels "
            f"{sum(n for _, n in chol) / steps:.0f} a step")
        for kname, (ms, count) in sorted(c["by"].items(), key=lambda kv: -kv[1][0])[:6]:
            say(f"  {tag}: {ms:.4f} ms/call  {count:.0f} launches/call  {kname[:90]}")
    say(f"chol: {chol_calls} Cholesky call (aten::linalg_cholesky_ex) a step of "
        f"{CHOL_BATCH} matrices, {chol_loop_calls} in a {CHOL_LOOP}-step loop")
    say(f"linalg phase done in {time.perf_counter() - t13:.1f} s")
    return launches, k1_abs


def main(opts):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import scipy.sparse as sp

    import pytensor_tpu_torch as ptt  # (fails outside a checkout)
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.compile.mode import FAST_RUN
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.entry import entry
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.cuda import cases, scan_kernel, spmv_kernel
    from pytensor_tpu_torch.link.torch.convert import as_torch, sparse_as_torch
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction, TorchLinker, fgraph_to_torch
    from pytensor_tpu_torch.models import radon_kernel
    from pytensor_tpu_torch.models.logreg import make_logreg_training_step
    from pytensor_tpu_torch.models.mlp import make_mlp_mfu_step, mlp_mfu_graph
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
    device_name = torch.cuda.get_device_name(0)
    # the one-SM bound of K2 and K3, which run a chain on one block: the
    # card's rates shared among its SMs
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count
    say(f"device: {device_name}, {torch.cuda.device_count()} visible, torch {torch.__version__}, "
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
        return fg, TorchLinker.make_torch_fn(fg, dev), n

    # the op library of the logistic-regression and MLP slice: K1 on one
    # fused node a dtype holding every scalar op of the expression table,
    # K2 on scans of its new ops, and the K1 kernels of the logreg and MFU
    # steps, made from their graphs rewritten on the CPU (the same graphs,
    # so the same sources) and built in the pool below; linking them for
    # the card in phase 11 then finds them built
    t0 = time.perf_counter()
    op_groups = {dt: cases.scalar_op_group(dt) for dt in cases.OP_GROUP_DTYPES}
    op_kerns = {dt: fused_kernel.FusedElemwiseKernel(FusedElemwise(ins, outs).fgraph, dev)
                for dt, (ins, outs, _) in op_groups.items()}
    k2_cases = []
    for tag, ins, outs, vals, raw in cases.k2_new_op_scans():
        fg_c = FunctionGraph(ins, outs, clone=True)
        if not raw:
            FAST_RUN.optimizer.rewrite(fg_c)
        node_c = next(nd for nd in fg_c.apply_nodes if isinstance(nd.op, Scan))
        if not scan_kernel.scan_kernel_eligible(node_c.op, node_c):
            raise AssertionError(f"K2 case {tag}: the scan is not eligible")
        k2_cases.append((tag, fg_c, node_c, scan_kernel.ScanKernel(node_c.op, node_c, dev), vals))
    cpu_models = [
        make_logreg_training_step(LOGREG_N, LOGREG_D, "float32", LOGREG_LR, device="cpu")[0],
        make_logreg_training_step(LOGREG_N, LOGREG_D, "float32", LOGREG_LR,
                                  n_steps_per_call=LOGREG_STEPS, device="cpu")[0],
        make_mlp_mfu_step(MFU_BATCH, MFU_D, MFU_DEPTH, "float32", MFU_LR, device="cpu")[0],
        make_mlp_mfu_step(MFU_BATCH, MFU_D, MFU_DEPTH, "float32", MFU_LR,
                          n_steps_per_call=MFU_STEPS, device="cpu")[0]]
    # the MFU step's graph with its gradients as outputs (phase 11's hold)
    X_g, T_g, _, acts_g, loss_g, grads_g, _, _ = mlp_mfu_graph(
        MFU_BATCH, MFU_D, MFU_DEPTH, "float32", MFU_LR, "cpu")
    cpu_models.append(ptt.function([X_g, T_g], [loss_g, *grads_g, *acts_g], device="cpu"))
    model_kerns = [fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
                   for f in cpu_models for nd in f.fgraph.toposort()
                   if isinstance(nd.op, FusedElemwise)]
    del cpu_models
    say(f"the slice's graphs: {len(op_kerns)} K1 op groups, {len(k2_cases)} K2 cases, "
        f"{len(model_kerns)} K1 kernels of the logreg and MFU steps; graph, rewrite and emit in "
        f"{time.perf_counter() - t0:.2f} s")
    # the Elman slice's: the step's K1 kernels and K2 of the static BPTT's
    # forward scan (phase 12 finds them built)
    t0 = time.perf_counter()
    elman_k1, elman_k2 = elman_kernels(dev)
    say(f"the Elman slice's graphs: {len(elman_k1)} K1 kernels of the step, {len(elman_k2)} K2 "
        f"kernel of the static BPTT; graph, rewrite and emit in {time.perf_counter() - t0:.2f} s")
    # the linalg slice's: the K1 kernels of paths (a)-(c) (phase 13)
    t0 = time.perf_counter()
    linalg_k1 = linalg_kernels(dev)
    say(f"the linalg slice's graphs: {len(linalg_k1)} K1 kernels; graph, rewrite and emit in "
        f"{time.perf_counter() - t0:.2f} s")

    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    with ThreadPoolExecutor(18) as pool:
        k1_jobs = [pool.submit(fused_kernel.build, kerns, verbose=True)
                   for kerns in [*k1_kernels.values(), list(op_kerns.values()), model_kerns,
                                 elman_k1, linalg_k1]]
        jobs = {"K3": pool.submit(timed, lambda: radon_kernel.build(verbose=True)),
                "K3 stamped": pool.submit(timed, lambda: radon_kernel.build(
                    verbose=True, flags=radon_kernel.STAMPED)),
                "K3, rows in shared memory": pool.submit(timed, lambda: radon_kernel.build(
                    verbose=True, flags=K3_SHARED_WALK)),
                "K3 stamped, rows in shared memory": pool.submit(timed, lambda: radon_kernel.build(
                    verbose=True, flags=radon_kernel.STAMPED + K3_SHARED_WALK)),
                "K2": pool.submit(timed, lambda: k2.build(verbose=True)),
                "K2 stamped": pool.submit(timed, lambda: k2_stamped.build(verbose=True)),
                "K4": pool.submit(timed, lambda: spmv_kernel.build(verbose=True)),
                **{f"K2 case: {tag}": pool.submit(timed, lambda k=k: k.build(verbose=True))
                   for tag, _, _, k, _ in k2_cases},
                **{"K2 static BPTT": pool.submit(timed, lambda k=k: k.build(verbose=True))
                   for k in elman_k2}}
        build_s = {tag: job.result() for tag, job in jobs.items()}
        for job in k1_jobs:
            job.result()
    logs = {"K3": radon_kernel.BUILD_LOGS[()],
            "K3 stamped": radon_kernel.BUILD_LOGS[radon_kernel.STAMPED],
            "K3, rows in shared memory": radon_kernel.BUILD_LOGS[K3_SHARED_WALK],
            "K3 stamped, rows in shared memory":
                radon_kernel.BUILD_LOGS[radon_kernel.STAMPED + K3_SHARED_WALK],
            "K2": k2.build_log, "K2 stamped": k2_stamped.build_log, "K4": spmv_kernel.BUILD_LOG,
            **{f"K2 case: {tag}": k.build_log for tag, _, _, k, _ in k2_cases},
            **{"K2 static BPTT": k.build_log for k in elman_k2}}
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
    # every scalar op of the expression table, a fused node a dtype
    n_ops, worst_op = 0, 0.0
    for dt, (ins, outs, names) in op_groups.items():
        kern = op_kerns[dt]
        args = [as_torch(v, dev) for v in cases.op_group_inputs(dt, ins, 4099)]
        got = kern.launch(*args)
        want = kern.plain(*args)
        torch.cuda.synchronize()
        inexact = 0.0
        for op_name, g, w in zip(names, got, want):
            g, w = g.cpu(), w.cpu()
            if not g.dtype.is_floating_point:
                if not torch.equal(g, w):
                    raise AssertionError(f"K1 op {op_name} {dt}: differs from its plain version")
                continue
            nan = w.isnan()
            if not torch.equal(g.isnan(), nan):
                raise AssertionError(f"K1 op {op_name} {dt}: NaN where the plain version has none")
            g, w = g[~nan], w[~nan]
            if op_name in cases.EXACT_OPS:
                if not (torch.equal(g, w) and torch.equal(torch.signbit(g), torch.signbit(w))):
                    raise AssertionError(f"K1 op {op_name} {dt}: not the plain version's bits")
                continue
            inf = w.isinf()
            if not (torch.equal(g.isinf(), inf) and torch.equal(g[inf], w[inf])):
                raise AssertionError(f"K1 op {op_name} {dt}: inf where the plain version has none")
            rel = ((g[~inf].double() - w[~inf].double()).abs()
                   / w[~inf].double().abs().clamp(min=1.0))
            err = float(rel.max()) if rel.numel() else 0.0
            if not err <= K1_RTOL[dt]:
                raise AssertionError(f"K1 op {op_name} {dt}: rel err {err} > {K1_RTOL[dt]}")
            inexact = max(inexact, err)
        n_ops += len(names)
        worst_op = max(worst_op, inexact)
        op_wall = wall_ms(lambda: kern.launch(*args), 20)
        say(f"  K1 ops {dt:8s}: {len(names)} ops of {[str(i.type.dtype) for i in ins]} on 4,099 "
            f"elements with numpy's edges; exact ops bit for bit, the others max rel err "
            f"{inexact:.2e} (tol {K1_RTOL.get(dt, 0):g}); wall {op_wall * 1e3:.1f} us a launch")
    say(f"K1 ops: {n_ops} op-dtype pairs held against the plain version, max rel err of the "
        f"inexact ones {worst_op:.2e}")
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
    if not (isinstance(fn, CapturedFunction) and isinstance(fn_b, CapturedFunction)):
        raise AssertionError("the radon functions must be captured on the card")
    # the capturing calls (a warm-up and a capture each), so that the
    # counted calls below are replays
    fn(theta0)
    fn_b(as_torch(theta_b, dev))
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
    # the K2 cases of the slice's new ops, each against its step loop
    for tag, fg_c, node_c, kern_c, vals in k2_cases:
        feed_c = fgraph_to_torch(FunctionGraph(fg_c.inputs, node_c.inputs, clone=False), dev)
        steps_c, *outer_c = feed_c(*[as_torch(v, dev) for v in vals])
        steps_c = steps_c.cpu()
        got_c = kern_c.launch(steps_c, *outer_c)
        want_c = kern_c.plain(steps_c, *outer_c)
        torch.cuda.synchronize()
        err_c = max(errors(a.cpu(), b.cpu())[1] for a, b in zip(got_c, want_c))
        if not (err_c <= K2_CASE_TOL and all(bool(torch.isfinite(a).all()) for a in got_c)):
            raise AssertionError(f"K2 case {tag}: rel err {err_c} vs its step loop > "
                                 f"{K2_CASE_TOL}")
        ops_c = sorted({type(nd.op).__name__ for nd in node_c.op.fgraph.apply_nodes})
        say(f"K2 case {tag}: {int(steps_c)} steps, inner ops {ops_c}; rel err vs its step loop "
            f"{err_c:.2e} (tol {K2_CASE_TOL:g}); {kern_c.src.n_ops} loops, "
            f"{kern_c.src.n_barriers} barriers a step")

    # 7. chain through scan + function() --------------------------------------
    chain = make_leapfrog_chain("float32", None, CHAIN_STEPS, N_OBS, N_COUNTIES, device=dev)
    chain(th0_d, m0_d)  # the capturing call; the counted call is a replay
    fused_kernel.LAUNCHES = 0
    radon_kernel.LAUNCHES = 0
    scan_kernel.LAUNCHES = 0
    c_theta, c_m, c_lp = chain(th0_d, m0_d)
    torch.cuda.synchronize()
    chain_launches = {"fused_elemwise": fused_kernel.LAUNCHES,
                      "radon_leapfrog": radon_kernel.LAUNCHES,
                      "scan_whole_loop": scan_kernel.LAUNCHES}
    say(f"chain launches, make_leapfrog_chain({CHAIN_STEPS} steps) one replayed call: "
        f"{chain_launches}")
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
    # the same functions linked eagerly (xla__jit off), compared in turn
    with config.change_flags(xla__jit=False):
        fn_e = entry("cuda")[0]
        fn_b_e = TorchLinker.make_torch_fn(graphs["float32", True][0], dev)
        chain_e = make_leapfrog_chain("float32", None, CHAIN_STEPS, N_OBS, N_COUNTIES,
                                      device=dev)
    nofree_b = without_free_lists(fgraph_to_torch(graphs["float32", True][0], dev))
    # replayed against eager, bit for bit: the float32 graph has no atomics
    d_cap, d_eager = digest(*fn(theta0)), digest(*fn_e(theta0))
    say(f"entry fn sha256 of logp, dlogp: replayed {d_cap}, eager {d_eager}")
    if d_cap != d_eager:
        raise AssertionError("the replayed entry function differs from the eager plan")
    prof = {
        "single": captured_vs_eager("entry fn (single chain)", lambda: fn(theta0),
                                    lambda: fn_e(theta0), [fn], 200),
        "batched": captured_vs_eager(
            f"batched x{N_CHAINS}", lambda: fn_b(theta_b_d), lambda: fn_b_e(theta_b_d), [fn_b],
            100, extra=f"; eager with its free lists emptied: peak "
                       f"{peak_mb(lambda: nofree_b(theta_b_d)):.2f} MiB a call"),
        "leapfrog": captured_vs_eager(
            f"leapfrog() {LEAPFROG_STEPS} steps", lambda: leapfrog(fn, theta_d, m_d,
                                                                   LEAPFROG_STEPS, EPS),
            lambda: leapfrog(fn_e, theta_d, m_d, LEAPFROG_STEPS, EPS), [fn], 3),
    }
    t_single, t_batched = prof["single"]["captured"]["wall"], prof["batched"]["captured"]["wall"]
    say(f"linked entry fn, captured: wall {t_single:.4f} ms/call ({1e3 / t_single:,.0f} "
        f"logp+dlogp evals/s); batched x{N_CHAINS}: wall {t_batched:.4f} ms/call "
        f"({N_CHAINS * 1e3 / t_batched:,.0f} chain-evals/s); leapfrog() {LEAPFROG_STEPS} steps: "
        f"wall {prof['leapfrog']['captured']['wall']:.2f} ms")
    for tag, key in (("entry fn", "single"), (f"batched x{N_CHAINS}", "batched")):
        for kind in ("captured", "eager"):
            by_name = prof[key][kind]["by"]
            for kname, (ms, count) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:6]:
                say(f"  {tag} {kind}: {ms:.4f} ms/call  {count:.0f} launches/call  {kname[:80]}")
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
    prof["chain"] = captured_vs_eager(f"chain {CHAIN_STEPS} steps", lambda: chain(th0_d, m0_d),
                                      lambda: chain_e(th0_d, m0_d), [chain.linked], 3,
                                      n_dev=3)
    clocks_after = clocks()
    t_chain, chain_dev = prof["chain"]["captured"]["wall"], prof["chain"]["captured"]["dev"]
    chain_by = prof["chain"]["captured"]["by"]
    say(f"chain {CHAIN_STEPS} steps: captured wall {t_chain / prof['chain']['eager']['wall']:.4f} "
        f"of eager's in this process")
    # the longest capture of the path: a float64 chain through the step
    # loop, ~120 nodes a step
    long_chain = make_leapfrog_chain("float64", None, K3_STEPS, N_OBS, N_COUNTIES, device=dev)
    th64, m64 = th0_d.double(), m0_d.double()
    long_first = long_chain(th64, m64)
    long_wall = wall_ms(lambda: long_chain(th64, m64), 2, warmup=1)
    long_again = long_chain(th64, m64)
    torch.cuda.synchronize()
    g_long = next(iter(long_chain.linked.graphs.values()))
    long_err = {k: rel_err(a.cpu(), b.cpu()) for k, a, b in zip(keys, long_again, long_first)}
    if not all(bool(torch.isfinite(v).all()) for v in long_again):
        raise AssertionError("the replayed float64 chain is not finite")
    say(f"longest capture: float64 chain of {K3_STEPS} steps through the step loop: "
        f"{g_long.nodes} nodes, warm-up {g_long.warmup_s:.2f} s, capture {g_long.capture_s:.2f} s "
        f"({g_long.capture_s / g_long.nodes * 1e6:.1f} us a node); replay wall {long_wall:.2f} "
        f"ms/call; replay vs the warm-up's outputs, rel err {_fmt(long_err)} (index_add_ adds "
        f"float64 by atomics)")
    del long_chain, long_first, long_again
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
    f_grad(x0_d)  # the capturing call; the counted call is a replay
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
    with config.change_flags(xla__jit=False):
        f_grad_e = ptt.function([x_var], [cost, ptt.grad(cost, x_var)], device=dev)
    prof["sparse gradient"] = captured_vs_eager(
        "sparse gradient function", lambda: f_grad(x0_d), lambda: f_grad_e(x0_d),
        [f_grad.linked], 50)

    xsh = ptt.shared(x0, name="x", device=dev)
    y_sh = structured_dot(A_var, xsh)
    t0 = time.perf_counter()
    power = ptt.train_loop([], pt.sum(y_sh), {xsh: y_sh / (pt.max(pt.abs(y_sh)) + 1e-9)},
                           n_steps=SPARSE_STEPS, device=dev)
    loop_node = next(nd for nd in power.fgraph.apply_nodes if isinstance(nd.op, Scan))
    say(f"power iteration built in {time.perf_counter() - t0:.2f} s: outer "
        f"{[type(nd.op).__name__ for nd in power.fgraph.toposort()]}, inner "
        f"{[type(nd.op).__name__ for nd in loop_node.op.fgraph.toposort()]}")
    power()  # the capturing call; the counted call is a replay from x0
    xsh.set_value(x0)
    fused_kernel.LAUNCHES = radon_kernel.LAUNCHES = scan_kernel.LAUNCHES = 0
    spmv_kernel.LAUNCHES = 0
    out = power()
    torch.cuda.synchronize()
    power_launches = {"spmv_csr": spmv_kernel.LAUNCHES, "fused_elemwise": fused_kernel.LAUNCHES,
                      "scan_whole_loop": scan_kernel.LAUNCHES}
    say(f"power iteration launches, train_loop({SPARSE_STEPS} steps) one replayed call: "
        f"{power_launches}")
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
    # the same loop eager, and eager with its free lists emptied
    with config.change_flags(xla__jit=False):
        power_e, power_nf = (ptt.train_loop(
            [], pt.sum(y_sh), {xsh: y_sh / (pt.max(pt.abs(y_sh)) + 1e-9)},
            n_steps=SPARSE_STEPS, device=dev) for _ in range(2))
    without_free_lists(power_nf.linked)
    # replayed against eager from the same x, bit for bit: K4 and the
    # reductions add in a fixed order
    runs = {}
    for tag, loop in (("replayed", power), ("eager", power_e)):
        xsh.set_value(x0)
        runs[tag] = digest(loop(), xsh.get_value())
    say(f"power iteration sha256 of the output and the final x: replayed {runs['replayed']}, "
        f"eager {runs['eager']}")
    if runs["replayed"] != runs["eager"]:
        raise AssertionError("the replayed power iteration differs from the eager plan")
    prof["power"] = captured_vs_eager(
        f"power iteration {SPARSE_STEPS} steps", power, power_e, [power.linked], 8,
        extra=f"; eager with its free lists emptied: peak {peak_mb(power_nf):.2f} MiB a call")
    t_power = prof["power"]["captured"]["wall"]
    power_dev = prof["power"]["captured"]["dev"]
    power_by = prof["power"]["captured"]["by"]
    say(f"power iteration {SPARSE_STEPS} steps (train_loop, function()): wall {t_power:.3f} "
        f"ms/call, {SPARSE_STEPS * 1e3 / t_power:,.0f} matvecs/s; device {power_dev:.4f} "
        f"ms/call, {sum(c for _, c in power_by.values()):.0f} kernels/call, busy "
        f"{power_dev / t_power:.3f}")
    for kname, (ms, count) in sorted(power_by.items(), key=lambda kv: -kv[1][0])[:10]:
        say(f"  {ms:.4f} ms/call  {count:.0f} launches/call  {kname[:90]}")
    k4_power = [(ms, count) for kn, (ms, count) in power_by.items() if "spmv_csr_kernel" in kn]
    say(f"K4 inside the power iteration: {k4_power[0][0] / k4_power[0][1] * 1e3:.2f} us a launch "
        f"(device), {k4_power[0][1]:.0f} launches a call")

    # 11. models ----------------------------------------------------------
    model_launches, k1_model_abs = phase_models(dev, smi)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_model_abs)

    # 12. the Elman RNN BPTT step ------------------------------------------
    elman_launches, k1_elman_abs, k2_elman_abs = phase_elman(dev, smi)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_elman_abs)
    k2_abs = max(k2_abs, k2_elman_abs)
    model_launches.update(elman_launches)

    # 13. the linalg slice: GP, Kalman, batched Cholesky ---------------------
    linalg_launches, k1_linalg_abs = phase_linalg(dev, smi)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_linalg_abs)
    model_launches.update(linalg_launches)

    kernels = [
        {"name": "fused_elemwise (K1)", "route": "cuda",
         "source": "pytensor_tpu_torch/tensor/fused_kernel.py",
         "replaces": "pytensor_tpu/tensor/fused.py:33",
         "launches": launches["fused_elemwise"] + sum(
             v["fused_elemwise"] for v in model_launches.values()),
         "launches_by_path": {"radon slice": launches["fused_elemwise"],
                              **{tag: v["fused_elemwise"] for tag, v in model_launches.items()}},
         "max_abs_err": k1["max_abs_err"],
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
         "launches": chain_launches["scan_whole_loop"] + sum(
             v["scan_whole_loop"] for v in model_launches.values()),
         "launches_by_path": {"chain": chain_launches["scan_whole_loop"],
                              **{tag: v["scan_whole_loop"] for tag, v in model_launches.items()}},
         "max_abs_err": k2_abs,
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
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    cli = argparse.ArgumentParser(description="Drive the torch port on one NVIDIA GPU.")
    cli.add_argument("--parent", metavar="DIR",
                     help="a checkout of an earlier commit whose K4 phase 9 holds and times "
                          "beside this tree's")
    sys.exit(main(cli.parse_args()))

"""Drive the torch port's radon, sparse, logistic-regression, MLP, Elman
RNN, linalg (GP, Kalman filter, batched Cholesky), special-function (the
bessel loop), bfloat16 (the MLP "MFU" step, the GEMM chain), tensor
library tail (the einsum loop, the scan rows, the new lowerings),
optimize and complex (the logistic-regression MAP, a periodogram),
random (threefry, the HMC transitions) and loop-sampler (jax's gamma,
Poisson and binomial loops, the RBM Gibbs chain) paths on one NVIDIA GPU.

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
14. special: every special function of ``scalar/math.py`` that K1 emits
   (``link/cuda/special.py``), as a one-node K1 launch in float32 and
   float64 on its grid (``link/cuda/cases.py SPECIAL_GRIDS``, the Bessel
   functions also on ``tests/test_bessel_native.py``'s 12 x 12 grid) and
   numpy's edges, held against float64 scipy (``SPECIAL_RTOL``; the edges
   give scipy's value or the plain version's) and against its plain
   version on the card; timed in float32 at 4,096 and at 2**24 elements
   against its byte bound and the ``torch.special`` call where one exists
   (``SPECIAL_LIBRARY``).  Then the bessel loop of ``benchsuite.py:1067
   ours_bessel`` (``models/bessel.py``: 4,096 float32, 16 steps, captured):
   (i) the step loop, K1 twice a step (kve and ive as one-node launches),
   (ii) under ``scan__pallas``, one K2 launch a call, with K2 against its
   plain step loop on the CPU, and (iii) the function of y and of
   ``grad(sum(y), v)``, K1 on its fused nodes and on kve and ive alone;
   each against float64 scipy (``BESSEL_TOL``), the replay against the
   eager plan by sha256, launches in one replayed call (counts set to 0
   just before it), wall and device ms a call, busy share and full-vector
   kve+ive evals/s as ``benchsuite.py:1091-1092`` counts them.  Then Queue
   3 item 1's stabilised expressions on the card against the reference's
   values.  Phase 3 also runs one fused node a float dtype of every special
   function against its plain version.  K1's and K2's ``launches_by_path``
   gain ``special``.
15. bfloat16 (``phase_bf16``): the MFU step of ``benchsuite.py:263
   ours_mlp_mfu`` at its size and dtype (batch 4,096, d 4,096, depth 4,
   lr 1e-3, bfloat16) through ``function()`` and as its 4-step
   ``train_loop``, captured; counts set to 0 before one replayed call of
   each (K1 on the step's two fused nodes; none in the loop); the loss,
   the gradients (the step's graph linked with them and the products
   before each relu as outputs) and the update (one step at
   ``BF16_UPDATE_LR``, where it shows in bfloat16) against
   ``models/mlp.py mlp_mfu_reference`` in float64, rounding where the graph
   rounds, on the card's sides of relu's kink (``BF16_TOL``); the loop
   against 4 calls of the step; the step's K1 nodes against their plain
   version at its shapes; wall and device ms a step, busy share, kernels
   by name, TFLOP/s over 1.649 TFLOP a step and MFU against the dense
   bfloat16 peak of NVIDIA's H100 SXM data sheet (``BF16_PEAK_S``); the
   bfloat16 nodes K1 does not emit, by name.  The GEMM chain of
   ``benchsuite.py:283 ours_gemm_chain`` (16,384 x 4,096, 8 matrices, 2
   applications a call): the first application on 64 rows against float64
   NumPy and its scale against a float32 chain on the card, the call
   against two calls of one, wall and device ms a call, TFLOP/s.  The same
   MFU step written in direct torch calls, eager, timed beside.  K1 on
   every op of its table in bfloat16 as one-node launches on numpy's edges
   against its plain version (``cases.BF16_EXACT_OPS`` bit for bit, the
   others within 1 ulp) and the MFU class node at 2**24 against its byte
   bound; K2 on ``benchsuite.py:87 ours_scan``'s EWMA in bfloat16 (n 4,096,
   one launch) bit for bit its step loop, µs a step beside float32's.
   K1's and K2's ``launches_by_path`` gain these paths; their kernel-line
   entries gain ``bf16_mfu_class_node`` and ``ewma_n4096``.
16. tail (``phase_tail``; its kernels from ``tail_kernels``, built in
   phase 2's pool): (a) the einsum loop of ``benchsuite.py:197
   ours_einsum`` (``models/einsum.py``: 32 x 4,096 float32, 64 applications
   a call, captured): the path its Einsum lowering planned must cost the
   optimal 1.684e7 FLOPs; launches in one replayed call; ``a`` after it
   against the float64 loop (``TAIL_TOL``); applications/s as
   ``benchsuite.py:226-227`` counts them, device ms split into the products
   and the rest, busy share, and an application's bound (2 MiB at 3.35
   TB/s, 1.684e7 FLOPs at 67 TFLOP/s); (b) the einsum step through
   ``function()``: one K1 launch a replayed call, its K1 node against its
   plain version, the step against float64; (c) ``benchsuite.py:87
   ours_scan``'s cumsum and EWMA rows (n 4,096, float32, ``scan__pallas``):
   one K2 launch a replayed call, K2 against its step loop, the cumsum row
   against ``pt.cumsum(x) / n`` through ``CumOp``, calls/s over 48 chained
   calls, K2's device ms and the CumOp call's wall beside; (d) every group
   of the new lowerings (``cases.tail_cases`` at 2**18 elements: ``CumOp``
   in bool, int32, float32 and float64, ``Repeat``, ``SearchsortedOp``,
   ``TopKOp`` with ties, ``UnravelIndex``, ``RavelMultiIndex``, the real
   FFTs in both float dtypes, the convolutions in each mode, ``pad`` in each
   mode, ``interp``) linked for the card against the same graph linked for
   the CPU (``cases.TAIL_RTOL``), and K1's floor division of a signed zero
   (numpy's signs).  K1's and K2's ``launches_by_path`` gain these paths;
   K2's kernel-line entry gains ``scan_rows_n4096``.
17. optimize (``phase_optimize``; its kernels from ``optimize_kernels``,
   built in phase 2's pool): (a) the MAP of ``models/logreg.py`` at
   ``benchsuite.py:64``'s width (n 8,192, d 256), ``lam`` 1e-3, from w = 0,
   in float64 and float32: ``minimize`` (BFGS, jax's algorithm: a plan
   that runs eagerly around its evaluations, each a replay of one captured
   CUDA graph with its K1 launches), ``root`` of the gradient (25 Newton
   steps, the whole fit one captured graph) and the IFT gradients
   ``d sum(w*)/d lam`` and ``d sum(w*)/d X``, against float64 NumPy
   (scipy's BFGS with the analytic gradient, the closed forms at the
   port's own x*; ``MAP_TOL``); BFGS's iterations, evaluations, reads of
   the card and status, an evaluation's device ms and K1 launches, the
   fits' and the IFT gradient's wall ms; each K1 node of the fits (BFGS's
   evaluation, Newton's f and Jacobian, the IFT gradient's), fed its real
   inputs at w = 0 and at w*, against its plain version (``K1_RTOL``).
   (b) a periodogram (64 signals of 262,144 float32 samples: ``rfft``,
   ``complex`` of the packed pairs, ``abs(c)**2`` and ``angle(c)``;
   ``complex`` and ``angle`` single nodes and ``abs`` and ``sqr`` one K1
   node, as the JAX package groups them; captured) against float64 NumPy
   (``PERIODOGRAM_TOL``), its K1 node against its plain version and its
   bound, and the chain as one K1 kernel (``cases.periodogram_chain``)
   against its plain version, timed beside the port's three nodes; every
   complex op K1 emits
   (``cases.COMPLEX_OPS``, one node a launch) at 2**24 elements in
   complex64 and complex128 against its plain version (the exact ops bit
   for bit, the others within 8 epsilons of the modulus) and, on the first
   2**16, numpy complex128, timed with CUDA events beside its plain
   version, torch's call (``COMPLEX_LIBRARY``) and its byte bound.  Counts
   are set to 0 just before the fits and the periodogram (after a first,
   capturing call of each) and read just after.  K1's ``launches_by_path``
   gains the three paths; its kernel-line entry gains
   ``complex_ops_2e24``, ``periodogram_node`` and ``logreg_map``.
18. random (``phase_random``; threefry built in phase 2's pool, with the
   HMC functions' K1 kernels from ``random_kernels``, which links the same
   functions for the CPU as the reference): (a) the threefry kernel
   (``csrc/threefry.cu``) against its plain version at 2**24 counters,
   bit for bit in 32 and 64 bits, its keys and uniforms, its normals within
   ``NORMAL_RTOL`` (CUDA's erfinv is not torch's), the uniforms and normals
   also against the port's CPU draws at the same key, jax's Random123
   answers and ``split(PRNGKey(42))`` (embedded, and by a folded draw),
   each mode also folded (under ``split(key)[1]``, writing the split) at
   2**24 and at the HMC paths' draws; each mode's time at 2**24 (CUDA
   events over ``THREEFRY_STREAM`` launches after an L2 flush,
   ``stream_ms``, against ``stream_bound``; the normals' bound the larger
   of the hashes' and the FP64 pipe's, ``NORMAL_PROBE``) beside its plain
   version's, with ``--parent``
   the parent's kernel in turn at 2**24; the folded draw at the HMC
   paths' sizes in turn with the split and draw it replaces (device
   times); (b) ``models/hmc.py``'s ``make_radon_hmc``,
   ``make_radon_hmc_chains`` (256 chains) and
   ``make_radon_multinomial_hmc`` at full width (919, 85, 16 leapfrog
   steps of 0.02), with the default flags and with ``scan__pallas``: each
   call one replay of one captured CUDA graph, no host read; the first
   ``HMC_HELD`` transitions against the CPU (accepts and indices equal,
   ``HMC_RTOL``); K1, K2 and threefry launches in one replayed call
   (counts set to 0 just before it, read just after; threefry twice a
   transition, the momenta and the uniforms, each folded), K2's verdict on
   each scan and why; ms a transition, transitions/s, busy share; each K1
   node of the calls against its plain version.  K1's and K2's
   ``launches_by_path`` gain the six paths; the kernel line gains the
   ``threefry2x32`` entry, timed at the 256-chain momenta's folded draw.
19. loop samplers (``phase_loops``; the gamma, Poisson and binomial
   kernels, ``csrc/{gamma,poisson,binomial}.cu``, built in phase 2's
   pool): (a) each of the twelve samplers whose jax sampler is a loop
   (``cases.LOOP_SAMPLERS``) at 2**20 draws on its edge grid
   (``cases.loop_grid``) in float32 and float64, through its RV's draw on
   the card against the same draw on the plain loops
   (``tensor/random/samplers.py``) on the card: integers bit for bit,
   floats within ``LOOP_FLOAT_ULPS`` (0); (b) the RBM Gibbs chain of
   ``models/rbm.py`` at DeepLearningTutorials ``rbm.py``'s sampling width
   (784 visible, 500 hidden, 20 chains, 1,000 steps a call, float32): one
   replay of one captured CUDA graph a call, no host read, the binomial
   kernel's launches in one call and no threefry launch (each draw makes
   its key's split; counts set to 0 just before it, read just after), K2's
   refusal of its scan under ``scan__pallas``;
   its first step against the same step on the CPU at the same keys (the
   draws equal wherever the two devices' p agree bit for bit; the count of
   p that differ printed); the binomial kernel on that step's real p bit
   for bit its plain version; ms a call, Gibbs steps/s, device busy share,
   kernels a call, the top ones by name and the launches a call of each;
   (c) each sampler at 2**20
   through ``function()`` on a shared key (float32), captured: its
   kernel's launches in one call, ms a call; the Poisson and binomial
   draws (one cooperative launch of phases A, B and C of
   ``csrc/loops.cuh``) captured into a CUDA graph and replayed with the
   eager draw's bits; (d) each kernel on
   ``cases.LOOP_TYPICAL`` at 2**20 and the binomial kernel at the Gibbs
   draws, each folded as a random variable draws (the split made in the
   same launch, held against the plain split and loops): device and wall
   time beside its plain version's and torch's sampler of the same
   distribution (other bits), the threefry hashes the draw needs (its
   plain version's tally, and the split's two) and its bound; the gamma kernel
   built with ``-fmad=false`` against the plain loops, by alpha; (e) the
   stamped variants' split of the Poisson and binomial kernels' draw at
   the Gibbs visible draw and at 2**20 (``loop_split``: the sources built
   with ``-DLOOP_STAMPS``, each thread's ``clock64()`` cycles by slot, a
   warp's active lanes, the hashes the threads made against those the
   draw needs); (f) with ``--parent DIR``, DIR's ``csrc/poisson.cu`` and
   ``csrc/binomial.cu`` built with their own headers (``parent_loops``,
   which calls the two-pass C entry of the loop kernels' first tree or the
   one-launch entry of this one, and refuses another), their draws
   required to be this tree's at both Gibbs draws and at 2**20, and the
   two timed in turn, twice.  The kernel line gains an entry for each of
   the three kernels.

Three clocks are kept apart.  ``wall_ms`` is CUDA events around
back-to-back calls: with kernels of a few microseconds it measures the
host's launch path, not the card.  ``device_ms`` takes the durations of
the CUDA kernels that ``torch.profiler`` traces, per launch, so that a
launch the trace missed does not shorten a kernel.  A traced launch ends
when its stores reach the L2, so a kernel that writes more than the L2
holds is timed by ``stream_ms``: CUDA events over back-to-back launches
after an L2 flush, against ``stream_bound``, which takes from each
launch's bytes the L2's share of the launches.  The kernel line's ``ms``
and ``plain_ms`` are device times; ``wall_ms`` and ``plain_wall_ms``
beside them are wall times.  A replayed CUDA graph's kernels are traced
one by one, as the eager ones are.

The second-to-last line is a JSON object with one entry per kernel, the
last ``{"ok": true, "device": {...}}``.  Each entry has ``bound_ms``, the
least time the card could take for the kernel's work (the larger of its
bytes, each input read once and each output written once, over 3.35 TB/s
and its float32 operations over 67 TFLOP/s, the H100 SXM data sheet's
rates, or for threefry and the loop samplers' kernels the threefry
hashes the function needs over the hashes the card can make a second:
one hash's SASS instructions (``HASH_PROBE``, read by cuobjdump) at 64
lanes an SM a clock for the ALU pipe's, 64 for the FMA pipe's (IMAD) and
128 dispatched for all of them, at 132 SMs and 1,980 MHz; ``bound_by`` names the larger; the script fails
if a kernel takes less than its bound; K2 and K3, which run a chain on one
block, also carry ``bound_one_sm_ms``, the same work at one SM's share of
those rates), and ``library_ms``, the device
time of one PyTorch call computing the same function (cuSPARSE's CSR
matvec for K4; none exists for K1-K3 or threefry: ``torch.rand`` is
Philox, another function; for the loop samplers' kernels torch's
sampler of the same distribution, whose bits are not jax's).  It imports
nothing of JAX.
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
# its integer rate, for the threefry hash (integer adds, rotates and
# xors): 132 SMs at the 1,980 MHz boost clock; an SM dispatches 128
# thread-instructions a clock (four schedulers, a warp instruction each),
# of which its ALU pipe (IADD3, LOP3, SHF, LEA, PRMT) takes 64, the 64
# INT32 lanes of NVIDIA's Hopper white paper; IMAD runs on the FMA pipe,
# also 64 lanes
SM_CLOCKS_S = 132 * 1.98e9
DISPATCH_LANES, ALU_LANES, FMA_LANES = 128, 64, 64
# written to empty the L2 (the H100's is 50 MiB) before a timing that wants
# it cold (``flush_l2``)
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
    some twenty traces in a run did, and three in a row in two runs) is
    taken again, up to three times, and then the calls are timed with CUDA
    events instead, with no split by kernel (an empty dict).
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
        # fall back to CUDA events around the calls, which include the
        # host's gaps, and no split by kernel
        ms = wall_ms(fn, n_iter, warmup=0)
        say(f"  (torch.profiler traced no CUDA kernel in three traces: {ms:.4f} ms a call from "
            f"CUDA events, not split by kernel)")
        return ms, {}
    by_name = {k: (ms / c * -(-c // n_iter), -(-c // n_iter)) for k, (ms, c) in by_name.items()}
    return sum(ms for ms, _ in by_name.values()), by_name


_FLUSH: list = []


def flush_l2():
    """Write ``L2_FLUSH_BYTES`` on the card: the L2 (50 MB on the H100)
    then holds none of what a kernel read or wrote before."""
    import torch

    if not _FLUSH:
        _FLUSH.append(torch.empty(L2_FLUSH_BYTES // 4, dtype=torch.float32, device="cuda"))
    _FLUSH[0].fill_(1.0)


def stream_ms(fn, n_iter, warmup=2):
    """The mean time of ``n_iter`` back-to-back calls by CUDA events, after
    a flush of the L2: every input comes from device memory, and all but
    what the L2 can hold of the calls' writes (``l2_bytes``) reaches device
    memory inside the timing.  The time of a kernel that writes more than
    the L2 holds: a kernel's traced duration ends when its stores reach
    the L2, and the L2 may drain up to 50 MB of them after it."""
    import torch

    for _ in range(warmup):
        fn()
    flush_l2()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def l2_bytes():
    """The card's L2 in bytes (50 MiB on the H100)."""
    import torch

    return torch.cuda.get_device_properties(0).L2_cache_size


def stream_bound(n_bytes, n_ops, n_iter, ops_s=F32_OPS_S):
    """``bound`` of a call timed by ``stream_ms`` over ``n_iter`` calls: the
    bytes that must reach device memory, each call's less the L2's share
    of the calls (the last call's writes the L2 may still hold)."""
    return bound(max(0.0, n_bytes - l2_bytes() / n_iter), n_ops, ops_s)


def errors(a, b):
    """(max |a - b|, the same over max(1, max |b|))."""
    a = np.asarray(a, dtype="float64")
    b = np.asarray(b, dtype="float64")
    abs_err = float(np.max(np.abs(a - b)))
    return abs_err, abs_err / max(1.0, float(np.max(np.abs(b))))


def rel_err(a, b):
    return errors(a, b)[1]


def within_bound(tag, row):
    """A timed row's bound is a least time: raise if the kernel took less."""
    if row["bound_ms"] > row["ms"]:
        raise AssertionError(f"{tag}: {row['ms'] * 1e3:.3f} us on the card, under its bound of "
                             f"{row['bound_ms'] * 1e3:.3f} us ({row['bound_by']})")


def _fmt(errs):
    return {k: float(f"{v:.2e}") for k, v in errs.items()}


def bound(n_bytes, n_ops, ops_s=F32_OPS_S):
    """(ms, "bytes" or "operations"): the least time for this work, its
    operations at ``ops_s`` (float32's by default)."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_S * 1e3, n_ops / ops_s * 1e3
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


def k4_ms(launch, n_iter, cold=False):
    """Device time a launch of K4's kernel alone, from the profile; with
    ``cold``, the L2 flushed before each launch (``flush_l2``)."""
    def call():
        if cold:
            flush_l2()
        return launch()

    total, by_name = device_ms(call, n_iter)
    return next((ms / count for kn, (ms, count) in by_name.items() if "spmv_csr_kernel" in kn),
                total)


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


# --- 14. the special functions and the bessel loop ---------------------------------

# the tolerances of the special functions against float64 scipy
# (tests/test_op_grids_special.py and tests/test_bessel_native.py, the JAX
# package's own): float64 rtol 5e-9 with atol 1e-12 on the grids, a Bessel
# function within 1e-9 absolute or 5e-8 relative; float32 2e-5 of
# max(1, |scipy|).  Against the plain version on the card: float64 5e-9,
# float32 2e-5 of max(1, |plain|), NaN and infinities where it has them
SPECIAL_RTOL = {"float32": 2e-5, "float64": 5e-9}
# the bessel loop's float32 state and output after 16 steps, and path
# (iii)'s y and gradient, against float64 scipy: rel err (float32's
# rounding of v ~ 2 over 16 steps, and of 0.999 + the Bessel terms)
BESSEL_TOL = 2e-6
BESSEL_STEPS = 16
# the float32 sizes each special function is timed at
SPECIAL_TIMING_SIZES = (4096, 2 ** 24)
# the torch.special call that computes the same function, timed as the
# library column (the port never calls one on the card); kve and ive have
# one for order 1 alone, timed on that order
SPECIAL_LIBRARY = {
    "erf": "erf", "erfc": "erfc", "erfinv": "erfinv", "erfcx": "erfcx", "gammaln": "gammaln",
    "psi": "digamma", "tri_gamma": ("polygamma", 1), "polygamma": ("polygamma", 2),
    "i0": "i0", "i1": "i1", "ndtr": "ndtr", "ndtri": "ndtri", "logit": "logit",
    "xlogy": "xlogy", "xlog1py": "xlog1py", "j0": "bessel_j0", "j1": "bessel_j1",
    "kve": "scaled_modified_bessel_k1", "ive": "i1e", "gammainc": "gammainc",
    "gammaincc": "gammaincc"}
# Queue 3 item 1's stabilised expressions (float64) and the reference's
# values
STABILISED = [
    ("x == x", lambda p, t, x: t.eq(x, x), [np.nan, 0.0, 2.0, np.inf], [1.0] * 4),
    ("x % x", lambda p, t, x: x % x, [np.nan, 0.0, 2.0, np.inf], [0.0] * 4),
    ("0 / x", lambda p, t, x: 0 / x, [np.nan, 0.0, 2.0, np.inf], [0.0] * 4),
    ("log(1 + x)", lambda p, t, x: t.log(1 + x), [1e-20], [1e-20]),
    ("exp(x) - 1", lambda p, t, x: t.exp(x) - 1, [1e-20], [1e-20]),
    ("log(sum(exp(x)))", lambda p, t, x: t.log(t.sum(t.exp(x))), [800.0], [800.0]),
    ("exp(x) * exp(-x)", lambda p, t, x: t.exp(x) * t.exp(-x), [800.0], [1.0]),
    ("log(1 + exp(x))", lambda p, t, x: t.log(1 + t.exp(x)), [800.0], [800.0]),
    ("grad log(1 + exp(x))", lambda p, t, x: p.grad(t.sum(t.log(1 + t.exp(x))), x), [800.0],
     [1.0]),
    ("log(sigmoid(x))", lambda p, t, x: t.log(t.sigmoid(x)), [-800.0], [-800.0]),
    ("log(1 - sigmoid(x))", lambda p, t, x: t.log(1 - t.sigmoid(x)), [800.0], [-800.0]),
    ("log(1 - exp(x))", lambda p, t, x: t.log(1 - t.exp(x)), [-1e-20], [np.log(1e-20)]),
]


def special_kernels(dev):
    """The K1 and K2 kernels of phase 14, for the build pool of phase 2:
    each special function as a one-node K1 kernel in float32 and float64
    (``{(name, dtype): function}``, each with its kernel as ``.k1``), the
    kernels of the bessel loop's step (its kve and ive alone), of the
    function of y and its gradient (graphs rewritten on the CPU give the
    same sources, so linking them for the card finds them built), and K2
    of the loop under ``scan__pallas``.  Returns (one-node functions, lists
    of K1 kernels to build a library each, K2 kernels)."""
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda import cases, scan_kernel
    from pytensor_tpu_torch.link.torch.dispatch import _one_node_k1
    from pytensor_tpu_torch.models.bessel import make_bessel_functions, make_bessel_loop
    from pytensor_tpu_torch.scan.op import Scan
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    one_node = {}
    for dtype in ("float32", "float64"):
        for name in sorted(cases.SPECIAL_GRIDS):
            node = cases.special_node(name, dtype)
            one_node[name, dtype] = _one_node_k1(node.op, node, dev)
    f_loop, _ = make_bessel_loop(64, 2, device="cpu")
    loop_node = next(nd for nd in f_loop.fgraph.apply_nodes if isinstance(nd.op, Scan))
    f_fun, _ = make_bessel_functions(64, device="cpu")
    paths = [_one_node_k1(nd.op, nd, dev).k1
             for fg in (loop_node.op.fgraph, f_fun.fgraph) for nd in fg.toposort()
             if getattr(getattr(nd.op, "scalar_op", None), "special", False)]
    paths += [fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
              for nd in f_fun.fgraph.toposort() if isinstance(nd.op, FusedElemwise)]
    with config.change_flags(scan__pallas=True):
        f_k2, _ = make_bessel_loop(BESSEL_N_K2, BESSEL_STEPS, device="cpu")
    k2_node = next(nd for nd in f_k2.fgraph.apply_nodes if isinstance(nd.op, Scan))
    # the libraries, cut so that the compilers run side by side: the Bessel
    # functions (the longest sources) a library each dtype, the others in two
    bessel = set(cases.BESSEL_OPS)
    libs = [[one_node[n, d].k1 for n in sorted(cases.SPECIAL_GRIDS) if (n in bessel) == b]
            for d in ("float32", "float64") for b in (True, False)]
    libs.append(paths)
    return one_node, libs, [scan_kernel.ScanKernel(k2_node.op, k2_node, dev)]


# the bessel loop's vector (benchsuite.py:1064 BESSEL_N)
BESSEL_N_K2 = 4096


def _special_checks(name, dtype, vals, got, plain, n_edges):
    """Phase 14's holds of one op: against float64 scipy on the grid, the
    edges against scipy's or the plain version's value, and every point
    against the plain version.  Returns the worst errors."""
    from pytensor_tpu_torch.link.cuda import cases

    want = cases.scipy_special(name, vals)
    g = got.double().cpu().numpy()
    p = plain.double().cpu().numpy()
    grid, edge = slice(0, len(g) - n_edges), slice(len(g) - n_edges, None)
    # against scipy on the grid
    w, gg = want[grid], g[grid]
    both_nan = np.isnan(w) & np.isnan(gg)
    if dtype == "float32":
        fin = np.isfinite(w) & (np.abs(w) < np.finfo(np.float32).max)
        err = np.abs(gg[fin] - w[fin]) / np.maximum(1.0, np.abs(w[fin]))
        ok = err <= SPECIAL_RTOL[dtype]
        worst = float(err.max(initial=0.0))
    elif name in cases.BESSEL_OPS:
        fin = np.isfinite(w)
        diff = np.abs(gg[fin] - w[fin])
        ok = (diff < 1e-9) | (diff / np.maximum(np.abs(w[fin]), 1e-280) < 5e-8)
        worst = float(np.where(ok, 0.0, diff).max(initial=0.0))
    else:
        fin = np.isfinite(w)
        diff = np.abs(gg[fin] - w[fin])
        ok = diff <= 1e-12 + 5e-9 * np.abs(w[fin])
        worst = float((diff / np.maximum(1.0, np.abs(w[fin]))).max(initial=0.0))
    nonfin = ~np.isfinite(w) & ~both_nan
    if not ok.all() or not np.array_equal(gg[nonfin & ~np.isnan(w)], w[nonfin & ~np.isnan(w)]):
        bad = np.flatnonzero(fin)[~ok][:4]
        raise AssertionError(f"phase 14 {name} {dtype}: against scipy at "
                             f"{[tuple(float(v[i]) for v in vals) for i in bad]}: "
                             f"kernel {gg[bad]}, scipy {w[bad]}")

    # the edges: scipy's value or the plain version's
    def same(a, b):
        close = np.isclose(a, b, rtol=SPECIAL_RTOL[dtype], atol=0)
        return (np.isnan(a) & np.isnan(b)) | (a == b) | close

    e_ok = same(g[edge], want[edge]) | same(g[edge], p[edge])
    if not e_ok.all():
        raise AssertionError(f"phase 14 {name} {dtype}: at numpy's edges "
                             f"{[float(v[len(g) - n_edges + i]) for v in vals for i in range(n_edges)]}"
                             f" kernel {g[edge]}, scipy {want[edge]}, plain {p[edge]}")
    # against the plain version everywhere
    if not np.array_equal(np.isnan(g), np.isnan(p)) or not np.array_equal(
            g[np.isinf(p)], p[np.isinf(p)]):
        raise AssertionError(f"phase 14 {name} {dtype}: NaN or inf where the plain version "
                             f"has none")
    fin_p = np.isfinite(p)
    err_p = float((np.abs(g[fin_p] - p[fin_p]) / np.maximum(1.0, np.abs(p[fin_p])))
                  .max(initial=0.0))
    if not err_p <= SPECIAL_RTOL[dtype]:
        raise AssertionError(f"phase 14 {name} {dtype}: rel err {err_p} against the plain "
                             f"version > {SPECIAL_RTOL[dtype]}")
    return worst, err_p, float(np.abs(g[fin_p] - p[fin_p]).max(initial=0.0))


def _library_call(name, args):
    """The torch.special call of SPECIAL_LIBRARY on the op's inputs (the
    order of kve and ive dropped: the call computes order 1)."""
    import torch

    spec = SPECIAL_LIBRARY[name]
    fn, lead = (spec, ()) if isinstance(spec, str) else (spec[0], (spec[1],))
    call = getattr(torch.special, fn)
    if name in ("kve", "ive"):
        args = args[1:]
    return lambda: call(*lead, *args)


def phase_special(dev, smi_line, one_node):
    """Phase 14: every special function, one-node K1 launches in float32
    and float64 on its grid, held against float64 scipy and its plain
    version on the card and timed at 4,096 and 2**24 float32 elements
    against its byte bound and the torch.special call; the bessel loop of
    ``benchsuite.py:1067 ours_bessel`` at its own size (4,096 float32, 16
    steps, captured) as (i) the step loop with kve and ive as one-node K1
    launches and (ii) one K2 launch under ``scan__pallas``, and (iii) the
    function of y and of its gradient, where K1 fuses the expression; the
    stabilised expressions of Queue 3 item 1 on the card.  Returns the
    launches of the paths, K1's and K2's largest absolute errors and the
    op table's rows."""
    import torch

    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda import cases, scan_kernel, spmv_kernel
    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.link.torch.dispatch import _one_node_k1 as one_node_k1
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.models import radon_kernel
    from pytensor_tpu_torch.models.bessel import (
        bessel_grad_reference,
        bessel_reference,
        make_bessel_functions,
        make_bessel_loop,
        v_start,
    )
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    t14 = time.perf_counter()
    k1_abs = 0.0
    rows = []
    n_edges = len(cases.SPECIAL_EDGES)
    gen = torch.Generator(device=dev).manual_seed(14)
    for dtype in ("float32", "float64"):
        worst = {}
        for name in sorted(cases.SPECIAL_GRIDS):
            fn = one_node[name, dtype]
            vals = cases.special_inputs(name, dtype, 4096, 14)
            args = [as_torch(v, dev) for v in vals]
            got = fn.k1.launch(*args)[0]
            plain = fn.k1.plain(*args)[0]
            torch.cuda.synchronize()
            # the grids' values reach 1e300 in float64, so their absolute
            # errors go to this phase's line, not to the kernel line's
            e_sp, e_plain, _ = _special_checks(name, dtype, vals, got, plain, n_edges)
            worst[name] = (e_sp, e_plain)
            if dtype != "float32":
                continue
            # times, float32: at 4,096 and at 2**24 elements on the op's grid
            row = {"op": name, "max_err_scipy": e_sp, "max_err_plain": e_plain}
            for n in SPECIAL_TIMING_SIZES:
                t_args = [(torch.rand(n, device=dev, generator=gen) * (g[1] - g[0]) + g[0])
                          for g in cases.SPECIAL_GRIDS[name] if not isinstance(g, float)]
                out = fn.k1.launch(*t_args)[0]
                n_iter = 20 if n > 4096 else 200
                # past the L2, the mean after a flush, the bytes the L2 may
                # still hold taken from the bound (stream_ms)
                timer = stream_ms if n > 4096 else wall_ms
                us = timer(lambda: fn.k1.launch(*t_args), n_iter) * 1e3
                b_ms, b_by = (stream_bound(nbytes(*t_args, out), n, n_iter) if n > 4096
                              else bound(nbytes(*t_args, out), n))
                lib = (timer(_library_call(name, t_args), n_iter) * 1e3
                       if name in SPECIAL_LIBRARY else None)
                row[n] = (us, b_ms * 1e3, b_by, lib)
                del t_args, out
            rows.append(row)
            r4, r24 = (row[n] for n in SPECIAL_TIMING_SIZES)
            say(f"  special {name:10s} float32: {r4[0]:9.2f} us at 4,096 (bound {r4[1]:.4f} us, "
                f"torch.special {'-' if r4[3] is None else f'{r4[3]:.2f}'} us); "
                f"{r24[0]:10.1f} us at 2**24 (bound {r24[1]:.1f} us {r24[2]}, torch.special "
                f"{'-' if r24[3] is None else f'{r24[3]:.1f}'} us); max err vs scipy "
                f"{e_sp:.2e}, vs plain {e_plain:.2e}")
        say(f"special functions {dtype}: {len(worst)} ops, one-node K1 launches on their grids "
            f"(4,096 points each, the Bessel functions also on tests/test_bessel_native.py's "
            f"12 x 12 grid) and numpy's edges, held against float64 scipy (max "
            f"{max(e for e, _ in worst.values()):.2e}) and the plain version on the card (max "
            f"{max(e for _, e in worst.values()):.2e}); tol {SPECIAL_RTOL[dtype]:g}")

    def zero():
        fused_kernel.LAUNCHES = radon_kernel.LAUNCHES = scan_kernel.LAUNCHES = 0
        spmv_kernel.LAUNCHES = 0

    def counts():
        torch.cuda.synchronize()
        return {"fused_elemwise": fused_kernel.LAUNCHES, "scan_whole_loop": scan_kernel.LAUNCHES}

    v0 = v_start(BESSEL_N_K2)
    want_v, want_y0 = bessel_reference(v0, BESSEL_STEPS)
    launches, prof = {}, {}
    # K1 on the loop's one-node kve and ive against their plain versions,
    # on the loop's first state
    for name, order in (("kve", 1.0), ("ive", 0.5)):
        x = pt.vector("x", dtype="float32")
        node = getattr(pt, name)(order, x).owner
        fn = one_node_k1(node.op, node, dev)
        got, want = fn.k1.launch(as_torch(v0, dev))[0], fn.k1.plain(as_torch(v0, dev))[0]
        torch.cuda.synchronize()
        e_abs, e_rel = errors(got.cpu(), want.cpu())
        if not e_rel <= SPECIAL_RTOL["float32"]:
            raise AssertionError(f"the loop's {name}({order}, v): rel err {e_rel} against the "
                                 f"plain version")
        k1_abs = max(k1_abs, e_abs)
    for tag, pallas in (("bessel loop (i)", False), ("bessel loop (ii) scan__pallas", True)):
        with config.change_flags(scan__pallas=pallas):
            f, v = make_bessel_loop(BESSEL_N_K2, BESSEL_STEPS, device=dev)
            with config.change_flags(xla__jit=False):
                f_e, v_e = make_bessel_loop(BESSEL_N_K2, BESSEL_STEPS, device=dev)
        if not isinstance(f.linked, CapturedFunction) or f.linked.plan.host_reads:
            raise AssertionError(f"{tag}: not captured")
        f()  # the capturing call; the counted call is a replay from v0
        v.set_value(as_torch(v0, dev))
        zero()
        y0 = f()
        launches[tag] = counts()
        want_launches = ({"fused_elemwise": 0, "scan_whole_loop": 1} if pallas else
                         {"fused_elemwise": 2 * BESSEL_STEPS, "scan_whole_loop": 0})
        if launches[tag] != want_launches:
            raise AssertionError(f"{tag}: one call launched {launches[tag]}, not {want_launches}")
        got_v = v.get_value().double().cpu().numpy()
        e_v = float(np.max(np.abs(got_v - want_v) / np.abs(want_v)))
        e_y = abs(float(y0) - want_y0) / abs(want_y0)
        if not (np.all(np.isfinite(got_v)) and e_v <= BESSEL_TOL and e_y <= BESSEL_TOL):
            raise AssertionError(f"{tag}: rel err v {e_v}, y[0] {e_y} against float64 scipy > "
                                 f"{BESSEL_TOL}")
        runs = {}
        for kind, fn, var in (("replayed", f, v), ("eager", f_e, v_e)):
            var.set_value(as_torch(v0, dev))
            runs[kind] = digest(fn(), var.get_value())
        if runs["replayed"] != runs["eager"]:
            raise AssertionError(f"{tag}: the replay differs from the eager plan")
        say(f"{tag}: {BESSEL_N_K2:,} float32, train_loop({BESSEL_STEPS} steps), captured; one "
            f"replayed call launched {launches[tag]}; v rel err {e_v:.2e}, y[0] {e_y:.2e} "
            f"against float64 scipy (tol {BESSEL_TOL:g}); sha256 replayed {runs['replayed']}, "
            f"eager {runs['eager']}")
        # K2's launch of ~2 ms is one of the few kernels of a call, and the
        # trace can miss a long kernel: trace 20 calls
        row = captured_vs_eager(tag, f, f_e, [f.linked], 20, n_dev=20)
        prof[tag] = row
        c = row["captured"]
        say(f"{tag}: {c['wall']:.4f} ms a call, device {c['dev']:.4f} ms, busy "
            f"{c['dev'] / c['wall']:.3f}; {BESSEL_STEPS * 1e3 / c['wall']:,.0f} full-vector "
            f"kve+ive evals/s (benchsuite.py:1091-1092: k_inner over the time of a call)")
        for kname, (ms, cnt) in sorted(c["by"].items(), key=lambda kv: -kv[1][0])[:6]:
            say(f"  {ms:.4f} ms/call  {cnt:.0f} launches/call  {kname[:90]}")
    # K2 of (ii) against its plain version, the step loop of plain torch
    # ops on the CPU, from the same state
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch

    with config.change_flags(scan__pallas=True):
        f2, _ = make_bessel_loop(BESSEL_N_K2, BESSEL_STEPS, device=dev)
    plan2 = f2.linked.plan
    kern2, node2 = next((fn, nd) for fn, nd, *_ in plan2.steps if type(fn).__name__ == "ScanKernel")
    feed = fgraph_to_torch(FunctionGraph(plan2.fgraph.inputs, node2.inputs, clone=False), dev)
    n_steps, *outer = feed(as_torch(v0, dev))
    got2 = kern2.launch(n_steps, *outer)
    plain2 = type(kern2)(node2.op, node2, "cpu").plain(n_steps, *[o.cpu() for o in outer])
    torch.cuda.synchronize()
    pairs = [errors(g.cpu(), w) for g, w in zip(got2, plain2)]
    k2_abs = max(p_[0] for p_ in pairs)
    if not max(p_[1] for p_ in pairs) <= BESSEL_TOL:
        raise AssertionError(f"K2 bessel loop: rel err {max(p_[1] for p_ in pairs)} against the "
                             f"plain step loop > {BESSEL_TOL}")
    say(f"K2 bessel loop against its plain step loop (torch ops, CPU): max abs err {k2_abs:.2e}, "
        f"rel {max(p_[1] for p_ in pairs):.2e} (tol {BESSEL_TOL:g})")

    # (iii): the function of y and of its gradient, K1 fusing the expression
    f3, v3 = make_bessel_functions(BESSEL_N_K2, device=dev)
    with config.change_flags(xla__jit=False):
        f3_e, _ = make_bessel_functions(BESSEL_N_K2, device=dev)
    f3()
    zero()
    y3, g3 = f3()
    tag = "bessel function and gradient (iii)"
    launches[tag] = counts()
    n_fused = sum(isinstance(nd.op, FusedElemwise) for nd in f3.fgraph.apply_nodes)
    n_special = sum(getattr(getattr(nd.op, "scalar_op", None), "special", False)
                    for nd in f3.fgraph.apply_nodes)
    if launches[tag] != {"fused_elemwise": n_fused + n_special, "scan_whole_loop": 0}:
        raise AssertionError(f"{tag}: launched {launches[tag]}; K1 once a fused node "
                             f"({n_fused}) and a special function alone ({n_special})")
    want_y, want_g = bessel_grad_reference(v0)
    e3 = {"y": float(np.max(np.abs(y3.double().cpu().numpy() - want_y) / np.abs(want_y))),
          "grad": float(np.max(np.abs(g3.double().cpu().numpy() - want_g) / np.abs(want_g)))}
    if not all(e <= BESSEL_TOL for e in e3.values()):
        raise AssertionError(f"{tag}: rel err {e3} against float64 scipy > {BESSEL_TOL}")
    d3 = digest(*f3()), digest(*f3_e())
    if d3[0] != d3[1]:
        raise AssertionError(f"{tag}: the replay differs from the eager plan")
    say(f"{tag}: ops {[type(nd.op).__name__ for nd in f3.fgraph.toposort()]}; one replayed call "
        f"launched {launches[tag]}; rel err {_fmt(e3)} against float64 scipy's closed forms "
        f"(tol {BESSEL_TOL:g}); sha256 replayed {d3[0]}, eager {d3[1]}")
    prof[tag] = captured_vs_eager(tag, f3, f3_e, [f3.linked], 50, n_dev=20)
    # K1 on each fused node of (iii) against its plain version, on the
    # inputs the function gives it
    nodes = [nd for nd in f3.fgraph.toposort() if isinstance(nd.op, FusedElemwise)]
    feed = fgraph_to_torch(FunctionGraph(f3.fgraph.inputs, [i for nd in nodes for i in nd.inputs],
                                         clone=False), dev)
    values = iter(feed(v3.get_value()))
    for nd in nodes:
        args = [next(values) for _ in nd.inputs]
        kern = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
        for g_, w_ in zip(kern.launch(*args), kern.plain(*args)):
            err = rel_err(g_.cpu(), w_.cpu())
            if not err <= SPECIAL_RTOL["float32"]:
                raise AssertionError(f"{tag}: K1 {nd.op} rel err {err} against its plain version")
            k1_abs = max(k1_abs, errors(g_.cpu(), w_.cpu())[0])
    say(f"{tag}: K1 on its {len(nodes)} fused nodes against the plain version, on the inputs the "
        f"function gives them: within {SPECIAL_RTOL['float32']:g}")

    # Queue 3 item 1's stabilised expressions on the card
    for expr, build, vals, want in STABILISED:
        x = pt.dvector("x")
        f = ptt.function([x], build(ptt, pt, x), device=dev)
        got = f(as_torch(np.asarray(vals), dev))
        got = np.asarray(got.double().cpu().numpy(), dtype="float64")
        if not np.allclose(got, np.asarray(want, dtype="float64"), rtol=1e-12, atol=0):
            raise AssertionError(f"stabilised {expr}: {got}, the reference's {want}")
    say(f"Queue 3 item 1 on the card: {len(STABILISED)} expressions give the reference's values "
        f"({', '.join(e for e, *_ in STABILISED)})")
    say(f"special phase done in {time.perf_counter() - t14:.1f} s")
    return launches, k1_abs, k2_abs, rows, prof


# --- 15. bfloat16 ------------------------------------------------------------------

# benchsuite.py:263 ours_mlp_mfu and :283 ours_gemm_chain at their own size
# and dtype: the MFU step (batch 4,096, d 4,096, depth 4, lr 1e-3, 4 steps a
# call) and the GEMM chain (batch 16,384, d 4,096, 8 matrices, 2
# applications a call), bfloat16
BF16_MFU_BATCH, BF16_MFU_D, BF16_MFU_DEPTH, BF16_MFU_STEPS, BF16_MFU_LR = 4096, 4096, 4, 4, 1e-3
# one step at a learning rate whose update shows in bfloat16 weights, for
# the update hold only: at 1e-3 a step moves almost no weight by half a
# bfloat16 ulp (8 bits), so an update dropped there would read the same
BF16_UPDATE_LR = 64.0
GEMM_BATCH, GEMM_D, GEMM_NMAT, GEMM_STEPS = 16384, 4096, 8, 2
# rows of the chain's first application held against float64 NumPy
GEMM_ROWS = 64
# NVIDIA's H100 SXM data sheet: the dense bfloat16 tensor-core rate
BF16_PEAK_S = 989e12
# benchsuite.py:87 ours_scan's EWMA, in bfloat16 and float32
EWMA_N = 4096
# K1's bfloat16 node of the MFU step's class, timed at this many elements
BF16_TIMING_N = 2 ** 24
# phase 15's holds.  The MFU step against the float64 step that rounds to
# bfloat16 where the graph does (``mlp_mfu_reference(..., bf16=True)``; an
# unrounded float64 step is no reference for a bfloat16 network, whose
# batch sums cancel), on the card's sides of relu's kink: the loss
# (relative, a float32 mean of 16.7M squares), the gradients (max error
# over max|ref| a layer: sums of 4,096 bfloat16 products accumulated in
# float32 where the reference sums in float64, and a 1-ulp difference
# before a rounding carries on through the layers) and the update at
# BF16_UPDATE_LR (the weights that differ from the reference's over those
# the reference changes; a dropped update reads 1).  On an H100 80GB HBM3
# at 700 W they read 5.9e-8, 4.1e-3 to 5.7e-3 and 7.0e-3.  The GEMM
# chain's first application on GEMM_ROWS rows against float64 NumPy, max
# error over max|ref|: each of the 8 products rounds to bfloat16 and the
# ramps make each product cancel (the rows' rms is 1.2e-7 at the end of
# the chain), so the rounding grows along it: 2.3e-2 on the H100, held at
# ~4x.  Its scale against the float32 chain on the card (2.5e-5 there), the
# 2-application call against two calls of one (over max|ref|; 0 there), and
# the plain torch step's loss against the port's (0 there)
BF16_TOL = {"mfu_loss": 1e-5, "mfu_grads": 3e-2, "mfu_update": 0.1, "gemm_rows": 0.1,
            "gemm_scale": 2e-2, "gemm_calls": 0.1, "plain_loss": 1e-6}


# the product kernels of cuBLAS (cuBLASLt's nvjet, the sm80/sm90 xmma and
# cutlass gemms) in a trace's kernel names
GEMM_KERNELS = re.compile(r"nvjet|gemm|xmma|cutlass", re.I)


def n_products(f, steps=1):
    """The matrix products a call of ``f`` launches: its Dot, Dot22,
    Dot22Scalar and Gemm nodes, a scan's inner ones once a step."""
    from pytensor_tpu_torch.tensor.blas import Dot22, Dot22Scalar, Gemm
    from pytensor_tpu_torch.tensor.math import Dot

    def count(fg, k):
        n = 0
        for nd in fg.apply_nodes:
            if isinstance(nd.op, (Dot, Dot22, Dot22Scalar, Gemm)):
                n += k
            elif type(nd.op).__name__ == "Scan":
                n += count(nd.op.fgraph, k * steps)
        return n

    return count(f.fgraph, 1)


def with_products(traced_ms, by, n_gemm):
    """Device ms a call from ``device_ms``'s ``(ms, split by kernel)``, with
    the product kernels counted ``n_gemm`` times a call at their mean time
    a traced launch (the trace misses some launches of kernels of a
    millisecond or so, and a missed one would shorten the call), every
    other kernel as traced; and the product launches the trace caught a
    call.  Without a split (no trace), ``traced_ms`` as it is."""
    g = [(ms, n) for k, (ms, n) in by.items() if GEMM_KERNELS.search(k)]
    traced = sum(n for _, n in g)
    rest = sum(ms for k, (ms, _) in by.items() if not GEMM_KERNELS.search(k))
    if not traced:
        return traced_ms, 0
    return rest + sum(ms for ms, _ in g) / traced * n_gemm, traced


def bf16_paths(dev):
    """The functions and graphs of phase 15, built for ``dev``: the MFU
    step through ``function()`` and as a BF16_MFU_STEPS-step
    ``train_loop``, the step at BF16_UPDATE_LR, the step's graph linked
    with its gradients and the products before each relu as outputs, and
    the EWMA scans under ``scan__pallas`` in bfloat16 and float32."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.models.mlp import make_mlp_mfu_step, mlp_mfu_graph
    from pytensor_tpu_torch.utils import np_dtype

    size = (BF16_MFU_BATCH, BF16_MFU_D, BF16_MFU_DEPTH, "bfloat16")
    step = make_mlp_mfu_step(*size, BF16_MFU_LR, device=dev)[0]
    loop = make_mlp_mfu_step(*size, BF16_MFU_LR, n_steps_per_call=BF16_MFU_STEPS, device=dev)[0]
    upd = make_mlp_mfu_step(*size, BF16_UPDATE_LR, device=dev)[0]
    X, T, Ws, acts, loss, grads, _, data = mlp_mfu_graph(*size, BF16_MFU_LR, dev)
    f_g = ptt.function([X, T], [loss, *grads, *acts], device=dev, trust_input=True)
    ewma = {}
    for dtype in ("bfloat16", "float32"):
        c = np_dtype(dtype).type
        x = pt.tensor("x", dtype=dtype, shape=(EWMA_N,))
        with config.change_flags(scan__pallas=True):
            tr, _ = ptt.scan(lambda xt, acc: c(0.98) * acc + c(0.02) * xt, sequences=[x],
                             outputs_info=[pt.constant(np.asarray(0.0, np_dtype(dtype)))])
            ewma[dtype] = ptt.function([x], tr, device=dev)
    return step, loop, upd, (f_g, Ws, data), ewma


def bf16_kernels(dev):
    """The K1 and K2 kernels of phase 15, for the build pool of phase 2:
    every op of K1's table in bfloat16 as a one-node kernel (one library;
    each with the positions of its inputs in ``cases.bf16_op_group``),
    K1's node of the MFU step's class, the K1 kernels of phase 15's
    functions from their graphs made and rewritten on the CPU (the same
    sources, so linking them for the card finds them built) and K2 of the
    EWMA scans.  Returns (one-node kernels by op name, the class node's
    kernel, the functions' K1 kernels, K2 kernels)."""
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.cuda import cases, scan_kernel
    from pytensor_tpu_torch.scan.op import Scan
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    ins, outs, names = cases.bf16_op_group()
    one_node = {}
    for name, out in zip(names, outs):
        used = [k for k, i in enumerate(ins) if i in out.owner.inputs]
        one_node[name] = (fused_kernel.FusedElemwiseKernel(
            FunctionGraph([ins[k] for k in used], [out], clone=True), dev), used)
    cls = fused_kernel.FusedElemwiseKernel(bf16_class_node().fgraph, dev)
    step, loop, upd, (f_g, _, _), ewma = bf16_paths("cpu")
    kerns = [fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
             for f in (step, loop, upd, f_g) for nd in f.fgraph.toposort()
             if isinstance(nd.op, FusedElemwise)]
    k2 = {}
    for dtype, f in ewma.items():
        node = next(nd for nd in f.fgraph.apply_nodes if isinstance(nd.op, Scan))
        k2[dtype] = scan_kernel.ScanKernel(node.op, node, dev)
    return one_node, cls, kerns, k2


def bf16_class_node():
    """One FusedElemwise of the MFU step's class, all bfloat16: relu's
    gradient and the SGD update (``w - lr * switch(a >= 0, g, 0)``) beside
    relu (``maximum(a, 0)``)."""
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.tensor.fused import FusedElemwise
    from pytensor_tpu_torch.utils import np_dtype

    bf = np_dtype("bfloat16").type
    a, g, w = (pt.tensor(k, dtype="bfloat16", shape=(None,)) for k in "agw")
    outs = [w - bf(BF16_MFU_LR) * pt.switch(a >= 0, g, bf(0)), pt.maximum(a, bf(0))]
    return FusedElemwise([a, g, w], outs)


def bf16_plain_step(X, T, Ws, lr):
    """The bfloat16 MFU step in direct torch calls, eager, on the same
    tensors (the weights updated in place): the same arithmetic as the
    graph, op for op, as PyTorch would be written by hand.  Timed beside
    the port's step as the library's route; the port never calls it."""
    import torch

    hs, acts = [X], []
    for W in Ws:
        acts.append(hs[-1] @ W)
        hs.append(torch.relu(acts[-1]))
    diff = (hs[-1] - T).float()
    loss = (diff * diff).mean()
    g = (diff * (2.0 / diff.numel())).to(torch.bfloat16)
    lr_bf = torch.tensor(lr, dtype=torch.bfloat16, device=X.device)
    for i in reversed(range(len(Ws))):
        ga = g * (acts[i] >= 0)
        gW = hs[i].T @ ga
        if i:
            g = ga @ Ws[i].T
        Ws[i].sub_(lr_bf * gW)
    return loss


def _ulps16(a, b):
    """bfloat16 ulps between two bfloat16 tensors, element by element (0
    where both are NaN)."""
    import torch

    def ordered(x):
        u = x.view(torch.int16).to(torch.int32)
        return torch.where(u < 0, -(u & 0x7FFF), u)

    d = (ordered(a) - ordered(b)).abs()
    return torch.where(a.isnan() & b.isnan(), torch.zeros_like(d), d)


def phase_bf16(dev, smi_line, one_node, cls_kern):
    """Phase 15: bfloat16.  (1) the MFU step of ``benchsuite.py:263
    ours_mlp_mfu`` at its size and dtype, through ``function()`` and as
    its 4-step ``train_loop``, captured: launches in one replayed call,
    the loss, gradients and update against the float64 step that rounds
    where the graph does (``BF16_TOL``), each K1 node of the step on the
    inputs the first step gives it against its plain version, wall and
    device ms a step, busy share, kernels by name, TFLOP/s and MFU against
    BF16_PEAK_S; (2) the GEMM chain of ``benchsuite.py:283
    ours_gemm_chain`` (2 applications a call) against float64 NumPy on
    GEMM_ROWS rows and a float32 chain on the card, wall ms a call and
    TFLOP/s; (3) the same step in direct torch calls, eager, timed beside;
    (4) K1 on every op of its table in bfloat16, one node a launch, against
    its plain version (``cases.BF16_EXACT_OPS`` bit for bit, the others
    within 1 ulp), and the MFU class node at 2**24 against its byte bound;
    (5) K2 on the EWMA of ``benchsuite.py:87 ours_scan`` in bfloat16 (n
    4,096, one launch) against its step loop, µs a step beside float32's.
    Returns the launches of the paths, K1's and K2's largest absolute
    errors, and the kernel line's bfloat16 rows.  On the CPU (a rehearsal
    at small sizes) it checks the values only."""
    import torch

    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.cuda import cases, scan_kernel, spmv_kernel
    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction, fgraph_to_torch
    from pytensor_tpu_torch.models import radon_kernel
    from pytensor_tpu_torch.models.mlp import _to_bf16, make_gemm_chain, mlp_mfu_reference
    from pytensor_tpu_torch.scan.op import Scan
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.elemwise import Elemwise
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    on_card = dev.type == "cuda"
    n_sms = torch.cuda.get_device_properties(0).multi_processor_count if on_card else 0
    t15 = time.perf_counter()
    sync = torch.cuda.synchronize if on_card else (lambda: None)

    def zero_counts():
        fused_kernel.LAUNCHES = radon_kernel.LAUNCHES = scan_kernel.LAUNCHES = 0
        spmv_kernel.LAUNCHES = 0

    def counts():
        return {"fused_elemwise": fused_kernel.LAUNCHES, "scan_whole_loop": scan_kernel.LAUNCHES}

    def weights(f):
        return sorted((v for v in f.shared_vars if v.name.startswith("W")), key=lambda v: v.name)

    def reset(params, values):
        for v, x in zip(params, values):
            v.set_value(x.clone())

    # (1) the MFU step ------------------------------------------------------
    step, loop, upd, (f_g, Ws_g, (Xd, Td)), ewma = bf16_paths(dev)
    flops = 3 * 2 * BF16_MFU_DEPTH * BF16_MFU_BATCH * BF16_MFU_D ** 2
    launches = {}
    paths = {"mfu bf16 step": (step, 1), f"mfu bf16 train_loop x{BF16_MFU_STEPS}":
             (loop, BF16_MFU_STEPS), "mfu bf16 step (update lr)": (upd, 1)}
    init = [v.get_value() for v in weights(step)]
    if not all(torch.equal(W.get_value(borrow=True), x) for W, x in zip(Ws_g, init)):
        raise AssertionError("the gradient graph's ramps are not the step's weights")
    results = {}
    for tag, (f, steps) in paths.items():
        if on_card and not isinstance(f.linked, CapturedFunction):
            raise AssertionError(f"{tag}: not captured: {f.linked.host_reads}")
        params = weights(f)
        f(Xd, Td)  # the capturing call; the counted call is a replay
        reset(params, init)
        zero_counts()
        loss = f(Xd, Td)
        sync()
        launches[tag] = counts()
        if steps == 1 and on_card and fused_kernel.LAUNCHES < 1:
            raise AssertionError(f"{tag}: K1 was not launched: {launches[tag]}")
        results[tag] = (float(loss), [v.get_value() for v in params])
        reset(params, init)
        say(f"{tag}: one replayed call launched {launches[tag]}; loss {float(loss):.7f}")
    # the nodes K1 does not emit, left to their plain torch versions
    plain_nodes = sorted({str(nd.op) for f, _ in paths.values() for nd in f.fgraph.apply_nodes
                          if isinstance(nd.op, Elemwise) and not fused_kernel.emittable(nd)
                          and "bfloat16" in [v.type.dtype for v in nd.inputs + nd.outputs]})
    say(f"mfu bf16: Elemwise nodes of bfloat16 that K1 does not emit (the plain torch op runs): "
        f"{plain_nodes or 'none'} (casts are never fused, as in the JAX package)")
    # the holds: gradients from the same graph with them as outputs, on the
    # card's sides of relu's kink
    t_ref = time.perf_counter()
    got = f_g(Xd, Td)
    depth = BF16_MFU_DEPTH
    g_grads = [g.cpu() for g in got[1:1 + depth]]
    masks = [(a >= 0).cpu().numpy() for a in got[1 + depth:]]
    del got
    r_losses, r_after, r_grads = mlp_mfu_reference(Xd.cpu(), Td.cpu(), [x.cpu() for x in init],
                                                   BF16_MFU_LR, 1, masks, bf16=True)
    e_grads = [float(np.max(np.abs(g.double().numpy() - r)) / np.max(np.abs(r)))
               for g, r in zip(g_grads, r_grads)]
    e_loss = abs(results["mfu bf16 step"][0] - r_losses[0]) / abs(r_losses[0])
    # the step at BF16_UPDATE_LR against the reference's weights from the same gradients
    lr_u = float(_to_bf16(BF16_UPDATE_LR))
    changed = missed = 0
    for a, r_g, x in zip(results["mfu bf16 step (update lr)"][1], r_grads, init):
        x64 = x.cpu().double().numpy()
        ref = _to_bf16(x64 - _to_bf16(lr_u * r_g))
        a64 = a.cpu().double().numpy()
        changed += int(np.sum(ref != x64))
        missed += int(np.sum(a64 != ref))
    e_upd = missed / max(changed, 1)
    # the loop against as many calls of the step from the same start
    f1, p1 = step, weights(step)
    for _ in range(BF16_MFU_STEPS):
        l1 = f1(Xd, Td)
    by_calls = [v.get_value() for v in p1]
    reset(p1, init)
    loop_loss, loop_after = results[f"mfu bf16 train_loop x{BF16_MFU_STEPS}"]
    e_loop_loss = abs(loop_loss - float(l1)) / abs(float(l1))
    e_loop = max(int(_ulps16(a, b).max()) for a, b in zip(loop_after, by_calls))
    # the step at lr 1e-3 moves few weights: counted, not held
    moved = sum(int((a != x).sum()) for a, x in zip(results["mfu bf16 step"][1], init))
    finite = all(torch.isfinite(g).all() for g in g_grads)
    say(f"mfu bf16 holds (against the float64 step rounded where the graph rounds, on the "
        f"card's sides of relu's kink, {sum(int(m.size - m.sum()) for m in masks):,} of "
        f"{sum(m.size for m in masks):,} products below 0): loss {results['mfu bf16 step'][0]:.7f}"
        f" vs {r_losses[0]:.7f} (rel err {e_loss:.2e}, tol {BF16_TOL['mfu_loss']:g}); gradients "
        f"max err over max|ref| a layer {', '.join(f'{e:.2e}' for e in e_grads)} (tol "
        f"{BF16_TOL['mfu_grads']:g}); update at lr {BF16_UPDATE_LR:g}: {missed:,} weights off "
        f"the reference's of the {changed:,} it changes ({e_upd:.2e}, tol "
        f"{BF16_TOL['mfu_update']:g}, a dropped update reads 1); the {BF16_MFU_STEPS}-step loop "
        f"against {BF16_MFU_STEPS} calls of the step: loss rel err {e_loop_loss:.2e}, weights "
        f"within {e_loop} ulps (tol {BF16_TOL['mfu_loss']:g}, 1 ulp: the loop's products may sum "
        f"in another order); at lr {BF16_MFU_LR:g} one step moves {moved:,} weights; references in "
        f"{time.perf_counter() - t_ref:.1f} s")
    if not (finite and e_loss <= BF16_TOL["mfu_loss"] and max(e_grads) <= BF16_TOL["mfu_grads"]
            and changed > 0 and e_upd <= BF16_TOL["mfu_update"]
            and e_loop_loss <= BF16_TOL["mfu_loss"] and e_loop <= 1):
        raise AssertionError(f"mfu bf16: loss {e_loss}, gradients {e_grads}, update {e_upd} of "
                             f"{changed}, loop {e_loop_loss} / {e_loop} ulps; tol {BF16_TOL}")
    del g_grads, masks, r_after, r_grads, by_calls
    # K1 on the step's own fused nodes, on the inputs the first step gives them
    k1_abs, k1_rows = 0.0, []
    f = step
    nodes = [nd for nd in f.fgraph.toposort() if isinstance(nd.op, FusedElemwise)]
    needed = [i for nd in nodes for i in nd.inputs]
    feed = fgraph_to_torch(FunctionGraph(f.fgraph.inputs, needed, clone=True), dev)
    values = iter(feed(Xd, Td, *[v.get_value(borrow=True) for v in f.shared_vars]))
    for nd in nodes:
        xs = [next(values) for _ in nd.inputs]
        kern = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
        got, want = (kern.launch if on_card else kern)(*xs), kern.plain(*xs)
        sync()
        ulps = max(int(_ulps16(g, w).max()) if g.dtype == torch.bfloat16 else
                   int((g != w).sum()) for g, w in zip(got, want))
        k1_abs = max([k1_abs] + [errors(g.float().cpu(), w.float().cpu())[0]
                                 for g, w in zip(got, want)])
        exact = all(n.op.scalar_op.name in cases.BF16_EXACT_OPS for n in nd.op.fgraph.apply_nodes)
        if ulps > (0 if exact else 1):
            raise AssertionError(f"K1 mfu bf16 {nd.op}: {ulps} ulps from its plain version")
        k1_rows.append(str(nd.op))
        say(f"  K1 mfu bf16 step {str(nd.op)[:70]:70s} out {tuple(got[0].shape)}: {ulps} ulps "
            f"from its plain version")
    if not k1_rows:
        raise AssertionError("no fused node in the bfloat16 MFU step")
    rows = {}
    for tag, (f, steps) in paths.items() if on_card else ():
        if "update" in tag:
            continue
        params = weights(f)
        n_iter = 8 if steps == 1 else 3
        wall = wall_ms(lambda f=f: f(Xd, Td), n_iter)
        traced_t, by = device_ms(lambda f=f: f(Xd, Td), max(2, n_iter // 2))
        n_gemm = n_products(f, steps)
        dev_t, caught = with_products(traced_t, by, n_gemm)
        reset(params, init)
        k1_by = sum(ms for kn, (ms, _) in by.items() if "k1_" in kn)
        work = flops * steps
        rows[tag] = (wall / steps, dev_t / steps)
        say(f"{tag} ({smi_line}): wall {wall / steps:.4f} ms/step, device {dev_t / steps:.4f} "
            f"ms/step, busy {dev_t / wall:.3f}, {steps * 1e3 / wall:,.1f} steps/s; K1 "
            f"{launches[tag]['fused_elemwise']} launches a call, {k1_by:.4f} ms of device time; "
            f"{work / dev_t / 1e9:,.1f} TFLOP/s on the card's time, {work / wall / 1e9:,.1f} on "
            f"the wall ({flops / 1e12:.3f} TFLOP a step), MFU {work / wall / 1e9 / (BF16_PEAK_S / 1e12):.3f}"
            f" on the wall and {work / dev_t / 1e9 / (BF16_PEAK_S / 1e12):.3f} on the card's time "
            f"against the dense bfloat16 peak of {BF16_PEAK_S / 1e12:.0f} TFLOP/s (NVIDIA H100 "
            f"SXM data sheet); the card's time counts the {n_gemm} products a call at their mean "
            f"traced time, the trace having caught {caught:.0f} ({traced_t:.4f} ms traced)")
        for kname, (ms, count) in sorted(by.items(), key=lambda kv: -kv[1][0])[:6]:
            say(f"  {tag}: {ms:.4f} ms/call  {count:.0f} launches/call  {kname[:90]}")
    # (3) the step in direct torch calls, eager, from the same weights
    Ws_p = [x.clone() for x in init]
    plain_loss = float(bf16_plain_step(Xd, Td, Ws_p, BF16_MFU_LR))
    e_plain = abs(plain_loss - results["mfu bf16 step"][0]) / abs(plain_loss)
    plain_moved = sum(int((a != x).sum()) for a, x in zip(Ws_p, init))
    if not e_plain <= BF16_TOL["plain_loss"]:
        raise AssertionError(f"the plain torch bf16 step's loss is {e_plain} from the port's")
    plain_row = None
    if on_card:
        Ws_p = [x.clone() for x in init]
        p_wall = wall_ms(lambda: bf16_plain_step(Xd, Td, Ws_p, BF16_MFU_LR), 8)
        p_traced, p_by = device_ms(lambda: bf16_plain_step(Xd, Td, Ws_p, BF16_MFU_LR), 4)
        p_dev, p_caught = with_products(p_traced, p_by, n_products(step))
        plain_row = (p_wall, p_dev)
        say(f"plain torch bf16 step, eager ({smi_line}): wall {p_wall:.4f} ms/step, device "
            f"{p_dev:.4f} ms/step (products counted {n_products(step)} times, {p_caught:.0f} "
            f"traced), busy {p_dev / p_wall:.3f}, {flops / p_wall / 1e9:,.1f} TFLOP/s on the "
            f"wall, {flops / p_dev / 1e9:,.1f} on the card's time; its loss {e_plain:.1e} from "
            f"the port's, {plain_moved} weights moved (the port's step: {moved})")
        for kname, (ms, count) in sorted(p_by.items(), key=lambda kv: -kv[1][0])[:4]:
            say(f"  plain step: {ms:.4f} ms/call  {count:.0f} launches/call  {kname[:90]}")
    del step, loop, upd, f_g, Ws_p, init, results
    # (2) the GEMM chain ------------------------------------------------------
    t_g = time.perf_counter()
    chains = {k: make_gemm_chain(GEMM_BATCH, GEMM_D, GEMM_NMAT, "bfloat16",
                                 n_steps_per_call=k, device=dev)[0] for k in (1, GEMM_STEPS)}
    gemm_flops = 2 * GEMM_NMAT * GEMM_BATCH * GEMM_D ** 2
    g1, gk = chains[1], chains[GEMM_STEPS]
    gx1 = next(v for v in g1.shared_vars if v.name == "gx")
    Gs = sorted((v for v in g1.shared_vars if v.name.startswith("G")), key=lambda v: v.name)
    x0 = gx1.get_value()
    s1 = float(g1())
    x1 = gx1.get_value()
    g1()
    x2 = gx1.get_value()
    gxk = next(v for v in gk.shared_vars if v.name == "gx")
    gk()  # the capturing call; the counted call is a replay
    gxk.set_value(x0.clone())
    zero_counts()
    gk()
    sync()
    launches[f"gemm chain bf16 x{GEMM_STEPS}"] = counts()
    e_calls = errors(gxk.get_value().float().cpu(), x2.float().cpu())[0] / float(
        x2.float().abs().max())
    # the float32 chain on the card (TF32 off) for the scale; float64 NumPy
    # on GEMM_ROWS rows
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    y32 = x0.float()
    for G in Gs:
        y32 = y32 @ G.get_value(borrow=True).float()
    torch.backends.cuda.matmul.allow_tf32 = prev
    rms32 = float(torch.sqrt(torch.mean(y32.double() ** 2)))
    s32 = rms32 + float(np.float32(1e-6))
    del y32
    e_scale = abs(s1 - s32) / s32
    rows_i = torch.arange(0, GEMM_BATCH, GEMM_BATCH // GEMM_ROWS, device=dev)
    y64 = x0[rows_i].double().cpu().numpy()
    for G in Gs:
        y64 = y64 @ G.get_value(borrow=True).double().cpu().numpy()
    # divided by the port's own scale
    ref = y64 / s1
    e_rows = float(np.max(np.abs(x1[rows_i].double().cpu().numpy() - ref)) / np.max(np.abs(ref)))
    rms_rows = (float(np.sqrt(np.mean((x1[rows_i].double().cpu().numpy() * s1) ** 2))),
                float(np.sqrt(np.mean(y64 ** 2))))
    say(f"gemm chain bf16 ({GEMM_BATCH:,} x {GEMM_D:,}, {GEMM_NMAT} matrices): one replayed call "
        f"of {GEMM_STEPS} applications launched {launches[f'gemm chain bf16 x{GEMM_STEPS}']}; "
        f"the first application's scale {s1:.7g} vs the float32 chain's {s32:.7g} (rel err "
        f"{e_scale:.2e}, tol {BF16_TOL['gemm_scale']:g}; its rms part {rms32:.4g}, the rest the "
        f"graph's 1e-6), {GEMM_ROWS} rows of its output against float64 NumPy: max err over "
        f"max|ref| {e_rows:.2e} (tol {BF16_TOL['gemm_rows']:g}; the rows' rms {rms_rows[0]:.4g} "
        f"against float64's {rms_rows[1]:.4g}); the {GEMM_STEPS}-application "
        f"call against {GEMM_STEPS} calls of one: {e_calls:.2e} (tol {BF16_TOL['gemm_calls']:g})")
    if not (np.isfinite(s1) and torch.isfinite(x2.float()).all()
            and e_scale <= BF16_TOL["gemm_scale"] and e_rows <= BF16_TOL["gemm_rows"]
            and e_calls <= BF16_TOL["gemm_calls"]):
        raise AssertionError(f"gemm chain bf16: scale {e_scale}, rows {e_rows}, calls {e_calls}; "
                             f"tol {BF16_TOL}")
    gemm_row = None
    if on_card:
        wall = wall_ms(gk, 4, warmup=1)
        traced_t, by = device_ms(gk, 2, warmup=0)
        dev_t, caught = with_products(traced_t, by, n_products(gk, GEMM_STEPS))
        work = gemm_flops * GEMM_STEPS
        gemm_row = (wall, dev_t)
        say(f"gemm chain bf16 x{GEMM_STEPS} ({smi_line}): wall {wall:.4f} ms/call, device "
            f"{dev_t:.4f} ms/call (its {n_products(gk, GEMM_STEPS)} products at their mean traced "
            f"time, {caught:.0f} traced), busy {dev_t / wall:.3f}; {work / wall / 1e9:,.1f} "
            f"TFLOP/s on the wall, {work / dev_t / 1e9:,.1f} on the card's time "
            f"({gemm_flops / 1e12:.3f} TFLOP an application), MFU "
            f"{work / wall / 1e9 / (BF16_PEAK_S / 1e12):.3f} on the wall against "
            f"{BF16_PEAK_S / 1e12:.0f} TFLOP/s")
        for kname, (ms, count) in sorted(by.items(), key=lambda kv: -kv[1][0])[:4]:
            say(f"  gemm chain: {ms:.4f} ms/call  {count:.0f} launches/call  {kname[:90]}")
    del chains, g1, gk, x0, x1, x2, Gs
    say(f"gemm chain bf16 in {time.perf_counter() - t_g:.1f} s")
    # (4) K1 on every op of its table in bfloat16 ------------------------------
    ins, _, names = cases.bf16_op_group()
    vals = [as_torch(v, dev) for v in cases.op_group_inputs("bfloat16", ins, 4099)]
    worst = {}
    for name in names:
        kern, used = one_node[name]
        xs = [vals[k] for k in used]
        got = (kern.launch if on_card else kern)(*xs)[0]
        want = kern.plain(*xs)[0]
        sync()
        if got.dtype == torch.bfloat16:
            err = int(_ulps16(got, want).max())
            zero = want == 0
            if not torch.equal(torch.signbit(got[zero]), torch.signbit(want[zero])):
                raise AssertionError(f"K1 bf16 {name}: the sign of a zero")
        else:
            err = int((got != want).sum())
        worst[name] = err
        if err > (0 if name in cases.BF16_EXACT_OPS else 1):
            raise AssertionError(f"K1 bf16 {name}: {err} ulps (or elements) from its plain version")
    say(f"K1 bf16: {len(worst)} ops, one node a launch, on numpy's edges (4,099 values): "
        f"{sum(1 for n in worst if n in cases.BF16_EXACT_OPS)} exact ops bit for bit, the others "
        f"within 1 ulp of their plain version ({sorted(n for n, e in worst.items() if e)} off by "
        f"one somewhere)")
    n = BF16_TIMING_N if on_card else 4099
    gen = torch.Generator(device=dev).manual_seed(15)
    xs = [torch.randn(n, generator=gen, device=dev).to(torch.bfloat16) for _ in range(3)]
    got, want = (cls_kern.launch if on_card else cls_kern)(*xs), cls_kern.plain(*xs)
    sync()
    if any(int(_ulps16(g, w).max()) for g, w in zip(got, want)):
        raise AssertionError("K1 bf16 MFU class node differs from its plain version")
    k1_row = None
    if on_card:
        # it writes more than the L2 holds: the mean of launches after a
        # flush, against the bytes that must reach device memory
        k_ms = stream_ms(lambda: cls_kern.launch(*xs), 20)
        p_ms = device_ms(lambda: cls_kern.plain(*xs), 20)[0]
        k_wall = wall_ms(lambda: cls_kern.launch(*xs), 20)
        p_wall = wall_ms(lambda: cls_kern.plain(*xs), 20)
        b_ms, b_by = stream_bound(nbytes(*xs, *got), 0, 20)
        k1_row = {"n": n, "ms": k_ms, "plain_ms": p_ms, "wall_ms": k_wall,
                  "plain_wall_ms": p_wall, "bound_ms": b_ms, "bound_by": b_by}
        say(f"K1 bf16 MFU class node at {n:,} elements (3 in, 2 out, 2 bytes each): kernel "
            f"{k_ms * 1e3:.2f} us (CUDA events after an L2 flush; {k_wall * 1e3:.2f} wall), plain "
            f"{p_ms * 1e3:.2f} us device "
            f"({p_wall * 1e3:.2f} wall), bound {b_ms * 1e3:.2f} us ({b_by}), "
            f"{b_ms / k_ms:.3f} of it; vector path {cls_kern.vector} values a thread")
    # (5) K2 on the EWMA ----------------------------------------------------
    k2_abs, k2_row = 0.0, {}
    xe = torch.randn(EWMA_N, generator=gen, device=dev)
    for dtype, f in ewma.items():
        x = xe.to(getattr(torch, dtype))
        node = next(nd for nd in f.fgraph.apply_nodes if isinstance(nd.op, Scan))
        f(x)  # the capturing call
        zero_counts()
        out = f(x)
        sync()
        tag = f"ewma {dtype} (scan__pallas)"
        launches[tag] = counts()
        if on_card and scan_kernel.LAUNCHES != 1:
            raise AssertionError(f"{tag}: K2 launched {scan_kernel.LAUNCHES} times, not once")
        kern = scan_kernel.ScanKernel(node.op, node, dev)
        feed = fgraph_to_torch(FunctionGraph(f.fgraph.inputs, node.inputs, clone=True), dev)
        n_steps, *outer = feed(x)
        got = (kern.launch if on_card else kern)(n_steps, *outer)[0]
        want = kern.plain(n_steps, *outer)[0]
        sync()
        if dtype == "bfloat16":
            if int(_ulps16(got, want).max()) or not torch.equal(out, got):
                raise AssertionError("K2 bf16 EWMA differs from its step loop or the function")
        k2_abs = max(k2_abs, errors(got.float().cpu(), want.float().cpu())[0])
        if dtype == "float32" and k2_abs > 1e-6:
            raise AssertionError(f"K2 float32 EWMA: {k2_abs} from its step loop")
        if on_card:
            ms = device_ms(lambda: kern.launch(n_steps, *outer), 10)[0]
            p_ms = wall_ms(lambda: kern.plain(n_steps, *outer), 2, warmup=1)
            # the sequences read once, the trace written once; the inner
            # graph's operations each step
            b_ms, b_by = bound(nbytes(*outer, got), inner_ops(node.op.fgraph) * EWMA_N)
            k2_row[dtype] = (ms, p_ms, b_ms, b_by)
            say(f"K2 {tag} n {EWMA_N:,}: one launch {ms:.4f} ms device, "
                f"{ms / EWMA_N * 1e3:.3f} us a step; its step loop {p_ms:.2f} ms wall; bound "
                f"{b_ms * 1e3:.4f} us ({b_by}), on one SM's share {b_ms * n_sms * 1e3:.3f} us; "
                f"{'bit for bit the step loop and the function' if dtype == 'bfloat16' else ''}")
    say(f"bfloat16 phase done in {time.perf_counter() - t15:.1f} s")
    return launches, k1_abs, k2_abs, {"mfu": rows, "plain_step": plain_row, "gemm": gemm_row,
                                      "k1": k1_row, "k2": k2_row}


# --- 16. the tensor library's tail: the einsum loop and the scan rows ---------------

# benchsuite.py:197 ours_einsum: 64 applications a call (its k_inner); :87
# ours_scan: n 4,096 float32, 48 chained calls (its iters)
EINSUM_STEPS = 64
SCAN_N, SCAN_CHAIN = 4096, 48
# the tail's lowerings (phase 16(d)) at this many elements an input
TAIL_N = 2 ** 18
# phase 16's holds.  The einsum loop's a after one call of 64 applications
# (its m x m block, max error over max|ref|) and the last application's
# sum(out) (relative) against the float64 loop: float32 products of 4,096
# terms, renormalised each application (on the CPU the port read 3.8e-7 and
# 1.5e-7, on an H100 80GB HBM3 at 700 W 3.4e-7 and 5.4e-8), held at ~10x;
# the step after one application the same.  K2 on a
# scan row against its step loop over max(1, max|loop|), as phase 15's
# EWMA; the cumsum row against CumOp (a sequential sum against torch's
# scan, over max|cumop|)
TAIL_TOL = {"einsum": 5e-6, "k2": 1e-6, "cumop": 1e-5}
# cuBLAS's product kernels in a trace: GEMM_KERNELS and the split-K
# reductions that follow a GEMM of a long inner dimension
PRODUCT_KERNELS = re.compile(GEMM_KERNELS.pattern + r"|splitKreduce", re.I)


def einsum_plans(plan):
    """The plans (``fn.paths``) of every Einsum lowering a plan runs, its
    scans' inner plans included."""
    out = []
    for fn, _, _, _ in plan.steps:
        if hasattr(fn, "paths"):
            out.append(fn.paths)
        inner = getattr(fn, "inner", None)
        if inner is not None:
            out += einsum_plans(inner)
    return out


def tail_paths(dev):
    """The functions of phase 16, built for ``dev``: the einsum loop of
    EINSUM_STEPS applications and the einsum step, ``benchsuite.py:87``'s
    cumsum and EWMA rows under ``scan__pallas``, the cumsum row through
    ``CumOp``, and one function of each group of ``cases.tail_cases``."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda import cases
    from pytensor_tpu_torch.models.einsum import make_einsum_loop, make_einsum_step

    loop = make_einsum_loop(EINSUM_STEPS, device=dev)
    step = make_einsum_step(device=dev)
    x = pt.tensor("x", dtype="float32", shape=(SCAN_N,))
    rows = {}
    with config.change_flags(scan__pallas=True):
        tr, _ = ptt.scan(lambda xt, acc: acc + xt, sequences=[x],
                         outputs_info=[pt.constant(0.0, dtype="float32")])
        rows["cumsum"] = ptt.function([x], tr / np.float32(SCAN_N), name="scan_cumsum",
                                      device=dev)
        tr, _ = ptt.scan(lambda xt, acc: 0.98 * acc + 0.02 * xt, sequences=[x],
                         outputs_info=[pt.constant(0.0, dtype="float32")])
        rows["ewma"] = ptt.function([x], tr, name="scan_ewma", device=dev)
    cumop = ptt.function([x], pt.cumsum(x) / np.float32(SCAN_N), device=dev)
    tail = [(tag, ins, outs, vals, ptt.function(ins, outs, device=dev))
            for tag, ins, outs, vals in cases.tail_cases(TAIL_N)]
    return loop, step, rows, cumop, tail


def sign_nodes():
    """K1's floor division of two float vectors, a node a float dtype."""
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    out = {}
    for dtype in ("float32", "float64"):
        x, y = (pt.tensor(k, dtype=dtype, shape=(None,)) for k in "xy")
        out[dtype] = FusedElemwise([x, y], [x // y])
    return out


def tail_kernels(dev):
    """The kernels of phase 16, for the build pool of phase 2: the K1
    kernels of its functions, made from their graphs rewritten on the CPU
    (the same sources, so linking them for the card finds them built), K1's
    floor-division nodes and K2 of the two scan rows.  Returns (K1 kernels,
    the floor-division kernels by dtype, K2 kernels by row)."""
    from pytensor_tpu_torch.link.cuda import scan_kernel
    from pytensor_tpu_torch.scan.op import Scan
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    (loop, _), (step, _), rows, cumop, tail = tail_paths("cpu")
    fns = [loop, step, *rows.values(), cumop] + [f for *_, f in tail]
    kerns = {}
    for f in fns:
        for nd in f.fgraph.toposort():
            if isinstance(nd.op, FusedElemwise):
                k = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
                kerns.setdefault(k.key, k)
    signs = {dt: fused_kernel.FusedElemwiseKernel(nd.fgraph, dev)
             for dt, nd in sign_nodes().items()}
    k2 = {}
    for kind, f in rows.items():
        node = next(nd for nd in f.fgraph.apply_nodes if isinstance(nd.op, Scan))
        k2[kind] = scan_kernel.ScanKernel(node.op, node, dev)
    return list(kerns.values()), signs, k2


def phase_tail(dev, smi_line, signs):
    """Phase 16: the tensor library's tail.  (a) the einsum loop of
    ``benchsuite.py:197 ours_einsum`` (32 x 4,096 float32, 64 applications
    a call, captured): the path its Einsum lowering planned (1.684e7 FLOPs),
    launches in one replayed call, ``a`` after it against the float64 loop,
    applications/s as benchsuite counts them, device ms split by kernel,
    busy share, the bound of an application; (b) the einsum step through
    ``function()``: one K1 launch a call, the K1 node against its plain
    version, the step against float64; (c) ``benchsuite.py:87 ours_scan``'s
    cumsum and EWMA rows (n 4,096, float32, ``scan__pallas``): one K2
    launch a call, K2 against its step loop, the cumsum row against
    ``pt.cumsum(x) / n`` through ``CumOp``, calls/s over 48 chained calls as
    benchsuite chains them, the CumOp call's time beside; (d) every new
    lowering (``cases.tail_cases`` at TAIL_N) linked for the card against
    the same graph linked for the CPU, and K1's floor division of a signed
    zero.  Returns the launches of the paths, K1's and K2's largest
    absolute errors and the rows it timed.  On the CPU (a rehearsal) it
    checks the values only."""
    import torch

    import pytensor_tpu_torch as ptt
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.cuda import cases, scan_kernel, spmv_kernel
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction, fgraph_to_torch
    from pytensor_tpu_torch.models import radon_kernel
    from pytensor_tpu_torch.models.einsum import einsum_data, einsum_flops, einsum_reference
    from pytensor_tpu_torch.scan.op import Scan
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t16 = time.perf_counter()

    def zero_counts():
        fused_kernel.LAUNCHES = radon_kernel.LAUNCHES = scan_kernel.LAUNCHES = 0
        spmv_kernel.LAUNCHES = 0

    def counts():
        return {"fused_elemwise": fused_kernel.LAUNCHES, "scan_whole_loop": scan_kernel.LAUNCHES}

    (loop, a_loop), (step, a_step), rows, cumop, tail = tail_paths(dev)
    launches, timed = {}, {}
    a0, b, c, d = einsum_data()
    m = a0.shape[0]
    # (a) the einsum loop ---------------------------------------------------
    if on_card and not isinstance(loop.linked, CapturedFunction):
        raise AssertionError(f"einsum loop: not captured: {loop.linked.host_reads}")
    loop()  # the capturing call; the counted call is a replay from a0
    a_loop.set_value(a0)
    zero_counts()
    total = float(loop())
    sync()
    launches[f"einsum loop x{EINSUM_STEPS}"] = counts()
    plans = einsum_plans(loop.linked.plan if on_card else loop.linked)
    (steps_flops,) = [p for paths in plans for p in paths.values()]
    path_flops = steps_flops[1]
    ref, ref_total = einsum_reference(a0, b, c, d, EINSUM_STEPS)
    blk = a_loop.get_value().cpu().numpy()[:m, :m]
    e_blk = float(np.max(np.abs(blk - ref[:m, :m])) / np.max(np.abs(ref[:m, :m])))
    e_tot = abs(total - ref_total) / abs(ref_total)
    say(f"einsum loop ({m} x {a0.shape[1]:,} float32, {EINSUM_STEPS} applications a call): the "
        f"lowering's path {[spec for _, spec in steps_flops[0]]}, {path_flops:,} FLOPs an "
        f"application (optimal: {einsum_flops():,}); one replayed call launched "
        f"{launches[f'einsum loop x{EINSUM_STEPS}']}; a's {m} x {m} block after it against the "
        f"float64 loop: {e_blk:.2e} of max|ref|, sum(out) rel err {e_tot:.2e} (tol "
        f"{TAIL_TOL['einsum']:g})")
    if path_flops != einsum_flops():
        raise AssertionError(f"einsum path of {path_flops} FLOPs, not {einsum_flops()}")
    if not (np.all(np.isfinite(blk)) and e_blk <= TAIL_TOL["einsum"]
            and e_tot <= TAIL_TOL["einsum"]):
        raise AssertionError(f"einsum loop: block {e_blk}, sum {e_tot}; tol {TAIL_TOL}")
    # the bytes an application reads (a, b, c and d once) and its FLOPs
    app_bytes = 4 * a0.size * 4
    b_ms, b_by = bound(app_bytes, path_flops)
    if on_card:
        wall = wall_ms(loop, 20)
        dev_t, by = device_ms(loop, 4)
        # cuBLAS's kernels of the products: the GEMMs and their split-K reductions
        gemm = {k: v for k, v in by.items() if PRODUCT_KERNELS.search(k)}
        per_app = wall / EINSUM_STEPS
        # the path's three contractions alone, at the loop's shapes: µs each
        # (its kernels, a GEMM and a split-K reduction, together) from CUDA
        # events around a replayed CUDA graph of 64 of them, so that no host
        # gap between launches counts
        prev, torch.backends.cuda.matmul.allow_tf32 = torch.backends.cuda.matmul.allow_tf32, False
        ops = [torch.as_tensor(x, device=dev) for x in (a0, b, c, d)]
        products = []
        for pos, spec in steps_flops[0]:
            taken = [ops.pop(p) for p in pos]
            ops.append(torch.einsum(spec, *taken))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                for _ in range(EINSUM_STEPS):
                    torch.einsum(spec, *taken)
            products.append((spec, wall_ms(graph.replay, 20) / EINSUM_STEPS * 1e3))
        torch.backends.cuda.matmul.allow_tf32 = prev
        rest_us = dev_t / EINSUM_STEPS * 1e3 - sum(us for _, us in products)
        timed["einsum"] = {"wall_ms": wall, "device_ms": dev_t, "us_an_application": per_app * 1e3,
                           "products_us": dict(products), "rest_us": rest_us,
                           "bound_us": b_ms * 1e3, "bound_by": b_by}
        say(f"einsum loop ({smi_line}): wall {wall:.4f} ms a call, {per_app * 1e3:.3f} us an "
            f"application, {EINSUM_STEPS * 1e3 / wall:,.0f} applications/s (benchsuite.py:226-227's "
            f"1/dt, dt a call's wall over {EINSUM_STEPS}); device {dev_t:.4f} ms a call, busy "
            f"{dev_t / wall:.3f}, cuBLAS's product kernels {sum(ms for ms, _ in gemm.values()):.4f} "
            f"ms of it in {sum(n for _, n in gemm.values()):.0f} launches; an application's device "
            f"us: the products alone " + ", ".join(f"{sp} {us:.3f}" for sp, us in products)
            + f", the rest {rest_us:.3f}; bound an application {b_ms * 1e3:.3f} us ({b_by}: "
            f"{app_bytes / 2 ** 20:.2f} MiB at 3.35 TB/s {app_bytes / HBM_BYTES_S * 1e6:.3f} us, "
            f"{path_flops:.4g} FLOPs at 67 TFLOP/s {path_flops / F32_OPS_S * 1e6:.3f} us), "
            f"{b_ms / per_app:.4f} of it reached")
        for kname, (ms, count) in sorted(by.items(), key=lambda kv: -kv[1][0])[:6]:
            say(f"  einsum loop: {ms:.4f} ms/call  {count:.0f} launches/call  {kname[:90]}")
    # (b) the einsum step ---------------------------------------------------
    step()  # the capturing call
    a_step.set_value(a0)
    zero_counts()
    s1 = float(step())
    sync()
    launches["einsum step"] = counts()
    if on_card and fused_kernel.LAUNCHES != 1:
        raise AssertionError(f"einsum step: K1 launched {fused_kernel.LAUNCHES} times, not once")
    ref1, tot1 = einsum_reference(a0, b, c, d, 1)
    blk1 = a_step.get_value().cpu().numpy()[:m, :m]
    e_step = max(float(np.max(np.abs(blk1 - ref1[:m, :m])) / np.max(np.abs(ref1[:m, :m]))),
                 abs(s1 - tot1) / abs(tot1))
    if not e_step <= TAIL_TOL["einsum"]:
        raise AssertionError(f"einsum step: {e_step} from float64; tol {TAIL_TOL['einsum']}")
    k1_abs = 0.0
    a_step.set_value(a0)
    nodes = [nd for nd in step.fgraph.toposort() if isinstance(nd.op, FusedElemwise)]
    feed = fgraph_to_torch(FunctionGraph(step.fgraph.inputs, [i for nd in nodes for i in nd.inputs],
                                         clone=True), dev)
    values = iter(feed(*[v.get_value(borrow=True) for v in step.shared_vars]))
    for nd in nodes:
        xs = [next(values) for _ in nd.inputs]
        kern = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
        got, want = (kern.launch if on_card else kern)(*xs), kern.plain(*xs)
        sync()
        errs = [errors(g.cpu(), w.cpu()) for g, w in zip(got, want)]
        k1_abs = max([k1_abs] + [e[0] for e in errs])
        if max(e[1] for e in errs) > K1_RTOL["float32"]:
            raise AssertionError(f"K1 einsum step {nd.op}: {errs} from its plain version")
    step_wall = wall_ms(step, 50) if on_card else float("nan")
    say(f"einsum step through function(): one replayed call launched {launches['einsum step']}; "
        f"against one float64 application {e_step:.2e}; its {len(nodes)} K1 node within "
        f"{k1_abs:.2e} of its plain version; wall {step_wall:.4f} ms a call ({smi_line})")
    # (c) the scan rows -----------------------------------------------------
    k2_abs = 0.0
    gen = torch.Generator(device=dev).manual_seed(16)
    xs0 = torch.randn(SCAN_N, generator=gen, device=dev)
    for kind, f in rows.items():
        node = next(nd for nd in f.fgraph.apply_nodes if isinstance(nd.op, Scan))
        f(xs0)  # the capturing call
        zero_counts()
        out = f(xs0)
        sync()
        launches[f"scan {kind} n{SCAN_N}"] = counts()
        if on_card and scan_kernel.LAUNCHES != 1:
            raise AssertionError(f"scan {kind}: K2 launched {scan_kernel.LAUNCHES} times, not once")
        kern = scan_kernel.ScanKernel(node.op, node, dev)
        feed = fgraph_to_torch(FunctionGraph(f.fgraph.inputs, node.inputs, clone=True), dev)
        n_steps, *outer = feed(xs0)
        got = (kern.launch if on_card else kern)(n_steps, *outer)[0]
        want = kern.plain(n_steps, *outer)[0]
        sync()
        e_abs, e_rel = errors(got.cpu(), want.cpu())
        k2_abs = max(k2_abs, e_abs)
        if not e_rel <= TAIL_TOL["k2"]:
            raise AssertionError(f"K2 scan {kind}: {e_rel} from its step loop")
        line = f"scan {kind} (n {SCAN_N:,} float32, scan__pallas): one replayed call launched " \
               f"{launches[f'scan {kind} n{SCAN_N}']}; K2 {e_rel:.2e} from its step loop"
        if kind == "cumsum":
            e_cum = float((out - cumop(xs0)).abs().max() / cumop(xs0).abs().max())
            if not e_cum <= TAIL_TOL["cumop"]:
                raise AssertionError(f"scan cumsum against CumOp: {e_cum}")
            line += f"; the same function through CumOp {e_cum:.2e} from it (tol " \
                    f"{TAIL_TOL['cumop']:g})"
        if on_card:
            def chained(f=f):
                y = xs0
                for _ in range(SCAN_CHAIN):
                    y = f(y)
                return y

            per_call = wall_ms(chained, 3, warmup=1) / SCAN_CHAIN
            k2_ms = device_ms(lambda: kern.launch(n_steps, *outer), 10)[0]
            kb_ms, kb_by = bound(nbytes(*outer, got), inner_ops(node.op.fgraph) * SCAN_N)
            timed[f"scan {kind}"] = {"wall_ms": per_call, "k2_ms": k2_ms, "bound_ms": kb_ms,
                                     "bound_by": kb_by}
            line += (f"; {SCAN_CHAIN} chained calls {per_call:.4f} ms a call, "
                     f"{1e3 / per_call:,.0f} calls/s (benchsuite.py:117's count); K2 {k2_ms:.4f} "
                     f"ms device, {k2_ms / SCAN_N * 1e3:.3f} us a step (bound {kb_ms * 1e3:.4f} us, "
                     f"{kb_by})")
            if kind == "cumsum":
                c_ms = wall_ms(lambda: cumop(xs0), 50)
                timed["cumop"] = {"wall_ms": c_ms}
                line += f"; the CumOp function {c_ms:.4f} ms a call"
        say(line + f" ({smi_line})" if on_card else line)
    # (d) every new lowering against the CPU ------------------------------------
    worst = {}
    for tag, ins, outs, vals, f in tail:
        cpu = ptt.function(ins, outs, device="cpu")
        got, want = f(*vals), cpu(*vals)
        sync()
        errs = []
        for g, w, o in zip(got, want, outs):
            dt = o.type.dtype
            err = cases.tail_held(g.cpu().numpy(), w.numpy(), dt)
            tol = 0 if dt in ("bool", "int32", "int64") else cases.TAIL_RTOL[dt]
            if err > tol:
                raise AssertionError(f"{tag} {o}: {err} from the CPU (tol {tol})")
            errs.append(err)
        worst[tag] = (max(errs), isinstance(f.linked, CapturedFunction))
    say("the tail's lowerings against the CPU (largest error over max|cpu|, exact for integers; "
        f"captured or eager): " + "; ".join(f"{t} {e:.1e} {'captured' if cap else 'eager'}"
                                           for t, (e, cap) in worst.items()))
    for dtype, kern in signs.items():
        tdt = getattr(torch, dtype)
        x = torch.tensor([-0.0, 0.0, -0.0, 0.0], dtype=tdt, device=dev)
        y = torch.tensor([0.3, 0.3, -0.3, -0.3], dtype=tdt, device=dev)
        got = (kern.launch if on_card else kern)(x, y)[0]
        if torch.signbit(got).cpu().tolist() != [True, False, False, True] or not torch.equal(
                torch.signbit(got), torch.signbit(kern.plain(x, y)[0])):
            raise AssertionError(f"K1 {dtype} floor division: signs {torch.signbit(got)}")
    say("K1 floor division of a signed zero, float32 and float64: (-0.0) // 0.3 = -0.0, 0.0 // "
        "-0.3 = -0.0, (-0.0) // -0.3 = 0.0, numpy's signs and its plain version's")
    say(f"tail phase done in {time.perf_counter() - t16:.1f} s")
    return launches, k1_abs, k2_abs, timed


# the logistic-regression MAP of phase 17: benchsuite.py:64's width
# (LOGREG_N x LOGREG_D), the prior's precision and jax's gtol
MAP_LAM, MAP_GTOL = 1e-3, 1e-5
# the periodogram: 64 signals of 262,144 float32 samples; every complex op
# at 2**24 elements; numpy's complex128 value taken on the first 2**16
PERIODOGRAM_ROWS, PERIODOGRAM_N = 64, 262144
COMPLEX_N, COMPLEX_NUMPY_N = 2 ** 24, 2 ** 16
# the MAP against float64 NumPy (scipy's BFGS with the analytic gradient to
# |g|_inf < 1e-10, and the closed forms of the IFT gradients at the port's
# own x*): |g|_inf at the BFGS x* over jax's gtol; BFGS's and Newton's x*
# against scipy's (max abs); d sum(w*)/d lam (relative) and d sum(w*)/d X
# (over its max) against the closed forms, which leave out the graph's eps
# of 1e-7 in the logs.  A rehearsal on the CPU (torch's CPU kernels, the
# same data) read 9.8e-6 / 1.25e-5 (|g|_inf; jax's own float32 fit stops at
# 1.03e-5 too), 4.7e-4 / 5.6e-4 (BFGS), 4.1e-8 / 2.2e-7 (Newton), 2.1e-7 /
# 1.9e-5 (lam) and 5.1e-7 / 5.7e-6 (X) in float64 / float32, and the H100
# the same to two digits (|g|_inf 9.78e-6 / 1.25e-5 to 1.26e-5, BFGS
# 5.6e-4 to 5.7e-4 in float32); held at 2x and 4x jax's gtol (a float32
# fit stopped early reads more), BFGS's x* at ~4x and the others at ~4-10x
MAP_TOL = {"gmax": {"float64": 2.0, "float32": 4.0},
           "bfgs_w": {"float64": 2e-3, "float32": 2e-3},
           "newton_w": {"float64": 5e-7, "float32": 2e-5},
           "glam": {"float64": 2e-6, "float32": 2e-4},
           "gX": {"float64": 5e-6, "float32": 6e-5}}
# the periodogram against float64 NumPy on 4 rows: the power over its
# largest value, the phase where |c| is above 1e-3 of its largest (a
# float32 FFT of 2**18 samples)
PERIODOGRAM_TOL = {"power": 1e-5, "phase": 2e-3}
# one PyTorch call of each complex op, the library time beside K1's
COMPLEX_LIBRARY = {
    "real": lambda z: z.real.clone(), "imag": lambda z: z.imag.clone(),
    "conj": lambda z: __import__("torch").conj_physical(z),
    "angle": lambda z: __import__("torch").angle(z),
    "complex": lambda a, b: __import__("torch").complex(a, b),
    "abs": lambda z: __import__("torch").abs(z), "neg": lambda z: -z,
    "add": lambda a, b: a + b, "sub": lambda a, b: a - b, "mul": lambda a, b: a * b,
    "true_div": lambda a, b: a / b, "sqr": lambda z: z * z,
    "exp": lambda z: __import__("torch").exp(z), "log": lambda z: __import__("torch").log(z),
    "sqrt": lambda z: __import__("torch").sqrt(z), "eq": lambda a, b: a == b,
    "neq": lambda a, b: a != b, "identity": lambda z: z.clone()}


def optimize_paths(dev):
    """The functions of phase 17 on ``dev``: for each float dtype the BFGS
    fit (``minimize``), the Newton fit (``root`` of the gradient) and the
    IFT gradients (``d sum(w*) / d lam`` and ``/ d X``) of the MAP of
    ``models/logreg.py``'s cross-entropy plus ``0.5 lam |w|^2`` over ``w``,
    with their arguments ``(w0 = 0, X, y, b = 0, lam)``; and the
    periodogram (``cases.periodogram_graph``)."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.link.cuda import cases
    from pytensor_tpu_torch.models.logreg import _xent, make_logreg_graphs
    from pytensor_tpu_torch.tensor.optimize import minimize, root

    fits = {}
    for dtype in ("float64", "float32"):
        (X, y, w, b), _, (Xv, yv, wv, bv) = make_logreg_graphs(LOGREG_N, LOGREG_D, dtype)
        lam = pt.tensor("lam", dtype=dtype, shape=())
        obj = _xent(X, y, w, b, dtype) + 0.5 * lam * pt.sum(w ** 2)
        (ws, ok), _ = minimize(obj, w)
        (wr, okr), _ = root(ptt.grad(obj, w), w)
        glam, gX = ptt.grad(pt.sum(ws), [lam, X])
        ins = [w, X, y, b, lam]
        fits[dtype] = ({"bfgs": ptt.function(ins, [ws, ok], device=dev),
                        "newton": ptt.function(ins, [wr, okr], device=dev),
                        "ift": ptt.function(ins, [glam, gX], device=dev)},
                       (wv, Xv, yv, bv, np.asarray(MAP_LAM, dtype)))
    return fits, ptt.function(*cases.periodogram_graph(), device=dev)


def plan_kernels(plan, dev, out):
    """The K1 kernels of ``plan`` and of the plans inside its steps (a BFGS
    loop's evaluations, Newton's Jacobian), made for ``dev``, by key."""
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    for fn, nd, _, _ in plan.steps:
        if isinstance(nd.op, FusedElemwise):
            k = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
            out.setdefault(k.key, k)
        inner = getattr(fn, "inner", None)
        if hasattr(fn, "bfgs"):
            inner = fn.bfgs.ev.plan
        if inner is not None:
            plan_kernels(inner, dev, out)
    return out


def plan_values(plan, args):
    """Run ``plan`` on ``args`` (tensors on its device) step by step, as
    ``Plan.run`` does but freeing nothing: ``[(lowering, node, its
    arguments)]`` for every step, the real inputs of each node."""
    storage, seen = dict(zip(plan.inputs, args)), []
    for fn, node, spec, _ in plan.steps:
        vals = [v if kind == "const" else storage[v] for kind, v in spec]
        res = fn(*vals)
        seen.append((fn, node, vals))
        storage.update(zip(node.outputs, res if isinstance(res, (list, tuple)) else [res]))
    return seen


def map_node_values(fns, args, w_star):
    """The K1 nodes of a MAP's functions with their real inputs: each
    FusedElemwise of the BFGS, Newton and IFT plans at their arguments
    (``w = 0``), of BFGS's evaluation plan (one inside the BFGS fit, one
    inside the IFT gradient's) at ``w = 0`` and at ``w*`` along ``-g`` with
    a step of 1, and of Newton's ``f``-and-Jacobian plan at both points.
    Returns ``[(where, node, its arguments)]``."""
    import torch

    from pytensor_tpu_torch.tensor.fused import FusedElemwise
    from pytensor_tpu_torch.tensor.optimize import RootOp

    found = []
    for kind, f in fns.items():
        plan = getattr(f.linked, "plan", f.linked)
        for fn, node, vals in plan_values(plan, args):
            if isinstance(node.op, FusedElemwise):
                found.append((kind, node, vals))
            if not (hasattr(fn, "bfgs") or isinstance(node.op, RootOp)):
                continue
            for x, at in ((vals[0], "w = 0"), (w_star, "w*")):
                if hasattr(fn, "bfgs"):
                    ev = fn.bfgs.ev.plan
                    t = torch.ones((), dtype=x.dtype, device=x.device)
                    _, g = ev.execute([x, torch.zeros_like(x), t, *vals[1:]])
                    inner = plan_values(ev, [x, -g, t, *vals[1:]])
                    where = f"{kind}: an evaluation at {at}"
                else:
                    inner = plan_values(fn.inner, [x, *vals[1:]])
                    where = f"{kind}: f and its Jacobian at {at}"
                found += [(where, nd, v) for _, nd, v in inner if isinstance(nd.op, FusedElemwise)]
    return found


def optimize_kernels(dev):
    """The kernels of phase 17, for the build pool of phase 2: the K1
    kernels of its functions (linked on the CPU, the same sources, so that
    linking them for the card finds them built) and every complex op K1
    emits as a one-node kernel in each complex dtype, and the periodogram's
    whole chain as one kernel (``cases.periodogram_chain``).  Returns (the
    functions' K1 kernels and the chain's, ``{(op, dtype): kernel}``)."""
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.cuda import cases
    from pytensor_tpu_torch.tensor import fused_kernel

    fits, periodogram = optimize_paths("cpu")
    kerns: dict = {}
    for fns, _ in fits.values():
        for f in fns.values():
            plan_kernels(f.linked, dev, kerns)
    plan_kernels(periodogram.linked, dev, kerns)
    chain = fused_kernel.FusedElemwiseKernel(
        FunctionGraph(*cases.periodogram_chain(), clone=True), dev)
    kerns.setdefault(chain.key, chain)
    one_node = {}
    for dtype in ("complex64", "complex128"):
        for name in cases.COMPLEX_OPS:
            node = cases.complex_node(name, dtype)
            one_node[name, dtype] = fused_kernel.FusedElemwiseKernel(
                FunctionGraph(list(node.inputs), node.outputs, clone=True), dev)
    return list(kerns.values()), one_node


def logreg_map_reference(X, y, lam):
    """The MAP in float64 NumPy: scipy's BFGS with the analytic gradient
    from 0 to |g|_inf < 1e-10 (the objective of ``models/logreg.py``, its
    eps of 1e-7 in the logs included), and ``grad(w)`` for the port's x*."""
    import scipy.optimize as sopt

    X = X.astype(np.float64)
    y = y.astype(np.float64)
    n = len(y)

    def f_and_g(w):
        p = 1 / (1 + np.exp(-(X @ w)))
        a, b_ = p + 1e-7, 1 - p + 1e-7
        f = -np.mean(y * np.log(a) + (1 - y) * np.log(b_)) + 0.5 * lam * w @ w
        dz = -(y / a - (1 - y) / b_) * p * (1 - p)
        return f, X.T @ dz / n + lam * w

    res = sopt.minimize(f_and_g, np.zeros(X.shape[1]), jac=True, method="BFGS",
                        options={"gtol": 1e-10, "maxiter": 5000})
    return res.x, (lambda w: f_and_g(np.asarray(w, np.float64))[1])


def ift_closed_forms(X, y, lam, w):
    """At ``w`` (float64): ``d sum(w*)/d lam = -1^T H^-1 w`` and
    ``d sum(w*)/d X = -(outer(r, v) + outer((X v) p (1 - p), w)) / n`` with
    ``H = X^T diag(p(1-p)) X / n + lam I``, ``v = H^-1 1`` and ``r = p - y``
    (the logs' eps left out)."""
    X = X.astype(np.float64)
    n = len(y)
    p = 1 / (1 + np.exp(-(X @ w)))
    d = p * (1 - p)
    H = X.T @ (X * d[:, None]) / n + lam * np.eye(len(w))
    v = np.linalg.solve(H, np.ones(len(w)))
    return -v @ w, -(np.outer(p - y, v) + np.outer((X @ v) * d, w)) / n


def complex_held_on(dev_got, dev_want, name, dtype):
    """``cases.complex_held`` on the card's tensors, without moving 2**24
    values to the host: the exact ops bit for bit, the others within
    ``cases.COMPLEX_ULPS`` epsilons of max(|plain|, the least normal) in the
    modulus of the difference, NaN where the plain version has NaN."""
    import torch

    from pytensor_tpu_torch.link.cuda import cases

    if dev_got.dtype == torch.bool or name in cases.COMPLEX_EXACT:
        real = torch.view_as_real(dev_got) if dev_got.is_complex() else dev_got
        real_w = torch.view_as_real(dev_want) if dev_want.is_complex() else dev_want
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64, 1: torch.uint8}
        return bool(torch.equal(real.view(bits[real.element_size()]),
                                real_w.view(bits[real_w.element_size()])))
    nan_g, nan_w = dev_got.isnan(), dev_want.isnan()
    if not torch.equal(nan_g, nan_w):
        return False
    eps = float(np.finfo(np.float32 if dtype == "complex64" else np.float64).eps)
    tiny = float(np.finfo(np.float32 if dtype == "complex64" else np.float64).tiny)
    ok = torch.isfinite(dev_want) & ~nan_w
    err = (dev_got[ok] - dev_want[ok]).abs().double()
    scale = dev_want[ok].abs().double().clamp(min=tiny)
    return bool((err <= cases.COMPLEX_ULPS * eps * scale).all())


def phase_optimize(dev, smi_line, one_node):
    """Phase 17: ``tensor/optimize.py`` and the complex ops.  (a) the MAP of
    ``models/logreg.py`` at n 8,192, d 256, lam 1e-3, from w = 0, in float64
    and float32: BFGS (``minimize``: an eager plan around its captured
    evaluations, each a replay with its K1 launches), Newton (``root`` of
    the gradient: 25 steps, the whole fit one captured CUDA graph) and the
    IFT gradients ``d sum(w*)/d lam`` and ``d sum(w*)/d X`` (``L_op``),
    against float64 NumPy (``logreg_map_reference``, ``ift_closed_forms``,
    ``MAP_TOL``); BFGS's iterations, evaluations, reads and status, its
    device ms and K1 launches an evaluation, the Newton fit's and the IFT
    gradient's wall ms; each K1 node of the fits fed its real inputs at
    ``w = 0`` and ``w*`` (``map_node_values``) against its plain version
    (``K1_RTOL``).  (b) the periodogram (64 x 262,144 float32, captured:
    ``complex``, one K1 node of ``abs`` and ``sqr``, ``angle``, as the JAX
    package groups them) against float64 NumPy (``PERIODOGRAM_TOL``), its
    K1 node and its whole chain as one K1 kernel
    (``cases.periodogram_chain``) against their plain versions, the chain
    timed both ways; every
    complex op K1 emits (``one_node``) at 2**24 elements in both complex
    dtypes against its plain version (``complex_held_on``) and, on the
    first 2**16, numpy complex128 (``cases.complex_near``), its device time
    from CUDA events beside its plain version's, one PyTorch call's
    (``COMPLEX_LIBRARY``) and its byte bound.  Counts are set to 0 just
    before the fits and the periodogram are driven (after a first,
    capturing call of each) and read just after.  Returns the launches by
    path, K1's largest absolute error and the rows it timed.  On the CPU
    (a rehearsal) it checks the values only."""
    import torch

    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.cuda import cases, scan_kernel, spmv_kernel
    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction, fgraph_to_torch
    from pytensor_tpu_torch.models import radon_kernel
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.elemwise import Elemwise
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t17 = time.perf_counter()

    def zero_counts():
        fused_kernel.LAUNCHES = radon_kernel.LAUNCHES = scan_kernel.LAUNCHES = 0
        spmv_kernel.LAUNCHES = 0

    def counts():
        return {"fused_elemwise": fused_kernel.LAUNCHES, "scan_whole_loop": scan_kernel.LAUNCHES}

    fits, periodogram = optimize_paths(dev)
    say(f"phase 17 functions linked in {time.perf_counter() - t17:.1f} s")
    gen = torch.Generator(device=dev).manual_seed(17)
    signal = torch.randn(PERIODOGRAM_ROWS, PERIODOGRAM_N, generator=gen, device=dev)
    args = {dt: [as_torch(a, dev) for a in vals] for dt, (_, vals) in fits.items()}
    # a first call of each: the captures (BFGS's evaluations, Newton's fit,
    # the IFT gradient's evaluations, the periodogram)
    for dt, (fns, _) in fits.items():
        for f in fns.values():
            f(*args[dt])
    periodogram(signal)
    sync()
    if on_card:
        for dt, (fns, _) in fits.items():
            if not isinstance(fns["newton"].linked, CapturedFunction):
                raise AssertionError(f"Newton {dt}: not captured: {fns['newton'].linked.host_reads}")
            for kind in ("bfgs", "ift"):
                reads = fns[kind].linked.host_reads
                if not (len(reads) == 1 and "MinimizeOp" in reads[0]):
                    raise AssertionError(f"{kind} {dt}: host reads {reads}")
        if not isinstance(periodogram.linked, CapturedFunction):
            raise AssertionError(f"periodogram: not captured: {periodogram.linked.host_reads}")
    # the main path, counted -------------------------------------------------
    launches, out, secs = {}, {}, {}
    for dt, (fns, _) in fits.items():
        zero_counts()
        t = time.perf_counter()
        out[dt, "bfgs"] = fns["bfgs"](*args[dt])
        sync()
        secs[dt, "bfgs"] = time.perf_counter() - t
        out[dt, "newton"] = fns["newton"](*args[dt])
        out[dt, "ift"] = fns["ift"](*args[dt])
        sync()
        launches[f"logreg MAP {dt}"] = counts()
    zero_counts()
    power, phase = periodogram(signal)
    sync()
    launches["periodogram"] = counts()
    say(f"phase 17 launches, counts set to 0 just before each path and read just after: "
        f"{launches}")
    for path, c in launches.items():
        if on_card and c["fused_elemwise"] < 1:
            raise AssertionError(f"{path}: K1 never launched")
    # (a) the MAP against float64 NumPy ------------------------------------------
    rows = {}
    k1_abs = 0.0
    for dt, (fns, vals) in fits.items():
        wv, Xv, yv, bv, lam = vals
        w_ref, grad_ref = logreg_map_reference(Xv, yv, MAP_LAM)
        w_b, ok_b = (v.cpu().numpy() for v in out[dt, "bfgs"])
        w_n, ok_n = (v.cpu().numpy() for v in out[dt, "newton"])
        glam, gX = (v.cpu().numpy() for v in out[dt, "ift"])
        (bfgs,) = [fn.bfgs for fn, _, _, _ in fns["bfgs"].linked.steps if hasattr(fn, "bfgs")]
        rec = bfgs.last
        gmax = float(np.abs(grad_ref(w_b)).max())
        e_b = float(np.abs(w_b - w_ref).max())
        e_n = float(np.abs(w_n - w_ref).max())
        glam_ref, gX_ref = ift_closed_forms(Xv, yv, MAP_LAM, w_b.astype(np.float64))
        e_glam = abs(float(glam) - glam_ref) / abs(glam_ref)
        e_gX = float(np.abs(gX - gX_ref).max() / np.abs(gX_ref).max())
        finite = all(np.all(np.isfinite(v)) for v in (w_b, w_n, glam, gX))
        say(f"logreg MAP {dt} (n {LOGREG_N:,}, d {LOGREG_D}, lam {MAP_LAM:g}, from 0): BFGS "
            f"{rec['iterations']} iterations, {rec['evaluations']} evaluations, {rec['reads']} "
            f"reads of the card, status {rec['status']}, success {bool(ok_b)}, |g|_inf at x* "
            f"{gmax:.3e} in float64 (jax's gtol {MAP_GTOL:g}, held to "
            f"{MAP_TOL['gmax'][dt]:g}x), x* {e_b:.2e} from scipy's converged x* (tol "
            f"{MAP_TOL['bfgs_w'][dt]:g}); Newton x* {e_n:.2e} from it (tol "
            f"{MAP_TOL['newton_w'][dt]:g}), success {bool(ok_n)}; IFT d sum(w*)/d lam "
            f"{float(glam):.6f} against the closed form {glam_ref:.6f} at the same x* (rel "
            f"{e_glam:.2e}, tol {MAP_TOL['glam'][dt]:g}), d sum(w*)/d X {e_gX:.2e} of its max "
            f"(tol {MAP_TOL['gX'][dt]:g})")
        if not (finite and w_b.shape == (LOGREG_D,) and gX.shape == (LOGREG_N, LOGREG_D)
                and gmax <= MAP_TOL["gmax"][dt] * MAP_GTOL and e_b <= MAP_TOL["bfgs_w"][dt]
                and e_n <= MAP_TOL["newton_w"][dt] and e_glam <= MAP_TOL["glam"][dt]
                and e_gX <= MAP_TOL["gX"][dt]):
            raise AssertionError(f"logreg MAP {dt}: gmax {gmax}, x* {e_b}, Newton {e_n}, glam "
                                 f"{e_glam}, gX {e_gX}; tol {MAP_TOL}")
        row = {"iterations": rec["iterations"], "evaluations": rec["evaluations"],
               "reads": rec["reads"], "status": rec["status"], "success": bool(ok_b),
               "gmax": gmax, "newton_success": bool(ok_n)}
        if on_card:
            ev = bfgs.ev
            graph = next(iter(ev.graphs.values()))
            ev_k1 = sum(n for k, n in graph.launches if k is fused_kernel)
            ev_ms, _ = device_ms(graph.run, 20)
            fit_ms = wall_ms(lambda: fns["bfgs"](*args[dt]), 3, warmup=1)
            newton_ms = wall_ms(lambda: fns["newton"](*args[dt]), 5)
            ift_ms = wall_ms(lambda: fns["ift"](*args[dt]), 3, warmup=1)
            row.update(fit_wall_ms=fit_ms, evaluation_device_ms=ev_ms, k1_an_evaluation=ev_k1,
                       newton_wall_ms=newton_ms, ift_wall_ms=ift_ms)
            say(f"logreg MAP {dt} ({smi_line}): BFGS fit wall {fit_ms:.2f} ms "
                f"({fit_ms / rec['evaluations']:.3f} ms an evaluation with its reads and the "
                f"update), an evaluation's replay {ev_ms:.4f} ms on the card with {ev_k1} K1 "
                f"launches; Newton's 25 steps, one captured graph, wall {newton_ms:.2f} ms; the "
                f"IFT gradient function (its BFGS fit, the Hessian and the solve) wall "
                f"{ift_ms:.2f} ms")
        # each K1 node of the fits, fed its real inputs, against its plain version
        nodes = map_node_values(fns, args[dt], out[dt, "bfgs"][0])
        node_abs, node_rel = 0.0, 0.0
        for where, nd, xs in nodes:
            kern = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
            got, want = (kern.launch if on_card else kern)(*xs), kern.plain(*xs)
            sync()
            for g, w in zip(got, want):
                e_abs, e_rel = errors(g.cpu(), w.cpu())
                node_abs, node_rel = max(node_abs, e_abs), max(node_rel, e_rel)
                if e_rel > K1_RTOL.get(str(w.dtype).removeprefix("torch."), 0.0):
                    raise AssertionError(f"K1 logreg MAP {dt}, {where}, {nd.op}: {e_abs} "
                                         f"({e_rel} of max(1, |plain|)) from its plain version")
        k1_abs = max(k1_abs, node_abs)
        by_where = {}
        for where, _, _ in nodes:
            by_where[where] = by_where.get(where, 0) + 1
        say(f"logreg MAP {dt}: its {len(nodes)} K1 nodes fed their real inputs ({by_where}) "
            f"within {node_abs:.2e} ({node_rel:.2e} of max(1, |plain|); tol "
            f"{K1_RTOL[dt]:g}) of their plain versions")
        row["k1_nodes_held"] = len(nodes)
        rows[f"logreg MAP {dt}"] = row
    # (b) the periodogram and the complex ops ----------------------------------------
    x4 = signal[:4].double().cpu().numpy()
    spec = np.fft.rfft(x4)
    p_ref, a_ref = np.abs(spec) ** 2, np.angle(spec)
    e_pow = float(np.abs(power[:4].cpu().numpy() - p_ref).max() / p_ref.max())
    big = np.abs(spec) > 1e-3 * np.abs(spec).max()
    dphi = np.abs(np.angle(np.exp(1j * (phase[:4].cpu().numpy() - a_ref))))[big]
    e_phase = float(dphi.max())
    fg = periodogram.fgraph
    (pnode,) = [nd for nd in fg.toposort() if isinstance(nd.op, FusedElemwise)]
    feed = fgraph_to_torch(FunctionGraph(fg.inputs, pnode.inputs, clone=True), dev)
    pargs = list(feed(signal))
    pkern = fused_kernel.FusedElemwiseKernel(pnode.op.fgraph, dev)
    pgot, pwant = (pkern.launch if on_card else pkern)(*pargs), pkern.plain(*pargs)
    sync()
    p_held = all(complex_held_on(g, w, "abs", "complex64") for g, w in zip(pgot, pwant))
    k1_abs = max([k1_abs] + [float((g - w).abs().max()) for g, w in zip(pgot, pwant)])
    # the chain as the port runs it (``complex``, the K1 node, ``angle``; the
    # JAX package's grouping) and as one K1 kernel that keeps c in registers
    chain = [(fn, nd, v) for fn, nd, v in plan_values(getattr(periodogram.linked, "plan",
                                                              periodogram.linked), [signal])
             if isinstance(nd.op, (Elemwise, FusedElemwise))]
    parts = chain[0][2]
    ckern = fused_kernel.FusedElemwiseKernel(
        FunctionGraph(*cases.periodogram_chain(), clone=True), dev)
    cgot, cwant = (ckern.launch if on_card else ckern)(*parts), ckern.plain(*parts)
    sync()
    c_held = all(complex_held_on(g, w, "abs", "complex64") for g, w in zip(cgot, cwant))
    k1_abs = max([k1_abs] + [float((g - w).abs().max()) for g, w in zip(cgot, cwant)])
    say(f"periodogram ({PERIODOGRAM_ROWS} x {PERIODOGRAM_N:,} float32): the chain's nodes "
        f"{[str(nd.op) for _, nd, _ in chain]}, fused ops "
        f"{sorted(n.op.scalar_op.name for n in pnode.op.fgraph.toposort())} in its one K1 node, "
        f"inputs of layout classes {pkern._layout(pkern._args(pargs)).classes[0]}; the whole "
        f"chain as one K1 kernel within {cases.COMPLEX_ULPS} epsilons of its plain version: "
        f"{c_held}; power "
        f"{e_pow:.2e} of its max from float64 NumPy on 4 rows (tol {PERIODOGRAM_TOL['power']:g}), "
        f"phase {e_phase:.2e} where |c| > 1e-3 max|c| (tol {PERIODOGRAM_TOL['phase']:g}); its K1 "
        f"node within {cases.COMPLEX_ULPS} epsilons of its plain version: {p_held}")
    if not (p_held and c_held and e_pow <= PERIODOGRAM_TOL["power"]
            and e_phase <= PERIODOGRAM_TOL["phase"]
            and power.shape == (PERIODOGRAM_ROWS, PERIODOGRAM_N // 2 + 1)):
        raise AssertionError(f"periodogram: power {e_pow}, phase {e_phase}, K1 node {p_held}, "
                             f"the chain as one kernel {c_held}")
    if on_card:
        # past the L2: means after a flush, bounds of the bytes that must
        # reach device memory (stream_ms, stream_bound)
        p_ms = stream_ms(lambda: pkern.launch(*pargs), 20)
        p_plain = wall_ms(lambda: pkern.plain(*pargs), 20)
        p_bound = stream_bound(nbytes(*pargs, *pgot), 0, 20)
        p_wall = wall_ms(lambda: periodogram(signal), 10)
        chain_ms = stream_ms(lambda: [fn(*v) for fn, _, v in chain], 20)
        one_ms = stream_ms(lambda: ckern.launch(*parts), 20)
        c_bound = stream_bound(nbytes(*parts, *cgot), 0, 20)
        rows["periodogram"] = {"wall_ms": p_wall, "k1_ms": p_ms, "plain_ms": p_plain,
                               "bound_ms": p_bound[0], "bound_by": p_bound[1],
                               "chain_ms": chain_ms, "chain_one_kernel_ms": one_ms,
                               "chain_bound_ms": c_bound[0]}
        say(f"periodogram ({smi_line}): a call wall {p_wall:.3f} ms (captured: the FFT, the "
            f"slices, complex, the K1 node and angle); the K1 node {p_ms * 1e3:.1f} us (CUDA "
            f"events, 20 launches after an L2 flush), plain {p_plain * 1e3:.1f} us, bound "
            f"{p_bound[0] * 1e3:.1f} "
            f"us ({nbytes(*pargs, *pgot) / 2 ** 20:.0f} MiB moved); the chain from the two "
            f"parts {chain_ms * 1e3:.1f} us as the port runs it (three launches, c written "
            f"and read twice) against {one_ms * 1e3:.1f} us as one K1 kernel, bound "
            f"{c_bound[0] * 1e3:.1f} us ({nbytes(*parts, *cgot) / 2 ** 20:.0f} MiB moved)")
    n = COMPLEX_N if on_card else 4099
    ops, bad = {}, []
    for (name, dtype), kern in one_node.items():
        edges = torch.from_numpy(cases.complex_values(dtype, cases.N_COMPLEX_EDGES, 0)).to(dev)
        cdt = getattr(torch, dtype)
        zargs = []
        for k, var in enumerate(kern.inputs):
            if var.type.dtype == dtype:
                z = torch.randn(n, dtype=cdt, generator=gen, device=dev) * 3
                z[: len(edges)] = edges.roll(5 * k)
            else:
                z = torch.randn(n, dtype=getattr(torch, var.type.dtype), generator=gen,
                                device=dev) * 3
            zargs.append(z)
        (got,) = (kern.launch if on_card else kern)(*zargs)
        (want,) = kern.plain(*zargs)
        sync()
        held = complex_held_on(got, want, name, dtype)
        ref = cases.numpy_complex_op(name, [a[:COMPLEX_NUMPY_N].cpu().numpy() for a in zargs])
        near = cases.complex_near(got[:COMPLEX_NUMPY_N].cpu().numpy(), ref, dtype)
        if not (held and near):
            bad.append(f"{name} {dtype}: against its plain version {held}, numpy {near}")
        if got.dtype != torch.bool:
            fin = torch.isfinite(want)
            k1_abs = max(k1_abs, float((got[fin] - want[fin]).abs().max()))
        if on_card:
            k_ms = stream_ms(lambda: kern.launch(*zargs), 12)
            pl_ms = wall_ms(lambda: kern.plain(*zargs), 12)
            lib_ms = stream_ms(lambda: COMPLEX_LIBRARY[name](*zargs), 12)
            b_ms, b_by = stream_bound(nbytes(*zargs, got), 0, 12)
            ops[f"{name} {dtype}"] = {"ms": k_ms, "plain_ms": pl_ms, "library_ms": lib_ms,
                                      "bound_ms": b_ms, "bound_by": b_by}
        del zargs, got, want
    if bad:
        raise AssertionError(f"K1 complex ops: {bad}")
    say(f"K1 complex ops: {len(one_node)} op-dtype pairs at {n:,} elements held against the "
        f"plain version (exact ops bit for bit, the others within {cases.COMPLEX_ULPS} "
        f"epsilons) and on the first {COMPLEX_NUMPY_N:,} against numpy complex128")
    if on_card:
        for key, r in ops.items():
            say(f"  K1 {key:20s} {r['ms'] * 1e3:8.1f} us (CUDA events), plain "
                f"{r['plain_ms'] * 1e3:8.1f} us, torch's call {r['library_ms'] * 1e3:8.1f} us, "
                f"bound {r['bound_ms'] * 1e3:7.1f} us ({r['bound_by']}), "
                f"{r['bound_ms'] / r['ms']:.2f} of it reached ({smi_line})")
        rows["complex_ops_2e24"] = ops
    say(f"optimize phase done in {time.perf_counter() - t17:.1f} s")
    return launches, k1_abs, rows


# --- phase 18: random and HMC ---------------------------------------------------

# jax's answers, embedded since the card's machine has no jax: the three
# Random123 known answers of threefry2x32 (key, the 64-bit counter, the
# two words) and split(PRNGKey(42))
RANDOM123 = [((0, 0), 0, (0x6B200159, 0x99BA4EFE)),
             ((0xFFFFFFFF, 0xFFFFFFFF), 2 ** 64 - 1, (0x1CB996FC, 0xBB002BE7)),
             ((0x13198A2E, 0x03707344), 0x243F6A8885A308D3, (0xC4923A9C, 0x483DF7A0))]
SPLIT_42 = [[1832780943, 270669613], [64467757, 2916123636]]
THREEFRY_N = 2 ** 24
# the threefry hashes the card can make a second (the bounds of threefry
# and the loop samplers' kernels): on the card from the hash's SASS
# (``hash_instructions``); until then from the hash as written, 20 rounds
# of an add, a rotate and an xor and 5 key injections of two adds, as ALU
# instructions
HASH_SASS = {"alu": 20 * 3 + 5 * 2, "fma": 0, "all": 20 * 3 + 5 * 2}


def hash_rate(sass):
    """The hashes the card can make a second from one hash's SASS by pipe:
    the ALU pipe (IADD3, LOP3, SHF) and the FMA pipe (IMAD) each take 64
    lanes an SM a clock, and the four schedulers dispatch 128."""
    return SM_CLOCKS_S / max(sass["alu"] / ALU_LANES, sass["fma"] / FMA_LANES,
                             sass["all"] / DISPATCH_LANES)


HASH_S = hash_rate(HASH_SASS)
# the threefry kernel's SASS a draw by pipe in each mode
# (``threefry_instructions``) and normal64's FP64-pipe instructions a draw
# (``normal_instructions``), set by say_builds
THREEFRY_SASS: dict = {}
NORMAL_FP64: dict = {}
# the normals: CUDA's erfinv against torch's, in float64
NORMAL_RTOL = 1e-11
HMC_CHAINS, HMC_STEPS, HMC_EPS = 256, 16, 0.02
# transitions held against the same function on the CPU: the accept flags
# and indices equal, logp and the position within HMC_RTOL of their largest
# magnitude (a float32 leapfrog of 16 steps rounds differently on the card)
HMC_HELD = 4
HMC_RTOL = 2e-4
# threefry's launches in one transition (one replayed call)
HMC_THREEFRY_LAUNCHES = 2
HMC_PATHS = {"hmc 1 chain": "make_radon_hmc", "hmc 256 chains": "make_radon_hmc_chains",
             "multinomial hmc": "make_radon_multinomial_hmc"}


def hmc_functions(dev, pallas=False):
    """The three HMC entry points of ``models/hmc.py`` at the radon model's
    full width (919 observations, 85 counties, 16 leapfrog steps of 0.02;
    256 chains), linked for ``dev`` with ``scan__pallas`` as given."""
    import pytensor_tpu_torch.models.hmc as hmc
    from pytensor_tpu_torch.config import config

    kw = dict(n_obs=N_OBS, n_counties=N_COUNTIES, n_leapfrog=HMC_STEPS, step_size=HMC_EPS,
              device=dev)
    with config.change_flags(scan__pallas=pallas):
        return {"hmc 1 chain": hmc.make_radon_hmc(**kw),
                "hmc 256 chains": hmc.make_radon_hmc_chains(n_chains=HMC_CHAINS, **kw),
                "multinomial hmc": hmc.make_radon_multinomial_hmc(**kw)}


def random_kernels(dev):
    """The kernels of phase 18, for the build pool of phase 2: the K1
    kernels of the HMC functions, made from the functions linked for the
    CPU (the same graphs, so the same sources; phase 18 runs those
    functions as the card's reference).  Returns (the kernels, the CPU
    functions)."""
    cpu = hmc_functions("cpu")
    kerns: dict = {}
    for f, *_ in cpu.values():
        plan_kernels(f.linked, dev, kerns)
    return list(kerns.values()), cpu


# back-to-back launches a 2**24 threefry row is timed over (stream_ms)
THREEFRY_STREAM = 20
def c_params(src, entry):
    """The parameter names of the C entry ``entry`` in the source ``src``
    (empty if it has none)."""
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    return [a.split()[-1].lstrip("*") for a in m.group(1).split(",")] if m else []


def parent_threefry(root):
    """The threefry draw as built from the tree at ``root`` (its
    ``csrc/threefry.cu`` with its own header), through its C entry
    ``threefry2x32_draw``: this tree's, whose ``split`` it passes null and
    which returns the launches it made, or the earlier trees' (no
    ``split``; 0 on success): ``draw(key, n, mode, lo, hi)``.  Its
    launches are not counted."""
    import torch

    from pytensor_tpu_torch.link.cuda import threefry_kernel as tk
    from pytensor_tpu_torch.link.cuda.build import build_library

    src = Path(root, "pytensor_tpu_torch", "csrc", "threefry.cu")
    text = src.with_suffix(".cuh").read_text() + src.read_text()
    fold = [None] if "split" in c_params(src.read_text(), "threefry2x32_draw") else []
    lib = build_library(text, "threefry_parent", src, False)[0]
    p = ctypes.c_void_p
    lib.threefry2x32_draw.argtypes = [p, *[p for _ in fold], ctypes.c_ulonglong,
                                      ctypes.c_longlong, ctypes.c_int, p, ctypes.c_double,
                                      ctypes.c_double, p]
    lib.threefry2x32_draw.restype = ctypes.c_int

    def draw(key, n, mode, lo=0.0, hi=1.0):
        out = torch.empty(tk._shape(n, mode), dtype=tk._OUT[mode], device=key.device)
        err = lib.threefry2x32_draw(key.data_ptr(), *fold, 0, n, mode, out.data_ptr(), lo, hi,
                                    torch.cuda.current_stream(key.device).cuda_stream)
        if err < 0 or (err and not fold):
            raise RuntimeError(f"the parent's threefry launch failed: {err}")
        return out

    return draw


def threefry_beside_parent(key, n, modes, parent, held):
    """Each mode's draws at ``n`` against the parent's kernel (the same
    draws required: ``held``) and the two timed in turn, twice, by
    ``stream_ms``: {mode: {"this": [ms, ms], "parent": [ms, ms]}}."""
    from pytensor_tpu_torch.link.cuda import threefry_kernel as tk

    theirs = parent_threefry(parent)
    got = {}
    for name, (mode, lo, hi) in modes.items():
        if not held(name, tk.launch(key, n, mode, lo, hi), theirs(key, n, mode, lo, hi))[0]:
            raise AssertionError(f"threefry {name}: the parent's draws differ from this tree's")
        turns = got[f"{name} 2e24"] = {"this": [], "parent": []}
        for _ in range(2):
            for who, fn in (("this", lambda: tk.launch(key, n, mode, lo, hi)),
                            ("parent", lambda: theirs(key, n, mode, lo, hi))):
                turns[who].append(stream_ms(fn, THREEFRY_STREAM))
    return got


def threefry_times(kernel, plain, n_kernel, n_plain):
    """The device ms of a call of the kernel and of its plain version
    (``device_ms``, the kernels the profiler traced) and their wall ms
    (``wall_ms``, CUDA events around back-to-back calls)."""
    return {"ms": device_ms(kernel, n_kernel)[0], "plain_ms": device_ms(plain, n_plain)[0],
            "wall_ms": wall_ms(kernel, n_kernel), "plain_wall_ms": wall_ms(plain, n_plain)}


def phase_random(dev, smi_line, cpu_fns, parent=None):
    """Phase 18: random and HMC.  (a) threefry on the card: the kernel's
    bits against its plain version (``tensor/random/threefry.py``, int64
    torch ops) at 2**24 counters in 32 and 64 bits, its keys, uniforms and
    normals against the port's CPU draws at the same key (uniforms bit for
    bit, normals within ``NORMAL_RTOL``: CUDA's erfinv is not torch's),
    jax's known answers (``RANDOM123``, ``SPLIT_42``), and each mode's time
    at 2**24 and at the draws of the HMC paths (device and wall,
    ``threefry_times``) beside its plain version's and its byte bound.
    (b) ``models/hmc.py``'s three entry points at the radon model's full
    width, with the default flags and with ``scan__pallas``: each call one
    replay of one captured CUDA graph with no host read; the first
    ``HMC_HELD`` transitions against the same function on the CPU (the
    ``cpu_fns`` of ``random_kernels``); the launches of K1, K2 and threefry
    in one call, counts set to 0 just before it and read just after; K2's
    verdict on the leapfrog scan and why; ms a transition and
    transitions/s (chain-transitions/s for 256 chains), the device's busy
    share; each K1 node of the calls, fed its real inputs, against its
    plain version.  Returns the launches by path, K1's largest absolute
    error and the rows it timed.  On the CPU (a rehearsal) it checks the
    values only, at ``THREEFRY_N`` and the HMC functions' sizes as set."""
    import torch

    from pytensor_tpu_torch.link.cuda import scan_kernel
    from pytensor_tpu_torch.link.cuda import threefry_kernel as tk
    from pytensor_tpu_torch.link.cuda.scan_kernel import scan_kernel_eligible
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.scan.op import Scan
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise
    from pytensor_tpu_torch.tensor.random import threefry as tf

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    launch = tk.launch if on_card else tk.plain
    t18 = time.perf_counter()
    rows: dict = {"threefry": {}, "hmc": {}}
    tf_abs = 0.0

    # (a) threefry ---------------------------------------------------------------
    for key, first, want in RANDOM123:
        got = launch(torch.tensor(key, device=dev), 1, tk.KEYS, first=first)[0].tolist()
        if tuple(got) != want:
            raise AssertionError(f"threefry of key {key} at {first:#x}: {got}, jax's {want}")
    seed42 = tf.threefry_seed(42).to(dev)
    folded42 = torch.empty((2, 2), dtype=torch.int64, device=dev)
    launch(seed42, 1, tk.UNIFORM64, split=folded42)
    got = tf.split(seed42).tolist()
    if got != SPLIT_42 or folded42.tolist() != SPLIT_42:
        raise AssertionError(f"split(PRNGKey(42)): {got}, folded {folded42.tolist()}, jax's "
                             f"{SPLIT_42}")
    say(f"threefry: jax's three Random123 answers and split(PRNGKey(42)) = {SPLIT_42}, by a "
        f"split and by a folded draw")
    key = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64, device=dev)
    n = THREEFRY_N if on_card else 2 ** 12
    modes = {"bits32": (tk.BITS32, 0.0, 1.0), "bits64": (tk.BITS64, 0.0, 1.0),
             "keys": (tk.KEYS, 0.0, 1.0), "uniform64": (tk.UNIFORM64, -2.5, 3.0),
             "normal64": (tk.NORMAL64, 0.0, 1.0), "uniform32": (tk.UNIFORM32, -2.5, 3.0)}

    def held(name, got, want):
        """(ok, largest relative error): bit for bit, normals within
        NORMAL_RTOL."""
        if name.startswith("normal"):
            err = float(((got - want).abs() / want.abs().clamp_min(1e-300)).max())
            return err <= NORMAL_RTOL, err
        return torch.equal(got, want), 0.0 if torch.equal(got, want) else float("inf")

    for name, (mode, lo, hi) in modes.items():
        got = launch(key, n, mode, lo, hi)
        want = tk.plain(key, n, mode, lo, hi)
        sync()
        ok, err = held(name, got, want)
        if name == "normal64":
            tf_abs = max(tf_abs, float((got - want).abs().max()))
        if name in ("uniform64", "normal64"):
            # and the port's CPU draws at the same key
            cpu = tk.plain(key.cpu(), n, mode, lo, hi)
            c_ok, cerr = held(name, got.cpu(), cpu)
            tf_abs = max(tf_abs, float((got.cpu() - cpu).abs().max()))
            ok, err = ok and c_ok, max(err, cerr)
        # the folded draw: under split(key)[1], the split written beside it
        fsplit, psplit = (torch.empty((2, 2), dtype=torch.int64, device=dev) for _ in range(2))
        f_ok, f_err = held(name, launch(key, n, mode, lo, hi, split=fsplit),
                           tk.plain(key, n, mode, lo, hi, split=psplit))
        ok = ok and f_ok and torch.equal(fsplit, psplit)
        if not ok:
            raise AssertionError(f"threefry {name} at {n:,}: {max(err, f_err)} from its plain "
                                 f"version (split {fsplit.tolist()} against {psplit.tolist()})")
        row = {"max_rel_err": max(err, f_err)}
        if on_card:
            row.update(threefry_times(lambda: tk.launch(key, n, mode, lo, hi),
                                      lambda: tk.plain(key, n, mode, lo, hi), 20, 3))
            # the traced time of a launch ends when its stores reach the L2:
            # the mean of back-to-back launches after a flush, with the bytes
            # the L2 may still hold at the end taken from the bound
            row["traced_ms"] = row["ms"]
            row["ms"] = stream_ms(lambda: tk.launch(key, n, mode, lo, hi), THREEFRY_STREAM)
            row["bound_ms"], row["bound_by"] = stream_bound(nbytes(key, got), n,
                                                            THREEFRY_STREAM, HASH_S)
            row["hash_bound_ms"] = n / HASH_S * 1e3
            if name == "normal64":
                row["fp64_ms"] = normal64_fp64_ms(n)
                if row["fp64_ms"] > row["bound_ms"]:
                    row["bound_ms"], row["bound_by"] = row["fp64_ms"], "operations"
            within_bound(f"threefry {name} at {n:,}", row)
        rows["threefry"][f"{name} 2e24"] = row
        del got, want
    say(f"threefry: {', '.join(modes)} at {n:,} counters against the plain version (bits, "
        f"keys and uniforms bit for bit, normals within {NORMAL_RTOL:g}), each also folded "
        f"(under split(key)[1], the split written beside: both the plain split's); the "
        f"uniforms and normals against the CPU's draws at the same key the same")
    if on_card:
        for name, r in rows["threefry"].items():
            say(f"  threefry {name:16s} {r['ms'] * 1e3:9.2f} us (CUDA events, "
                f"{THREEFRY_STREAM} launches after a flush; traced {r['traced_ms'] * 1e3:.2f}), "
                f"plain {r['plain_ms'] * 1e3:10.1f} us; wall {r['wall_ms'] * 1e3:9.2f} us; "
                f"bound {r['bound_ms'] * 1e3:7.2f} us ({r['bound_by']}; the hashes' "
                f"{r['hash_bound_ms'] * 1e3:.2f}" + (f", the FP64 pipe's {r['fp64_ms'] * 1e3:.2f}"
                                                     if "fp64_ms" in r else "")
                + f"), {r['bound_ms'] / r['ms']:.2f} of it reached ({smi_line})")
        if parent:
            rows["threefry_parent"] = threefry_beside_parent(key, n, modes, parent, held)
            for name, t in rows["threefry_parent"].items():
                say(f"  threefry {name} beside the parent's ({parent}), the same draws; in "
                    f"turn, us a launch (CUDA events after a flush): " + "; ".join(
                        f"{who} " + ", ".join(f"{v * 1e3:.2f}" for v in vs)
                        for who, vs in t.items()) + f" ({smi_line})")
    # the draws of the HMC paths, at their shapes, each folded (one launch
    # under split(key)[1] that writes the split) beside the split and the
    # draw it replaces (two launches): the momenta (89 and 256 x 89
    # normals), the Metropolis and Gumbel uniforms (1, 256, 17)
    draws = {"normal 89": (tk.NORMAL64, N_COUNTIES + 4),
             "normal 256x89": (tk.NORMAL64, HMC_CHAINS * (N_COUNTIES + 4)),
             "uniform 1": (tk.UNIFORM64, 1), "uniform 17": (tk.UNIFORM64, HMC_STEPS + 1),
             "uniform 256": (tk.UNIFORM64, HMC_CHAINS)}
    fsplit, psplit = (torch.empty((2, 2), dtype=torch.int64, device=dev) for _ in range(2))
    for name, (mode, m) in draws.items():
        got, want = launch(key, m, mode, split=fsplit), tk.plain(key, m, mode, split=psplit)
        pair = launch(launch(key, 2, tk.KEYS)[1], m, mode)
        sync()
        same = [held(name, g, want)[0] for g in (got, pair)]
        if not (all(same) and torch.equal(fsplit, psplit)):
            raise AssertionError(f"threefry {name}: the folded draw {same[0]}, the split and "
                                 f"draw {same[1]}, the split {fsplit.tolist()} against "
                                 f"{psplit.tolist()}")
        if on_card:
            def two():
                tk.launch(tk.launch(key, 2, tk.KEYS)[1], m, mode)

            turns = {"folded": [], "pair": []}
            for who, fn in (("pair", two), ("folded", lambda: tk.launch(key, m, mode, split=fsplit)),
                            ("folded", lambda: tk.launch(key, m, mode, split=fsplit)),
                            ("pair", two)):
                turns[who].append(device_ms(fn, 200)[0])
            r = {"ms": float(np.mean(turns["folded"])), "pair_ms": float(np.mean(turns["pair"])),
                 "turns": turns,
                 "plain_ms": device_ms(lambda: tk.plain(key, m, mode, split=psplit), 20)[0],
                 "wall_ms": wall_ms(lambda: tk.launch(key, m, mode, split=fsplit), 200),
                 "pair_wall_ms": wall_ms(two, 200)}
            r["bound_ms"], r["bound_by"] = bound(nbytes(key, fsplit, got), m + 2, HASH_S)
            if mode == tk.NORMAL64:
                fp64 = normal64_fp64_ms(m)
                if fp64 > r["bound_ms"]:
                    r["bound_ms"], r["bound_by"] = fp64, "operations"
            within_bound(f"threefry folded {name}", r)
            rows["threefry"][f"folded {name}"] = r
            say(f"  threefry {name:16s} folded {r['ms'] * 1e3:7.2f} us a launch (device; "
                f"{', '.join(f'{v * 1e3:.2f}' for v in turns['folded'])}), the split and the "
                f"draw {r['pair_ms'] * 1e3:7.2f} us (two launches; "
                f"{', '.join(f'{v * 1e3:.2f}' for v in turns['pair'])}), in turn; wall "
                f"{r['wall_ms'] * 1e3:.2f} against {r['pair_wall_ms'] * 1e3:.2f} us; plain "
                f"{r['plain_ms'] * 1e3:.1f} us; bound {r['bound_ms'] * 1e3:.4f} us "
                f"({r['bound_by']}) ({smi_line})")

    # (b) the HMC paths -------------------------------------------------------------
    def zero_counts():
        fused_kernel.LAUNCHES = scan_kernel.LAUNCHES = tk.LAUNCHES = 0

    def counts():
        return {"fused_elemwise": fused_kernel.LAUNCHES, "scan_whole_loop": scan_kernel.LAUNCHES,
                "threefry": tk.LAUNCHES}

    # the CPU's first transitions, the reference of both of the card's runs
    ref = {}
    for path, (g, g_pos, *_) in cpu_fns.items():
        ref[path] = [[o.clone() for o in g()] + [g_pos.get_value()] for _ in range(HMC_HELD)]
    say(f"phase 18: the CPU's {HMC_HELD} transitions of each HMC path in "
        f"{time.perf_counter() - t18:.1f} s")
    launches, k1_abs, k1_nodes = {}, 0.0, 0
    for flags in ("default flags", "scan__pallas"):
        t0 = time.perf_counter()
        fns = hmc_functions(dev, pallas=flags == "scan__pallas")
        say(f"phase 18: the HMC functions linked for {dev} with {flags} in "
            f"{time.perf_counter() - t0:.1f} s")
        for path, (f, pos, *_) in fns.items():
            tag = f"{path}, {flags}"
            plan = getattr(f.linked, "plan", f.linked)
            if plan.host_reads:
                raise AssertionError(f"{tag}: host reads {plan.host_reads}")
            for step in range(HMC_HELD):
                out = [o.cpu() for o in f()] + [pos.get_value().cpu()]
                want = ref[path][step]
                if not torch.equal(out[1], want[1]):
                    raise AssertionError(f"{tag}, transition {step}: accept/index {out[1]} "
                                         f"against the CPU's {want[1]}")
                e_logp, e_pos = rel_err(out[0], want[0]), rel_err(out[2], want[2])
                if not (e_logp <= HMC_RTOL and e_pos <= HMC_RTOL):
                    raise AssertionError(f"{tag}, transition {step}: logp {e_logp}, position "
                                         f"{e_pos} from the CPU's (tol {HMC_RTOL})")
            if on_card and not (isinstance(f.linked, CapturedFunction)
                                and len(f.linked.graphs) == 1):
                raise AssertionError(f"{tag}: not one captured CUDA graph")
            # the main path, counted: one replayed call
            zero_counts()
            logp, acc = f()
            sync()
            launches[tag] = counts()
            # a transition draws the momenta and the Metropolis or Gumbel
            # uniforms, each one folded launch with its split
            if on_card and not (launches[tag]["fused_elemwise"] > 0
                                and launches[tag]["threefry"] == HMC_THREEFRY_LAUNCHES):
                raise AssertionError(f"{tag}: launches {launches[tag]}, threefry "
                                     f"{HMC_THREEFRY_LAUNCHES} a transition expected")
            if not (torch.isfinite(logp).all() and torch.isfinite(pos.get_value()).all()):
                raise AssertionError(f"{tag}: a value is not finite")
            scans = [nd for nd in f.fgraph.toposort() if isinstance(nd.op, Scan)]
            verdicts = []
            for nd in scans:
                ok = scan_kernel_eligible(nd.op, nd)
                unknown = [i for i in nd.inputs[1:] if any(d is None for d in i.type.shape)]
                why = ("takes it" if ok else "refuses it: the carried position "
                       f"{unknown[0]} has an unknown static shape {unknown[0].type.shape}"
                       if unknown else "refuses it")
                verdicts.append(f"{nd.op.name}: K2 {why}")
                if flags == "scan__pallas" and ok and launches[tag]["scan_whole_loop"] == 0:
                    raise AssertionError(f"{tag}: K2 takes {nd.op.name} and never launched")
            say(f"{tag}: launches in one replayed call (counts set to 0 just before it) "
                f"{launches[tag]}; {'; '.join(verdicts)}; the first {HMC_HELD} transitions "
                f"held against the CPU (accepts/indices equal, logp and position within "
                f"{HMC_RTOL:g})")
            row = {"launches": launches[tag], "k2": verdicts}
            if on_card:
                ms = wall_ms(f, 50)
                per = HMC_CHAINS if path == "hmc 256 chains" else 1
                row.update(ms=ms, transitions_s=per * 1e3 / ms)
                if flags == "default flags":
                    dev_ms, by = device_ms(f, 10)
                    row.update(device_ms=dev_ms, busy=dev_ms / ms,
                               kernels_a_call=sum(c for _, c in by.values()))
                    tfr = [(k_ms, c) for kn, (k_ms, c) in by.items() if "threefry" in kn]
                    row["threefry_device_us"] = sum(k for k, _ in tfr) * 1e3
                say(f"  {tag}: {ms:.3f} ms a transition (wall, CUDA events over 50 calls), "
                    f"{row['transitions_s']:,.0f} {'chain-' if per > 1 else ''}transitions/s"
                    + (f"; device {row['device_ms']:.3f} ms a call, busy {row['busy']:.2f}, "
                       f"{row['kernels_a_call']:.0f} kernels a call, threefry "
                       f"{row['threefry_device_us']:.1f} us of it" if "device_ms" in row else "")
                    + f" ({smi_line})")
            rows["hmc"][tag] = row
            if flags == "default flags":
                # each K1 node of a call, fed its real inputs
                args = [sv.storage[0] for sv in f.shared_vars]
                for _, nd, xs in plan_values(plan, args):
                    if not isinstance(nd.op, FusedElemwise):
                        continue
                    kern = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
                    got, want = (kern.launch if on_card else kern)(*xs), kern.plain(*xs)
                    sync()
                    for g, w in zip(got, want):
                        e_abs, e_rel = errors(g.cpu().double(), w.cpu().double())
                        k1_abs = max(k1_abs, e_abs)
                        if e_rel > K1_RTOL.get(str(w.dtype).removeprefix("torch."), 0.0):
                            raise AssertionError(f"K1 {tag} {nd.op}: {e_rel} from its plain "
                                                 f"version")
                    k1_nodes += 1
    say(f"phase 18: {k1_nodes} K1 nodes of the HMC calls fed their real inputs within "
        f"{k1_abs:.2e} of their plain versions (tol {K1_RTOL})")
    rows["threefry_abs"] = tf_abs
    say(f"random and HMC phase done in {time.perf_counter() - t18:.1f} s")
    return launches, k1_abs, rows


# --- phase 19: jax's loop samplers and the RBM Gibbs chain ------------------------

LOOP_N = 2 ** 20
# the loop kernels' float draws against their plain versions on the card:
# each multiply, add and divide is rounded alike and the math functions
# (erfinv, log, log1p, lgamma, pow) are the ones torch's CUDA ops call, so
# bit for bit (0 ulps)
LOOP_FLOAT_ULPS = 0
LOOP_KERNELS = ("gamma", "poisson", "binomial")
# the kernel-line name and library call of each loop kernel
LOOP_LIBRARY = {"gamma": "torch._standard_gamma", "poisson": "torch.poisson",
                "binomial": "torch.binomial"}


# two kernels alike but for threefry hashes: four under one key a thread
# (so that the key's schedule, which a kernel hashing many counters under
# one key computes once, is shared), and none; the hash's instructions are
# the difference of their SASS over four
HASH_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "threefry.cuh"
extern "C" __global__ void with_hashes(const uint2* __restrict__ in, uint2* __restrict__ out) {
  const uint2 k = in[0];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const uint2 x = in[1 + 4 * threadIdx.x + j];
    const TfKey h = tf_hash(TfKey{k.x, k.y}, ((unsigned long long)x.x << 32) | x.y);
    out[4 * threadIdx.x + j] = make_uint2(h.k0, h.k1);
  }
}
extern "C" __global__ void without_hashes(const uint2* __restrict__ in, uint2* __restrict__ out) {
#pragma unroll
  for (int j = 0; j < 4; ++j) out[4 * threadIdx.x + j] = in[1 + 4 * threadIdx.x + j];
}
"""
# the ALU pipe's integer instructions on sm_90; IMAD (with .MOV, .IADD,
# .SHL, .WIDE) runs on the FMA pipe
ALU_OPS = ("IADD3", "IADD", "LOP3", "LOP", "SHF", "SHL", "SHR", "LEA", "PRMT", "IABS",
           "IMNMX", "ISCADD", "SEL")


def hash_instructions():
    """One threefry hash's SASS instructions on sm_90a (``HASH_PROBE``,
    read by ``sass_ops``): ``{"alu", "fma", "all"}``,
    the ALU pipe's, IMAD's (the FMA pipe's) and all of them, NOPs and
    branches aside."""
    ops = {name: [o for o, _ in found] for name, found in
           sass_ops(HASH_PROBE, ("with_hashes", "without_hashes")).items()}

    def count(names):
        return {"alu": sum(o in ALU_OPS for o in names),
                "fma": sum(o == "IMAD" for o in names), "all": len(names)}

    w, wo = count(ops["with_hashes"]), count(ops["without_hashes"])
    got = {k: (w[k] - wo[k]) / 4 for k in w}
    if not (wo["all"] and got["alu"] > 0 and got["all"] >= got["alu"] + got["fma"]):
        raise AssertionError(f"the hash probe's SASS: {w} with the hashes, {wo} without")
    return got


# each piece of the gamma draw's float64 work (csrc/gamma.cu's functions) on
# inputs from memory: an element's d and c; an inner pass (the normal and
# v); an outer pass (X, V, U and the test's two logs); the draw from d and
# V; and a boosted draw's (its uniform and pow); gamma's draws as timed,
# not in log space
FP64_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "gamma.cu"
extern "C" __global__ void fp_setup(const double* __restrict__ in, double* __restrict__ out) {
  const int t = threadIdx.x;
  double d, c;
  gamma_setup(in[t], d, c);
  out[2 * t] = d;
  out[2 * t + 1] = c;
}
extern "C" __global__ void fp_inner(const uint2* __restrict__ bits, const double* __restrict__ in,
                                    double* __restrict__ out) {
  const int t = threadIdx.x;
  const double x = normal64(bits[t].x, bits[t].y);
  out[2 * t] = x;
  out[2 * t + 1] = __dadd_rn(1.0, __dmul_rn(x, in[t]));
}
extern "C" __global__ void fp_outer(const uint2* __restrict__ bits, const double* __restrict__ in,
                                    double* __restrict__ out) {
  const int t = threadIdx.x;
  const double x = in[3 * t], v = in[3 * t + 1];
  const double X = __dmul_rn(x, x), V = __dmul_rn(__dmul_rn(v, v), v);
  const double U = uniform64(bits[t].x, bits[t].y, 0.0, 1.0);
  out[2 * t] = V;
  out[2 * t + 1] = gamma_test(X, V, U, in[3 * t + 2]) ? 1.0 : 0.0;
}
extern "C" __global__ void fp_draw(const double* __restrict__ in, double* __restrict__ out) {
  const int t = threadIdx.x;
  out[t] = gamma_boost(gamma_base(in[3 * t + 1], in[3 * t + 2], 0), in[3 * t], 0.0, false, 0);
}
extern "C" __global__ void fp_boosted(const uint2* __restrict__ bits,
                                      const double* __restrict__ in, double* __restrict__ out) {
  const int t = threadIdx.x;
  const double u = uniform64(bits[t].x, bits[t].y, 0.0, 1.0);
  out[t] = gamma_boost(gamma_base(in[3 * t + 1], in[3 * t + 2], 0), in[3 * t], u, true, 0);
}
"""
# the FP64 pipe's instructions on sm_90 (and MUFU's double reciprocal and
# square root seeds, counted with them); an SM runs 64 FP64 lanes a clock
FP64_OPS = ("DFMA", "DMUL", "DADD", "DSETP", "DMNMX", "DSET")
FP64_LANES = 64
# the FP64-pipe instructions of each piece of FP64_PROBE on the card
# (``fp64_instructions``), set by say_builds
GAMMA_FP64: dict = {}


def sass_code(source):
    """Each function's SASS on sm_90a (``source`` built by nvcc with
    ``csrc/`` on the include path, read by ``cuobjdump -sass``,
    ``sass_of``)."""
    import tempfile

    from pytensor_tpu_torch.link.cuda.build import BUILD_DIR, CSRC, nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        src, cubin = Path(tmp, "probe.cu"), Path(tmp, "probe.cubin")
        src.write_text(source)
        subprocess.run([nvcc(), "-cubin", "-gencode", "arch=compute_90a,code=sm_90a",
                        "-std=c++17", "-O3", f"-I{CSRC}", "-o", str(cubin), str(src)],
                       capture_output=True, text=True, check=True)
        return sass_of(cubin)


def sass_of(binary):
    """Each function's SASS in ``binary`` (a cubin, or a library that nvcc
    built, read by ``cuobjdump -sass``): {name: [(address, predicated,
    opcode, modifiers, target)]}, ``target`` the address a branch goes to
    (None for the others)."""
    import shutil

    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return parse_sass(subprocess.run([tool, "-sass", str(binary)], capture_output=True,
                                     text=True, check=True).stdout)


def parse_sass(sass):
    """``sass_of``'s reading of cuobjdump's text."""
    code: dict = {}
    body, labels = None, {}
    for line in sass.splitlines():
        if "Function :" in line:
            body = code.setdefault(line.split("Function :")[1].strip(), [])
            continue
        label = re.match(r"\s*(\.L_x_\d+):", line)
        if label and body is not None:
            labels[(id(body), label.group(1))] = len(body)
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)((?:\.[A-Z0-9_]+)*)"
                      r"([^;]*)", line)
        if body is None or not m:
            continue
        target = None
        if m.group(3) == "BRA":
            t = re.search(r"(0x[0-9a-f]+|\.L_x_\d+)", m.group(5))
            target = t.group(1) if t else None
        body.append([int(m.group(1), 16), bool(m.group(2)), m.group(3), m.group(4), target])
    for name, body in code.items():
        at = {ins[0]: ins[0] for ins in body}
        for ins in body:
            t = ins[4]
            if t is not None:
                ins[4] = (int(t, 16) if t.startswith("0x") else
                          body[labels[(id(body), t)]][0] if (id(body), t) in labels else None)
                ins[4] = at.get(ins[4])
        code[name] = [tuple(ins) for ins in body]
    return code


def sass_ops(source, names):
    """Each of ``names``' SASS instructions (``sass_code``): {name:
    [(opcode, modifiers)]}, NOPs, branches and exits aside."""
    code = sass_code(source)
    return {name: [(op, mods) for _, _, op, mods, _ in code.get(name, [])
                   if op not in ("NOP", "BRA", "EXIT")] for name in names}


def sass_least(code, weight, start=0, stop=None, through=()):
    """The least total ``weight`` of the instructions on a path through
    ``code`` (one function's ``sass_code``) from instruction ``start`` to an
    EXIT or, given ``stop``, to instruction ``stop``, by way of each of the
    instructions ``through`` in turn, taking only forward branches: every
    run of that stretch that passes those instructions executes at least as
    much (a predicated instruction issues either way)."""
    n, inf = len(code), float("inf")
    index = {ins[0]: i for i, ins in enumerate(code)}

    def between(a, b):
        best = [inf] * (n + 1)
        for i in range(n - 1, a - 1, -1):
            _, pred, op, mods, target = code[i]
            w = weight(op, mods)
            if i == b:
                best[i] = w
                continue
            if op == "EXIT":
                best[i] = w if b is None else (w + best[i + 1] if pred else inf)
                continue
            nxt = [i + 1] if (op != "BRA" or pred) else []
            t = index.get(target, -1) if op == "BRA" else -1
            if t > i:
                nxt.append(t)
            best[i] = w + min((best[j] for j in nxt), default=inf)
        return best[a]

    points = [start, *through, stop]
    return sum(between(a, b) for a, b in zip(points, points[1:])) - sum(
        weight(*code[k][2:4]) for k in through)


def is_alu(op, mods):
    return op in ALU_OPS


def is_fma(op, mods):
    return op == "IMAD"


def is_fp64(op, mods):
    return op in FP64_OPS or (op == "MUFU" and "64H" in mods)


def is_issued(op, mods):
    return op not in ("NOP", "BRA", "EXIT")


PIPES = {"alu": is_alu, "fma": is_fma, "fp64": is_fp64, "all": is_issued}
THREEFRY_MODES = ("bits32", "bits64", "keys", "uniform64", "normal64", "uniform32")


def threefry_instructions(lib):
    """The threefry kernel's SASS a draw, by pipe, in each mode (``lib``, a
    build of ``csrc/threefry.cu``), of the kernel that a draw of 2**24
    takes (the most counters a thread): the least count on a path through
    the grid-stride loop's body (the store that a whole aligned vector
    takes; for the normals, by way of each erfinv's log, ``erfinv_logs``),
    over the counters a thread takes there.  {mode: {"alu", "fma",
    "fp64", "all", "fp64_static", "per"}}, "fp64_static" the body's FP64-pipe instructions on every branch, as
    ``fp64_instructions`` counts gamma's."""
    code = sass_of(lib._name)
    got = {}
    for name, body in code.items():
        m = re.search(r"threefry_kernelILi(\d)ELi(\d)E", name)
        if not m:
            continue
        mode, per = THREEFRY_MODES[int(m.group(1))], int(m.group(2))
        if got.get(mode, {}).get("per", 0) > per:
            continue
        # the grid-stride loop: the outermost backward branch
        back = [(ins[4], i) for i, ins in enumerate(body) if ins[2] == "BRA"
                and ins[4] is not None and ins[4] < ins[0]]
        if not back:
            raise AssertionError(f"threefry {mode}: no loop in its SASS")
        target, stop = min(back)
        start = next(i for i, ins in enumerate(body) if ins[0] == target)
        through = erfinv_logs(body[:stop + 1], start)
        got[mode] = {pipe: sass_least(body, w, start, stop, through) / per
                     for pipe, w in PIPES.items()}
        got[mode]["fp64_static"] = sum(is_fp64(op, mods) for _, _, op, mods, _ in
                                       body[start:stop + 1]) / per
        got[mode]["per"] = per
    return {mode: got[mode] for mode in THREEFRY_MODES}


# a normal64 draw from bits in memory
NORMAL_PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
#include "threefry.cuh"
extern "C" __global__ void normal_draw(const uint2* __restrict__ bits, double* __restrict__ out) {
  const int t = threadIdx.x;
  out[t] = normal64(bits[t].x, bits[t].y);
}
"""


def erfinv_logs(code, start=0):
    """The instructions of ``code`` from ``start`` on that every draw of a
    normal passes: CUDA's double erfinv(u) takes a branch of a few
    instructions only where |u| >= 1, which no uniform of the draw on
    [nextafter(-1, 0), 1) is, and every other u first computes log(1 -
    u^2), whose reciprocal seed is the branch's first MUFU.RCP64H."""
    return [i for i in range(start, len(code)) if code[i][2] == "MUFU" and "RCP64H" in code[i][3]]


def normal_instructions():
    """normal64's FP64-pipe instructions a draw (``NORMAL_PROBE``):
    {"least": on the shortest path of a draw, by way of erfinv's log
    (``erfinv_logs``), "static": on every branch}."""
    code = next(v for k, v in sass_code(NORMAL_PROBE).items() if k.endswith("normal_draw"))
    logs = erfinv_logs(code)
    if len(logs) != 1:
        raise AssertionError(f"the normal probe's SASS: {len(logs)} logs of erfinv")
    return {"least": sass_least(code, is_fp64, through=logs),
            "static": sum(is_fp64(op, mods) for _, _, op, mods, _ in code)}


def normal64_fp64_ms(n):
    """The FP64 pipe's least time for ``n`` normals: ``NORMAL_FP64["least"]``
    instructions a draw at ``FP64_LANES`` lanes an SM a clock."""
    return n * NORMAL_FP64["least"] / (SM_CLOCKS_S * FP64_LANES) * 1e3


def fp64_instructions():
    """The FP64-pipe instructions of each piece of gamma's float64 work
    (``FP64_PROBE``'s kernels): {"setup", "inner", "outer", "draw",
    "boosted"}, "boosted" over "draw".  Static counts: they hold every
    branch of CUDA's erfinv, log and pow, also those a draw does not take,
    so the time priced from them can be more than the FP64 pipe needs
    (phase 19 prints it beside the hashes' bound)."""
    names = ("fp_setup", "fp_inner", "fp_outer", "fp_draw", "fp_boosted")
    ops = sass_ops(FP64_PROBE, names)
    got = {name[3:]: sum(is_fp64(o, m) for o, m in ops[name]) for name in names}
    got["boosted"] -= got["draw"]
    if min(got["setup"], got["inner"], got["outer"], got["boosted"]) <= 0:
        raise AssertionError(f"the FP64 probe's SASS: {got}")
    return got


def gamma_fp64_ms(n, passes):
    """The least time of gamma's FP64 pipe for a draw of ``n`` elements
    with the plain loops' ``passes`` (outer, inner, boosted): its pieces'
    instructions (``GAMMA_FP64``) at ``FP64_LANES`` lanes an SM a clock."""
    f = GAMMA_FP64
    instructions = (n * (f["setup"] + f["draw"]) + passes["outer"] * f["outer"]
                    + passes["inner"] * f["inner"] + passes["boosted"] * f["boosted"])
    return instructions / (SM_CLOCKS_S * FP64_LANES) * 1e3, instructions


def gamma_fmad_false():
    """``csrc/gamma.cu`` built with ``-fmad=false``, as ``poisson.cu`` and
    ``binomial.cu`` are (``gamma_kernel.FLAGS`` keeps nvcc's default
    contraction; phase 19 prints why)."""
    from pytensor_tpu_torch.link.cuda import gamma_kernel
    from pytensor_tpu_torch.link.cuda.build import build_csrc

    return gamma_kernel.bind(build_csrc("gamma", gamma_kernel.HEADERS, False,
                                        ("-fmad=false",))[0])


class plain_loops:
    """Within it, the loop samplers' wrappers take their plain versions on
    the card too (the kernels' reference; no launch is counted)."""

    def __enter__(self):
        from pytensor_tpu_torch.link.cuda import binomial_kernel, gamma_kernel, poisson_kernel

        self.saved = [(m, m.draw) for m in (gamma_kernel, poisson_kernel, binomial_kernel)]
        for m, _ in self.saved:
            m.draw = m.plain

    def __exit__(self, *exc):
        for m, draw in self.saved:
            m.draw = draw


def loop_rv(name):
    """The RandomVariable of sampler ``name`` (gamma's takes the scale)."""
    from pytensor_tpu_torch.tensor.random import basic

    return basic._gamma if name == "gamma" else getattr(basic, name)


def float_ulps(got, want):
    """(elements that differ, their largest ulp distance), NaNs equal."""
    import torch

    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    it = torch.int32 if got.dtype == torch.float32 else torch.int64
    dist = (got.view(it).long() - want.view(it).long()).abs()
    return int((~same).sum()), int(torch.where(same, 0, dist).max()) if got.numel() else 0


def loop_held(tag, got, want):
    """Integers bit for bit; floats within ``LOOP_FLOAT_ULPS``.  Returns
    (draws that differ, their largest ulp distance, their largest absolute
    difference), NaNs equal."""
    import torch

    if not got.is_floating_point():
        if not torch.equal(got, want):
            raise AssertionError(f"{tag}: {int((got != want).sum())} draws differ from the "
                                 f"plain version's")
        return 0, 0, 0.0
    n_diff, ulps = float_ulps(got, want)
    if ulps > LOOP_FLOAT_ULPS:
        raise AssertionError(f"{tag}: {n_diff} draws differ from the plain version's, by up to "
                             f"{ulps} ulps (allowed {LOOP_FLOAT_ULPS})")
    same = (got == want) | (torch.isnan(got) & torch.isnan(want))
    diff = torch.where(same, 0.0, (got.double() - want.double()).abs())
    return n_diff, ulps, float(diff.max()) if got.numel() else 0.0


def loop_typical(kernel, dev, n):
    """The timing inputs of a loop kernel (``cases.LOOP_TYPICAL`` tiled to
    ``n``), as its wrapper takes them."""
    import torch

    from pytensor_tpu_torch.link.cuda.cases import LOOP_TYPICAL

    vals = LOOP_TYPICAL[kernel]
    if kernel == "binomial":
        count = np.resize(np.array([c for c, _ in vals], "float32"), n)
        prob = np.resize(np.array([q for _, q in vals], "float32"), n)
        return [torch.from_numpy(count).to(dev), torch.from_numpy(prob).to(dev)]
    dtype = "float64" if kernel == "gamma" else "float32"
    return [torch.from_numpy(np.resize(np.array(vals, dtype), n)).to(dev)]


def loop_times(kernel, args, dev, n_iter):
    """A loop kernel's device and wall ms on ``args``, folded as a random
    variable draws (the split of the key made in the same launch, held
    against the plain split and loops), beside its plain version's and
    torch's sampler of the same distribution (other bits), the threefry
    hashes the draw needs (its plain version's tally and the split's two),
    and its bound (inputs read and outputs written once; the hashes at
    ``HASH_S``)."""
    import torch

    from pytensor_tpu_torch.link.cuda import binomial_kernel, gamma_kernel, poisson_kernel

    mod = {"gamma": gamma_kernel, "poisson": poisson_kernel, "binomial": binomial_kernel}[kernel]
    key = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64, device=dev)
    # the binomial random variables' int64 draws
    extra = (torch.int64,) if kernel == "binomial" else ()
    library = {"gamma": lambda: torch._standard_gamma(args[0]),
               "poisson": lambda: torch.poisson(args[0]),
               "binomial": lambda: torch.binomial(args[0], args[1])}[kernel]
    # the draw as a random variable makes it: under split(key)[1], the
    # launch writing the split (two hashes more)
    fsplit, psplit = (torch.empty((2, 2), dtype=torch.int64, device=dev) for _ in range(2))
    out = mod.launch(key, *args, *extra, split=fsplit)
    tally: list = [2]
    passes: dict = {}
    want = mod.plain(key, *args, *extra, tally=tally, split=psplit,
                     **({"passes": passes} if kernel == "gamma" else {}))
    loop_held(f"{kernel} folded at {args[0].numel():,} draws", out, want)
    if not torch.equal(fsplit, psplit):
        raise AssertionError(f"{kernel}: the folded launch's split {fsplit.tolist()}, the plain "
                             f"one {psplit.tolist()}")
    n_hash = int(sum(tally))
    row = {"n": args[0].numel(), "hashes": n_hash,
           "ms": device_ms(lambda: mod.launch(key, *args, *extra, split=fsplit), n_iter)[0],
           "wall_ms": wall_ms(lambda: mod.launch(key, *args, *extra, split=fsplit), n_iter),
           "plain_ms": device_ms(lambda: mod.plain(key, *args, *extra, split=psplit), 2)[0],
           "plain_wall_ms": wall_ms(lambda: mod.plain(key, *args, *extra, split=psplit), 2),
           "library_ms": device_ms(library, n_iter)[0], "library": LOOP_LIBRARY[kernel] +
           " (same distribution, other bits)"}
    row["bound_ms"], row["bound_by"] = bound(nbytes(*args, out, fsplit), n_hash, HASH_S)
    row["bound_pipe"] = "hashes" if row["bound_by"] == "operations" else "bytes"
    if kernel == "gamma":
        # the larger of the hash bound and the FP64 pipe's
        row["passes"] = passes
        row["hash_bound_ms"] = row["bound_ms"]
        row["fp64_ms"], row["fp64_instructions"] = gamma_fp64_ms(row["n"], passes)
        if row["fp64_ms"] > row["bound_ms"]:
            row["bound_ms"], row["bound_by"], row["bound_pipe"] = (row["fp64_ms"], "operations",
                                                                   "FP64 pipe")
    within_bound(f"{kernel} at {row['n']:,} draws", row)
    return row


def parent_interface(src, entry):
    """The C interface of ``entry`` (``poisson_draw`` or ``binomial_draw``)
    in the source ``src`` of a parent tree: "two passes" (the loop
    kernels' first tree: a scratch of n + 1 int32 and a pass mask, 3 for
    both passes) or "one launch" (later trees': a state of int32 words and
    no mask; this tree's also takes a ``split``, which ``parent_loops``
    passes null).  Raises for any other."""
    names = c_params(src, entry)
    if names[-3:] == ["first", "passes", "stream"]:
        return "two passes"
    if names[-2:] == ["state", "stream"]:
        return "one launch"
    raise SystemExit(f"--parent: {entry}({', '.join(names)}) is neither the two-pass C entry of "
                     f"the loop kernels' first tree nor this tree's one-launch entry")


def parent_loops(root):
    """The Poisson and binomial draws as built from the tree at ``root``
    (its ``csrc/poisson.cu`` and ``csrc/binomial.cu`` with their own
    headers, as ``link/cuda`` builds them, called through the C interface
    that ``parent_interface`` reads from the source):
    ``{kernel: draw(key, *args)}``, each draw returning int64.  Its
    launches are not counted."""
    import torch

    from pytensor_tpu_torch.link.cuda import binomial_kernel, poisson_kernel
    from pytensor_tpu_torch.link.cuda.build import build_library

    draws = {}
    for kernel, mod in (("poisson", poisson_kernel), ("binomial", binomial_kernel)):
        src = Path(root, "pytensor_tpu_torch", "csrc", f"{kernel}.cu")
        text = src.read_text()
        two_passes = parent_interface(text, f"{kernel}_draw") == "two passes"
        # a null split where the entry takes one
        fold = [None] if "split" in c_params(text, f"{kernel}_draw") else []
        lib, _ = build_library(text, f"{kernel}_parent", src, False, mod.FLAGS)
        p = ctypes.c_void_p
        # the pass mask before the stream in the two-pass entry
        mask = [ctypes.c_int] if two_passes else []
        split = [p for _ in fold]
        entry = getattr(lib, f"{kernel}_draw")
        entry.argtypes = ([p, *split, p, ctypes.c_longlong, p, p, *mask, p]
                          if kernel == "poisson" else
                          [p, *split, p, p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int, p, p,
                           *mask, p])
        entry.restype = ctypes.c_int

        def draw(key, *args, lib=lib, kernel=kernel, two_passes=two_passes, fold=fold):
            n = args[0].numel()
            out = torch.empty(n, dtype=torch.int64, device=key.device)
            # the two-pass scratch (each element's first accept, then N),
            # or the state words (64: more than either tree uses)
            scratch = torch.empty(n + 1 if two_passes else 64, dtype=torch.int32,
                                  device=key.device)
            tail = ([3] if two_passes else []) + [torch.cuda.current_stream(key.device).cuda_stream]
            if kernel == "poisson":
                err = lib.poisson_draw(key.data_ptr(), *fold, args[0].data_ptr(), n,
                                       out.data_ptr(), scratch.data_ptr(), *tail)
            else:
                err = lib.binomial_draw(key.data_ptr(), *fold, args[0].data_ptr(),
                                        args[1].data_ptr(), n,
                                        int(args[1].dtype == torch.float64), 2, out.data_ptr(),
                                        scratch.data_ptr(), *tail)
            if err != 0:
                raise RuntimeError(f"the parent's {kernel} launch failed: CUDA error {err}")
            return out

        draws[kernel] = draw
    return draws


def loop_beside_parent(kernel, args, dev, parent):
    """This tree's draw as a random variable makes it (folded: under
    ``split(key)[1]``, the split made in the same launch) against the
    parent's under ``split(key)[1]`` (the same bits required), and the two
    timed in turn, three times: {"this": [ms, ...], "parent": [ms, ...]}
    (device ms a draw, memsets included)."""
    import torch

    from pytensor_tpu_torch.link.cuda import binomial_kernel, poisson_kernel
    from pytensor_tpu_torch.tensor.random.threefry import split as tf_split

    mod = poisson_kernel if kernel == "poisson" else binomial_kernel
    key = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64, device=dev)
    extra = (torch.int64,) if kernel == "binomial" else ()
    split = torch.empty((2, 2), dtype=torch.int64, device=dev)
    sub = tf_split(key)[1].contiguous()
    this = lambda: mod.launch(key, *args, *extra, split=split)  # noqa: E731
    theirs = lambda: parent[kernel](sub, *args)  # noqa: E731
    if not torch.equal(this(), theirs()):
        raise AssertionError(f"{kernel}: the parent's draws differ from this tree's")
    turns = {"this": [], "parent": []}
    for _ in range(3):
        for who, fn in (("this", this), ("parent", theirs)):
            turns[who].append(device_ms(fn, 20)[0])
    return turns


GAMMA_PARAMS = ["key", "alpha", "n", "log_space", "out", "stream"]


def parent_gamma(root):
    """The gamma draw as built from the tree at ``root`` (its
    ``csrc/gamma.cu`` with its own headers, the kernel's flags; the C
    entry ``gamma_draw(key, alpha, n, log_space, out, stream)``, with a
    ``split`` after the key in this tree's, passed null; ``main`` checks it
    at the start): ``draw(key, alpha, log_space)``.  Its launches are not
    counted."""
    import torch

    from pytensor_tpu_torch.link.cuda import gamma_kernel
    from pytensor_tpu_torch.link.cuda.build import build_library

    src = Path(root, "pytensor_tpu_torch", "csrc", "gamma.cu")
    fold = [None] if "split" in c_params(src.read_text(), "gamma_draw") else []
    lib = build_library(src.read_text(), "gamma_parent", src, False, gamma_kernel.FLAGS)[0]
    p = ctypes.c_void_p
    lib.gamma_draw.argtypes = [p, *[p for _ in fold], p, ctypes.c_longlong, ctypes.c_int, p, p]
    lib.gamma_draw.restype = ctypes.c_int

    def draw(key, alpha, log_space=False):
        out = torch.empty_like(alpha)
        if lib.gamma_draw(key.data_ptr(), *fold, alpha.data_ptr(), alpha.numel(),
                          int(log_space), out.data_ptr(),
                          torch.cuda.current_stream(key.device).cuda_stream):
            raise RuntimeError("the parent's gamma launch failed")
        return out

    return draw


def gamma_beside_parent(alpha, dev, theirs):
    """This tree's gamma draws of ``alpha`` against the parent's in both
    ``log_space`` modes (the same bits, NaNs equal, required) and the two
    gamma draws timed in turn, twice: {"this": [ms, ms], "parent": [ms,
    ms]} (device ms a draw)."""
    import torch

    from pytensor_tpu_torch.link.cuda import gamma_kernel

    key = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64, device=dev)
    for log_space in (False, True):
        n_diff, _ = float_ulps(gamma_kernel.launch(key, alpha, log_space),
                               theirs(key, alpha, log_space))
        if n_diff:
            raise AssertionError(f"gamma (log_space {log_space}): the parent's draws differ from "
                                 f"this tree's at {n_diff} elements")
    turns = {"this": [], "parent": []}
    for _ in range(2):
        for who, fn in (("this", lambda: gamma_kernel.launch(key, alpha)),
                        ("parent", lambda: theirs(key, alpha))):
            turns[who].append(device_ms(fn, 20)[0])
    return turns


def loop_capture_holds(dev):
    """Each kernel's draw (one cooperative launch) captured into a CUDA
    graph and replayed gives the eager draw's bits, at ``LOOP_N`` on its
    timed grid and on the Gibbs chain's binomial(1, p)."""
    import torch

    from pytensor_tpu_torch.link.cuda import binomial_kernel, poisson_kernel

    key = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64, device=dev)
    lam = loop_typical("poisson", dev, LOOP_N)
    count_prob = loop_typical("binomial", dev, LOOP_N)
    gibbs_p = torch.linspace(0.01, 0.99, 15680, device=dev)
    ones = torch.ones_like(gibbs_p)
    cases = {"poisson 2e20": lambda: poisson_kernel.launch(key, *lam),
             "binomial 2e20": lambda: binomial_kernel.launch(key, *count_prob, torch.int64),
             "binomial(1, p)": lambda: binomial_kernel.launch(key, ones, gibbs_p, torch.int64)}
    for tag, fn in cases.items():
        eager = fn()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                replayed = fn()
        torch.cuda.current_stream().wait_stream(stream)
        for _ in range(2):
            graph.replay()
            torch.cuda.synchronize()
            if not torch.equal(replayed, eager):
                raise AssertionError(f"{tag}: a replayed capture of the draw gives other bits")
    return list(cases)


# the stamped variant's slots (csrc/loops.cuh): cycles, then counts
LOOP_CYCLE_SLOTS = ("chain", "dummy", "own loop", "rejection", "rest")
LOOP_COUNT_SLOTS = ("dummy passes", "own passes", "rejection passes", "hashes", "chain hashes")


def loop_stamped(mod):
    """The stamped variant of a loop kernel (its source built with
    ``-DLOOP_STAMPS``; csrc/loops.cuh), bound as the kernel is: (seconds,
    library, build log)."""
    from pytensor_tpu_torch.link.cuda.build import build_csrc

    t0 = time.perf_counter()
    lib, log = build_csrc(mod.SOURCE.stem, mod.HEADERS, True, (*mod.FLAGS, "-DLOOP_STAMPS"))
    mod.bind(lib)
    lib.loop_stamps_at.argtypes = [ctypes.c_void_p]
    lib.loop_stamps_at.restype = ctypes.c_int
    return time.perf_counter() - t0, lib, log


def kernel_ms(name, fn, n_iter):
    """The device ms a call of the kernels whose names hold ``name`` (the
    whole call's from CUDA events where the trace held no kernel at all);
    raises where the trace holds kernels but none of that name."""
    total, by = device_ms(fn, n_iter)
    if not by:
        return total
    if not any(name in kn for kn in by):
        raise AssertionError(f"torch.profiler traced no kernel named {name!r}: {sorted(by)}")
    return sum(ms for kn, (ms, _) in by.items() if name in kn)


def stamp_report(r, cycles, counts, lanes):
    """The split of a stamped launch from its threads' rows ``r`` (one a
    thread, ``LOOP_SLOTS`` columns): ``cycles`` and ``counts`` name the
    columns of each kind, one of the cycles "rest" (loads, stores, waiting);
    ``lanes`` the counts of passes whose active lanes are reported (a
    warp's lanes' passes against 32 times its largest lane's).  "warps": a
    slot as long as a warp's slowest lane there, the rest waiting."""
    names = list(cycles)
    cyc = r[:, list(cycles.values())]
    total = cyc.sum()
    wcyc = cyc.reshape(-1, 32, cyc.shape[1])
    elapsed = wcyc.sum(axis=2).max(axis=1)
    warp_share = {}
    if elapsed.sum():
        warp_share = {c: float(wcyc[:, :, j].max(axis=1).sum() / elapsed.sum())
                      for j, c in enumerate(names) if c != "rest"}
        warp_share["rest"] = 1.0 - sum(warp_share.values())
    active = {}
    for c in lanes:
        w = r[:, counts[c]].reshape(-1, 32)
        if w.max(axis=1).sum():
            active[c] = float(w.sum() / (32 * w.max(axis=1).sum()))
    return {"share": {c: float(cyc[:, j].sum() / total) if total else 0.0
                      for j, c in enumerate(names)},
            "warp_share": warp_share,
            "slowest_thread_us": float(cyc.sum(axis=1).max() / (SM_CLOCKS_S / 132) * 1e6),
            "active_lanes": active, "counts": {c: int(r[:, j].sum()) for c, j in counts.items()}}


def stamp_rows(n, dev, lib):
    """A zeroed buffer of stamped rows for a launch on ``n`` elements, set
    as the stamped library's target."""
    import torch

    buf = torch.zeros((-(-n // 256) * 256 + 1024, len(LOOP_CYCLE_SLOTS) + len(LOOP_COUNT_SLOTS)),
                      dtype=torch.int64, device=dev)
    if lib.loop_stamps_at(buf.data_ptr()) != 0:
        raise AssertionError("loop_stamps_at failed")
    return buf


def loop_split(kernel, args, dev, lib, needed):
    """The split of a Poisson or binomial draw on ``args`` (one launch) by
    its stamped variant ``lib``: the launch's device time (unstamped, and
    stamped), the share of the threads' cycles by slot, the slowest
    thread's cycles at the SM clock, each loop's passes by warp (largest
    lane against the mean: the active lanes), and the hashes the threads
    made against ``needed`` (the plain version's tally)."""
    import torch

    from pytensor_tpu_torch.link.cuda import binomial_kernel, loop_state, poisson_kernel

    mod = poisson_kernel if kernel == "poisson" else binomial_kernel
    key = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64, device=dev)
    n = args[0].numel()
    out = torch.empty(n, dtype=torch.int64, device=dev)
    state = torch.empty(loop_state.STATE_WORDS, dtype=torch.int32, device=dev)
    buf = stamp_rows(n, dev, lib)
    mod.run(key, *args, out, state, lib=lib)
    r = buf.cpu().numpy().astype("float64")
    # the stamped launches timed below stamp into a buffer of their own
    sink = stamp_rows(n, dev, lib)
    want = mod.launch(key, *args, torch.int64) if kernel == "binomial" else mod.launch(key, *args)
    if not torch.equal(out, want):
        raise AssertionError(f"{kernel}: the stamped variant's draws differ from the kernel's")
    plain_ms = kernel_ms(kernel, lambda: mod.run(key, *args, out, state), 50)
    stamped_ms = kernel_ms(kernel, lambda: mod.run(key, *args, out, state, lib=lib), 10)
    nc = len(LOOP_CYCLE_SLOTS)
    report = stamp_report(r, {c: j for j, c in enumerate(LOOP_CYCLE_SLOTS)},
                          {c: nc + j for j, c in enumerate(LOOP_COUNT_SLOTS)}, LOOP_COUNT_SLOTS[:3])
    del sink
    return {"one launch": {"ms": plain_ms, "stamped_ms": stamped_ms, **report, "needed": needed}}


# the gamma kernel's stamped slots (csrc/gamma.cu G_*): cycles, then counts
GAMMA_CYCLE_SLOTS = ("key setup", "outer hashes", "inner hashes, erfinv", "test logs", "rest",
                     "tail")
GAMMA_COUNT_SLOTS = ("outer passes", "inner passes", "boosted", "hashes")
# the gamma kernel's designs: the first, one element a thread (the stamped
# variant's gamma_serial_draw), and the kernel's
GAMMA_ENTRIES = {"serial": "gamma_serial_draw", "kernel": "gamma_draw"}


def gamma_split(alpha, dev, lib, needed, design):
    """The split of a gamma draw of ``alpha`` by the stamped variant
    ``lib``, for ``design`` (``GAMMA_ENTRIES``): as ``loop_split``, the
    active lanes of each kind of pass and of the boosted draws' tail.  The
    draw must be the kernel's, bit for bit; "ms" is the unstamped kernel's
    (its own design only)."""
    import torch

    from pytensor_tpu_torch.link.cuda import gamma_kernel

    key = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64, device=dev)
    out = torch.empty_like(alpha)
    entry = GAMMA_ENTRIES[design]
    buf = stamp_rows(alpha.numel(), dev, lib)
    gamma_kernel.run(key, alpha, out, lib=lib, entry=entry)
    r = buf.cpu().numpy().astype("float64")
    sink = stamp_rows(alpha.numel(), dev, lib)
    n_diff, _ = float_ulps(out, gamma_kernel.launch(key, alpha))
    if n_diff:
        raise AssertionError(f"gamma {design}: the stamped variant's draws differ from the "
                             f"kernel's at {n_diff} elements")
    nc = len(GAMMA_CYCLE_SLOTS)
    report = stamp_report(r, {c: j for j, c in enumerate(GAMMA_CYCLE_SLOTS)},
                          {c: nc + j for j, c in enumerate(GAMMA_COUNT_SLOTS)},
                          GAMMA_COUNT_SLOTS[:3])
    ms = (kernel_ms("gamma", lambda: gamma_kernel.run(key, alpha, out), 50)
          if design == "kernel" else None)
    stamped_ms = kernel_ms("gamma", lambda: gamma_kernel.run(key, alpha, out, lib=lib,
                                                              entry=entry), 10)
    del sink
    return {design: {"ms": ms, "stamped_ms": stamped_ms, **report, "needed": needed}}


def say_split(tag, report, smi_line):
    for name, r in report.items():
        say(f"  split of {tag} {name}: device "
            + (f"{r['ms'] * 1e3:.2f} us" if r["ms"] is not None else "not timed unstamped")
            + f" (stamped {r['stamped_ms'] * 1e3:.2f}); threads' cycles " + ", ".join(
                f"{c} {v:.3f}" for c, v in r["share"].items())
            + "; warps' cycles (a slot as long as its slowest lane) " + ", ".join(
                f"{c} {v:.3f}" for c, v in r["warp_share"].items())
            + f"; slowest thread {r['slowest_thread_us']:.2f} us at 1.98 GHz; active lanes "
            + (", ".join(f"{c} {v:.2f}" for c, v in r["active_lanes"].items()) or "none")
            + "; " + ", ".join(f"{c} {v:,}" for c, v in r["counts"].items())
            + f" made, against {r['needed']:,} hashes the draw needs ({smi_line})")


def gibbs_probe(W, bh, bv, v0, dev):
    """One Gibbs step from ``v0`` on ``dev`` with the chain's stream seed:
    the hidden means and sample, the visible means and sample."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.tensor.math import dot, sigmoid
    from pytensor_tpu_torch.tensor.random import RandomStream

    Ws = ptt.shared(W, device=dev)
    bhs, bvs = ptt.shared(bh, device=dev), ptt.shared(bv, device=dev)
    v = pt.matrix(dtype="float32")
    trng = RandomStream(99, device=dev)
    hmean = sigmoid(dot(v, Ws) + bhs)
    hsample = pt.cast(trng.binomial(1, hmean, size=hmean.shape), dtype="float32")
    vmean = sigmoid(dot(hsample, Ws.T) + bvs)
    vsample = pt.cast(trng.binomial(1, vmean, size=vmean.shape), dtype="float32")
    f = ptt.function([v], [hmean, hsample, vmean, vsample], device=dev)
    return [o.cpu() for o in f(v0)]


def phase_loops(dev, smi_line, stamped=None, parent=None):
    """Phase 19: jax's loop samplers and the RBM Gibbs chain.  (a) Each of
    the twelve samplers at ``LOOP_N`` draws on its edge grid
    (``cases.loop_grid``) in float32 and float64, through its RV's draw on
    the card (the gamma, Poisson and binomial kernels) against the same
    draw with every loop on its plain version (``plain_loops``): integers
    bit for bit, floats within ``LOOP_FLOAT_ULPS``.  (b) The Gibbs chain
    of ``models/rbm.py`` at ``rbm.py``'s width (784 x 500, 20 chains,
    1,000 steps, float32): one replay of one captured CUDA graph a call,
    no host read, launches by kernel in one call (counts set to 0 just
    before it and read just after), K2's verdict on its scan under
    ``scan__pallas``; its first step against the same step on the CPU at
    the same keys (draws equal wherever the two devices' p agree bit for
    bit); the binomial kernel on that step's real p against its plain
    version; ms a call, steps/s, device busy share and kernels a call.
    (c) Each sampler at ``LOOP_N`` through ``function()`` on a shared key
    (float32): captured, launches a call, ms a call; the Poisson and
    binomial draws captured and replayed.  (d) Each kernel on ``cases.LOOP_TYPICAL`` at
    ``LOOP_N`` and the binomial kernel at the Gibbs draws: device and wall
    time beside its plain version's and torch's sampler's, the hashes the
    draw needs and its bound (gamma's the larger of the hashes' and its
    FP64 pipe's, ``gamma_fp64_ms``).  (e) The ``stamped`` variants' split
    of the draw (``loop_split``; gamma's in its first design and its own,
    ``gamma_split``).  (f) With ``parent`` (a checkout), its gamma, Poisson
    and binomial kernels beside these (gamma on the timed grid and on
    jax's edges, in both ``log_space`` modes).  Returns the launches by
    path and the rows.  On the CPU (a rehearsal) it checks the values
    only, at the sizes set."""
    import torch

    import pytensor_tpu_torch as ptt
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda import (
        binomial_kernel,
        gamma_kernel,
        poisson_kernel,
        scan_kernel,
        threefry_kernel,
    )
    from pytensor_tpu_torch.link.cuda.cases import LOOP_SAMPLERS, loop_grid
    from pytensor_tpu_torch.link.cuda.scan_kernel import scan_kernel_eligible
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.models.rbm import PLOT_EVERY, make_gibbs_chain, rbm_weights
    from pytensor_tpu_torch.scan.op import Scan
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.random import RandomStream

    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    t19 = time.perf_counter()
    mods = {"gamma": gamma_kernel, "poisson": poisson_kernel, "binomial": binomial_kernel}
    rows: dict = {"holds": {}, "samplers": {}, "gibbs": {}, "kernels": {}}
    launches: dict = {}

    def zero_counts():
        fused_kernel.LAUNCHES = scan_kernel.LAUNCHES = threefry_kernel.LAUNCHES = 0
        for m in mods.values():
            m.LAUNCHES = 0

    def counts():
        return {"fused_elemwise": fused_kernel.LAUNCHES, "scan_whole_loop": scan_kernel.LAUNCHES,
                "threefry": threefry_kernel.LAUNCHES,
                **{k: m.LAUNCHES for k, m in mods.items()}}

    # (a) every sampler on its edge grid, kernels against plain loops ----------------
    key = torch.tensor([0x13198A2E, 0x03707344], dtype=torch.int64, device=dev)
    n = LOOP_N if on_card else 2 ** 10
    for name, kernel in LOOP_SAMPLERS.items():
        rv = loop_rv(name)
        batch = (n // 4,) if rv.ndim_supp else (n,)
        for dt in ("float32", "float64"):
            params = [torch.from_numpy(a.astype(dt)).to(dev) for a in loop_grid(name, batch)]
            out_dtype = dt if rv.dtype == "floatX" else rv.dtype
            got = rv.draw(key, None, params, out_dtype)[1]
            with plain_loops():
                want = rv.draw(key, None, params, out_dtype)[1]
            sync()
            n_diff, ulps, abs_err = loop_held(f"{name} {dt}", got, want)
            rows["holds"][f"{name} {dt}"] = {"draws": got.numel(), "differ": n_diff,
                                             "ulps": ulps, "abs": abs_err}
            del got, want, params
    say(f"phase 19: the twelve loop samplers at {n:,} draws on their edge grids in float32 and "
        f"float64, kernels against their plain versions on {dev}: integers bit for bit, floats "
        f"within {LOOP_FLOAT_ULPS} ulps (largest "
        f"{max(r['ulps'] for r in rows['holds'].values())}) in "
        f"{time.perf_counter() - t19:.1f} s")
    if on_card:
        # the gamma kernel built with -fmad=false against the same plain
        # loops, by alpha, on the timed grid and the edge grid: why
        # gamma_kernel.FLAGS keeps nvcc's default contraction
        from pytensor_tpu_torch.link.cuda.cases import LOOP_GAMMA_ALPHA, LOOP_TYPICAL

        fmad_lib, by_alpha = gamma_fmad_false(), {}
        for grid in (LOOP_TYPICAL["gamma"], LOOP_GAMMA_ALPHA):
            alpha = torch.from_numpy(np.resize(np.array(grid, "float64"), n)).to(dev)
            fmad = torch.empty_like(alpha)
            gamma_kernel.run(key, alpha, fmad, lib=fmad_lib)
            default, want = gamma_kernel.launch(key, alpha), gamma_kernel.plain(key, alpha)
            for a in grid:
                at = torch.isnan(alpha) if np.isnan(a) else alpha == a
                by_alpha[f"{a:g} of {len(grid)}"] = (float_ulps(fmad[at], want[at]),
                                                      float_ulps(default[at], want[at]))
        rows["gamma_fmad_false"] = by_alpha
        say(f"gamma kernel against its plain loops at {n:,} draws, by alpha (of the grid of "
            f"4 timed, 7 edge): (draws that differ, largest ulps) built with -fmad=false, "
            f"then as built: " + "; ".join(f"{a} {f} {d}" for a, (f, d) in by_alpha.items()))

    # (b) the Gibbs chain -----------------------------------------------------------------
    W, bh, bv, v0 = rbm_weights()
    gibbs_args: dict = {}
    steps = PLOT_EVERY if on_card else 3
    t0 = time.perf_counter()
    chain, _ = make_gibbs_chain(W, bh, bv, n_steps=steps, device=dev)
    v = torch.from_numpy(v0).to(dev)
    first = chain(v)
    sync()
    plan = getattr(chain.linked, "plan", chain.linked)
    if plan.host_reads:
        raise AssertionError(f"the Gibbs chain reads the card: {plan.host_reads}")
    if on_card and not (isinstance(chain.linked, CapturedFunction)
                        and len(chain.linked.graphs) == 1):
        raise AssertionError("the Gibbs chain is not one captured CUDA graph")
    say(f"gibbs: {steps} steps at 784 x 500, 20 chains linked and captured in "
        f"{time.perf_counter() - t0:.1f} s")
    zero_counts()
    out = chain(v)
    sync()
    launches["gibbs chain"] = counts()
    # each draw is one binomial launch that makes its own key's split
    if on_card and not (launches["gibbs chain"]["binomial"] > 0
                        and launches["gibbs chain"]["threefry"] == 0):
        raise AssertionError(f"gibbs chain: launches {launches['gibbs chain']}, no threefry "
                             f"launch expected")
    if tuple(out.shape) != v0.shape or not bool(((out == 0) | (out == 1)).all()):
        raise AssertionError(f"gibbs chain: a draw of shape {tuple(out.shape)} outside {{0, 1}}")
    if torch.equal(out, first):
        raise AssertionError("gibbs chain: two calls drew the same sample")
    with config.change_flags(scan__pallas=True):
        pallas_chain, _ = make_gibbs_chain(W, bh, bv, n_steps=4, device=dev)
    node = next(nd for nd in pallas_chain.fgraph.toposort() if isinstance(nd.op, Scan))
    verdict = ("K2 takes it" if scan_kernel_eligible(node.op, node) else
               "K2 refuses it (a RandomVariable is on neither package's white list)")
    if "takes" in verdict:
        raise AssertionError("K2 takes the Gibbs scan, which the JAX package refuses")
    say(f"gibbs chain: launches in one replayed call of {steps} steps (counts set to 0 just "
        f"before it) {launches['gibbs chain']}; with scan__pallas, {verdict}; the step loop "
        f"runs")
    # its first step against the CPU's at the same keys
    card = gibbs_probe(W, bh, bv, v, dev)
    cpu = gibbs_probe(W, bh, bv, torch.from_numpy(v0), torch.device("cpu"))
    one, _ = make_gibbs_chain(W, bh, bv, n_steps=1, device=dev)
    if not torch.equal(one(v).cpu(), card[3]):
        raise AssertionError("the probe's first step is not the chain's")
    p_diff = {}
    for tag, (mean, sample) in {"hidden": (0, 1), "visible": (2, 3)}.items():
        same_p = card[mean] == cpu[mean]
        if tag == "visible":
            # the visible means follow the hidden sample
            same_p &= bool(torch.equal(card[1], cpu[1]))
        if not torch.equal(card[sample][same_p], cpu[sample][same_p]):
            raise AssertionError(f"gibbs first step: {tag} draws differ where p agrees")
        p_diff[tag] = int((~same_p).sum())
        # the binomial kernel on the real p, against its plain version
        prob = card[mean].to(dev).reshape(-1).contiguous()
        ones = torch.ones_like(prob)
        got = binomial_kernel.draw(key, ones, prob, torch.int64)
        want = binomial_kernel.plain(key, ones, prob, torch.int64)
        sync()
        n_diff, ulps, abs_err = loop_held(f"binomial at the Gibbs {tag} p", got, want)
        rows["holds"][f"binomial gibbs {tag}"] = {"draws": got.numel(), "differ": n_diff,
                                                  "ulps": ulps, "abs": abs_err}
        rows["kernels"][f"binomial gibbs {tag}"] = (
            loop_times("binomial", [ones, prob], dev, 200) if on_card else {})
        gibbs_args[tag] = [ones, prob]
    say(f"gibbs first step: the card's draws equal the CPU's wherever p agrees bit for bit; "
        f"p differs at {p_diff['hidden']} of {card[0].numel()} hidden and "
        f"{p_diff['visible']} of {card[2].numel()} visible elements; the binomial kernel on "
        f"that step's p is its plain version's, bit for bit")
    rows["gibbs"] = {"steps": steps, "launches": launches["gibbs chain"], "k2": verdict,
                     "p_differs": p_diff}
    if on_card:
        ms = wall_ms(lambda: chain(v), 5)
        dev_ms, by = device_ms(lambda: chain(v), 2)
        bin_us = sum(k_ms for kn, (k_ms, _) in by.items() if "binomial" in kn) * 1e3
        rows["gibbs"].update(ms=ms, steps_s=steps * 1e3 / ms, device_ms=dev_ms,
                             busy=dev_ms / ms, kernels_a_call=sum(c for _, c in by.values()),
                             binomial_device_us=bin_us,
                             top=[(kn[:60], k_ms, c) for kn, (k_ms, c) in
                                  sorted(by.items(), key=lambda kv: -kv[1][0])[:6]])
        g = rows["gibbs"]
        say(f"  gibbs chain: {ms:.2f} ms a call of {steps} steps (wall, CUDA events), "
            f"{g['steps_s']:,.0f} Gibbs steps/s; device {dev_ms:.2f} ms a call, busy "
            f"{g['busy']:.2f}, {g['kernels_a_call']:.0f} kernels a call, the binomial kernel "
            f"{bin_us:.0f} us of it ({smi_line})")
        for kn, k_ms, c in g["top"]:
            say(f"    {k_ms:.3f} ms/call {c:.0f} launches/call {kn}")
        g["launches_by_kernel"] = {kn: c for kn, (_, c) in by.items()}
        say("  gibbs chain: launches a call by kernel (traced): " + "; ".join(
            f"{c:.0f} {kn[:48]}" for kn, c in sorted(g["launches_by_kernel"].items(),
                                                    key=lambda kv: -kv[1])))

    # (c) each sampler through function() on a shared key -----------------------------
    for name, kernel in LOOP_SAMPLERS.items():
        rv = loop_rv(name)
        batch = (n // 4,) if rv.ndim_supp else (n,)
        params = [ptt.shared(a.astype("float32"), device=dev) for a in loop_grid(name, batch)]
        with config.change_flags(floatX="float32"):
            srng = RandomStream(5, device=dev)
            x = (srng.gamma(params[0], scale=params[1]) if name == "gamma"
                 else getattr(srng, name)(*params))
            f = ptt.function([], x, device=dev)
        f()
        sync()
        zero_counts()
        f()
        sync()
        launches[f"{name} 2e20"] = counts()
        if on_card and launches[f"{name} 2e20"][kernel] == 0:
            raise AssertionError(f"{name}: the {kernel} kernel never launched")
        row = {"launches": launches[f"{name} 2e20"]}
        if on_card:
            if not (isinstance(f.linked, CapturedFunction) and len(f.linked.graphs) == 1):
                raise AssertionError(f"{name}: not one captured CUDA graph")
            row["ms"] = wall_ms(f, 10)
        rows["samplers"][name] = row
    say(f"phase 19: the twelve samplers at {n:,} draws through function() on a shared key, "
        f"launches a call " + "; ".join(
            f"{k} {v['launches'][LOOP_SAMPLERS[k]]}" for k, v in rows["samplers"].items()))
    if on_card:
        for k, r in rows["samplers"].items():
            say(f"  {k:18s} {r['ms']:8.3f} ms a call (wall, CUDA events) ({smi_line})")
        say(f"phase 19: one cooperative launch captured into a CUDA graph and replayed twice, "
            f"the eager draw's bits: {', '.join(loop_capture_holds(dev))}")

    # (d) each kernel timed beside its plain version and torch's sampler ---------------
    if on_card:
        for kernel in LOOP_KERNELS:
            rows["kernels"][f"{kernel} 2e20"] = loop_times(
                kernel, loop_typical(kernel, dev, n), dev, 20)
        for tag, r in rows["kernels"].items():
            say(f"  {tag:24s} device {r['ms'] * 1e3:9.1f} us (wall {r['wall_ms'] * 1e3:9.1f}), "
                f"plain {r['plain_ms'] * 1e3:10.1f} us (wall {r['plain_wall_ms'] * 1e3:9.1f}), "
                f"{r['library']} {r['library_ms'] * 1e3:8.1f} us; {r['hashes']:,} hashes, bound "
                f"{r['bound_ms'] * 1e3:.2f} us ({r['bound_by']}: {r['bound_pipe']}), "
                f"{r['bound_ms'] / r['ms']:.2f} of it reached" + (
                    f"; the hashes' bound {r['hash_bound_ms'] * 1e3:.2f} us, the FP64 pipe's "
                    f"{r['fp64_ms'] * 1e3:.2f} us ({r['fp64_instructions']:,} instructions; "
                    f"passes {r['passes']})" if "fp64_ms" in r else "") + f" ({smi_line})")
    # (e) the stamped variants' split of each launch ---------------------------------
    if on_card:
        rows["split"] = {}
        for kernel, tag, args in (("binomial", "binomial gibbs visible", gibbs_args["visible"]),
                                  ("binomial", "binomial 2e20", loop_typical("binomial", dev, n)),
                                  ("poisson", "poisson 2e20", loop_typical("poisson", dev, n))):
            rows["split"][tag] = loop_split(kernel, args, dev, stamped[kernel],
                                            rows["kernels"][tag]["hashes"])
            say_split(tag, rows["split"][tag], smi_line)
        # gamma's, in the first design (one element a thread) and the kernel's
        alpha = loop_typical("gamma", dev, n)[0]
        rows["split"]["gamma 2e20"] = {}
        for design in GAMMA_ENTRIES:
            rows["split"]["gamma 2e20"].update(gamma_split(
                alpha, dev, stamped["gamma"], rows["kernels"]["gamma 2e20"]["hashes"], design))
        say_split("gamma 2e20", rows["split"]["gamma 2e20"], smi_line)
    # (f) with --parent, the parent's Poisson and binomial kernels beside these
    if on_card and parent:
        theirs, rows["parent"] = parent_loops(parent), {}
        for tag, kernel, args in (("binomial gibbs visible", "binomial", gibbs_args["visible"]),
                                  ("binomial gibbs hidden", "binomial", gibbs_args["hidden"]),
                                  ("binomial 2e20", "binomial", loop_typical("binomial", dev, n)),
                                  ("poisson 2e20", "poisson", loop_typical("poisson", dev, n))):
            t = rows["parent"][tag] = loop_beside_parent(kernel, args, dev, theirs)
            say(f"  {tag} folded beside the parent's under the split key ({parent}), the same "
                f"bits; in turn, device us a draw: " + "; ".join(f"{who} " + ", ".join(f"{v * 1e3:.2f}" for v in vs)
                                      for who, vs in t.items()) + f" ({smi_line})")
        # gamma: the same bits on the timed grid and on jax's edges (0 and
        # NaN), in both log_space modes; each grid's draws timed in turn
        from pytensor_tpu_torch.link.cuda.cases import LOOP_GAMMA_ALPHA, LOOP_TYPICAL

        theirs_gamma = parent_gamma(parent)
        for tag, grid in (("gamma 2e20", LOOP_TYPICAL["gamma"]),
                          ("gamma edges 2e20", LOOP_GAMMA_ALPHA)):
            alpha = torch.from_numpy(np.resize(np.array(grid, "float64"), n)).to(dev)
            t = rows["parent"][tag] = gamma_beside_parent(alpha, dev, theirs_gamma)
            say(f"  {tag} beside the parent's ({parent}), the same bits in both log_space "
                f"modes; in turn, device us a draw: " + "; ".join(
                    f"{who} " + ", ".join(f"{v * 1e3:.2f}" for v in vs) for who, vs in t.items())
                + f" ({smi_line})")
    say(f"loop samplers phase done in {time.perf_counter() - t19:.1f} s")
    return launches, rows


def loop_builds(pool, timed):
    """Phase 2's jobs for phases 18 and 19: threefry, the hash probe, the
    normal probe, the FP64 probe, the three loop kernels, gamma with ``-fmad=false`` and the
    stamped variants of the three."""
    from pytensor_tpu_torch.link.cuda import (
        binomial_kernel,
        gamma_kernel,
        poisson_kernel,
        threefry_kernel,
    )

    return {"threefry": pool.submit(timed, lambda: threefry_kernel.build(verbose=True)),
            "hash probe": pool.submit(hash_instructions),
            "normal probe": pool.submit(normal_instructions),
            "gamma -fmad=false": pool.submit(timed, gamma_fmad_false),
            **{name: pool.submit(timed, lambda m=m: m.build(verbose=True))
               for name, m in (("gamma", gamma_kernel), ("poisson", poisson_kernel),
                               ("binomial", binomial_kernel))},
            "fp64 probe": pool.submit(fp64_instructions),
            **{f"{name} stamped": pool.submit(loop_stamped, m)
               for name, m in (("gamma", gamma_kernel), ("poisson", poisson_kernel),
                               ("binomial", binomial_kernel))}}


def loop_build_logs(build_s):
    """The build logs of ``loop_builds``' jobs; the stamped variants'
    libraries go to ``build_s["stamped"]``, by kernel."""
    from pytensor_tpu_torch.link.cuda import (
        binomial_kernel,
        gamma_kernel,
        poisson_kernel,
        threefry_kernel,
    )

    build_s["stamped"], logs = {}, {}
    for name in ("gamma", "poisson", "binomial"):
        tag = f"{name} stamped"
        build_s[tag], build_s["stamped"][name], logs[tag] = build_s[tag]
    return {"threefry": threefry_kernel.BUILD_LOG, "gamma": gamma_kernel.BUILD_LOG,
            "poisson": poisson_kernel.BUILD_LOG, "binomial": binomial_kernel.BUILD_LOG, **logs}


def say_builds(logs, build_s):
    """Print each build's seconds and ptxas lines; take the hash probe's
    count into ``HASH_SASS`` and ``HASH_S``, and the threefry kernel's
    SASS a draw by mode into ``THREEFRY_SASS``."""
    from pytensor_tpu_torch.link.cuda import threefry_kernel

    for tag, log in logs.items():
        say(f"build: {tag} nvcc sm_90a in {build_s[tag]:.2f} s (started together)")
        for line in log.splitlines():
            if "ptxas info" in line and ("registers" in line or "smem" in line) \
                    or "bytes stack frame" in line:
                say(f"  {tag} ptxas:", line.strip())
    # the threefry hash's integer instructions, for the bounds of phases 18
    # and 19
    global HASH_SASS, HASH_S
    HASH_SASS = build_s.pop("hash probe")
    HASH_S = hash_rate(HASH_SASS)
    alu_only = SM_CLOCKS_S / max(HASH_SASS["alu"] / ALU_LANES, HASH_SASS["all"] / DISPATCH_LANES)
    say(f"threefry hash (cuobjdump -sass of csrc/threefry.cuh's hash, HASH_PROBE): "
        f"{HASH_SASS['all']:g} instructions, {HASH_SASS['alu']:g} on the ALU pipe and "
        f"{HASH_SASS['fma']:g} IMAD on the FMA pipe; at most {HASH_S / 1e9:.1f} G hashes a "
        f"second on the card ({ALU_LANES} ALU, {FMA_LANES} FMA and {DISPATCH_LANES} dispatched "
        f"lanes an SM a clock; {alu_only / 1e9:.1f} G counting the ALU pipe and dispatch "
        f"alone)")
    THREEFRY_SASS.update(threefry_instructions(threefry_kernel.build()))
    NORMAL_FP64.update(build_s.pop("normal probe"))
    say("threefry kernel a draw (cuobjdump -sass of csrc/threefry.cu, the grid-stride loop's "
        "least path over its counters), by pipe: " + "; ".join(
            f"{m} " + ", ".join(f"{k} {v:g}" for k, v in c.items())
            for m, c in THREEFRY_SASS.items()))
    say(f"normal64's FP64-pipe instructions a draw (NORMAL_PROBE): {NORMAL_FP64['least']:g} on "
        f"the shortest path (by way of erfinv's log), {NORMAL_FP64['static']:g} on every branch, "
        f"at {FP64_LANES} lanes an SM a clock")
    # gamma's float64 work, for its bound in phase 19
    GAMMA_FP64.update(build_s.pop("fp64 probe"))
    say("gamma's float64 work (cuobjdump -sass of FP64_PROBE; every branch of erfinv, log and "
        "pow): FP64-pipe instructions " + ", ".join(f"{k} {v}" for k, v in GAMMA_FP64.items())
        + f", at {FP64_LANES} lanes an SM a clock")


def main(opts):
    import torch

    t_start = time.perf_counter()
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
    from pytensor_tpu_torch.link.cuda import (
        binomial_kernel,
        cases,
        gamma_kernel,
        poisson_kernel,
        scan_kernel,
        spmv_kernel,
        threefry_kernel,
    )
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
    if opts.parent:
        # a parent whose loop kernels phase 19 cannot call is refused now,
        # not after the other phases
        for kernel in ("poisson", "binomial"):
            parent_interface(Path(opts.parent, "pytensor_tpu_torch", "csrc",
                                  f"{kernel}.cu").read_text(), f"{kernel}_draw")
        names = c_params(Path(opts.parent, "pytensor_tpu_torch", "csrc",
                              "gamma.cu").read_text(), "gamma_draw")
        if [a for a in names if a != "split"] != GAMMA_PARAMS:
            raise SystemExit(f"--parent: its gamma_draw is not ({', '.join(GAMMA_PARAMS)}), "
                             f"with or without a split")

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
    # the special functions' (phase 14): each as a one-node K1 kernel a
    # dtype, one fused node a dtype of all of them (phase 3), the bessel
    # paths' K1 kernels and K2 of the loop under scan__pallas
    t0 = time.perf_counter()
    special_one_node, special_libs, special_k2 = special_kernels(dev)
    special_groups = {dt: cases.special_op_group(dt) for dt in ("float32", "float64")}
    special_group_kerns = {dt: fused_kernel.FusedElemwiseKernel(FusedElemwise(ins, outs).fgraph,
                                                                dev)
                           for dt, (ins, outs, _) in special_groups.items()}
    say(f"the special slice's graphs: {len(special_one_node)} one-node K1 kernels in "
        f"{len(special_libs) - 1} libraries, {sum(map(len, special_libs[-1:]))} K1 kernels of the "
        f"bessel paths, {len(special_group_kerns)} K1 op groups, {len(special_k2)} K2 kernel; "
        f"graph, rewrite and emit in {time.perf_counter() - t0:.2f} s")

    # the bfloat16 phase's (15): K1 on every op of its table in bfloat16, one
    # node a kernel, the MFU class node, the bfloat16 MFU step's K1 kernels
    # and K2 of the EWMA in bfloat16 and float32
    t0 = time.perf_counter()
    bf16_one_node, bf16_cls, bf16_model_k1, bf16_k2 = bf16_kernels(dev)
    say(f"the bfloat16 slice's graphs: {len(bf16_one_node)} one-node K1 kernels, "
        f"{len(bf16_model_k1)} K1 kernels of the MFU step's paths, {len(bf16_k2)} K2 kernels; "
        f"graph, rewrite and emit in {time.perf_counter() - t0:.2f} s")

    # the tail's (16): the K1 kernels of its functions, K1's floor division
    # of a signed zero, and K2 of the scan rows whose source no other K2
    # build holds (the EWMA row's is phase 15's float32 EWMA)
    t0 = time.perf_counter()
    tail_k1, tail_signs, tail_k2 = tail_kernels(dev)
    other_k2 = {k.source for k in [k2, *elman_k2, *special_k2, *bf16_k2.values()]}
    other_k2 |= {k.source for _, _, _, k, _ in k2_cases}
    tail_k2 = {kind: k for kind, k in tail_k2.items() if k.source not in other_k2}
    say(f"the tail slice's graphs: {len(tail_k1)} K1 kernels, {len(tail_signs)} floor-division "
        f"nodes, {len(tail_k2)} K2 kernel(s) of the scan rows not built for another phase; "
        f"graph, rewrite and emit in {time.perf_counter() - t0:.2f} s")

    # phase 17's: the K1 kernels of the MAP's and the periodogram's
    # functions (their plans' and the plans inside BFGS and Newton) and
    # every complex op K1 emits, one node a kernel, a library a dtype
    t0 = time.perf_counter()
    opt_k1, complex_one_node = optimize_kernels(dev)
    say(f"the optimize slice's graphs: {len(opt_k1)} K1 kernels of the MAP's and the "
        f"periodogram's functions, {len(complex_one_node)} one-node complex K1 kernels; graph, "
        f"rewrite and emit in {time.perf_counter() - t0:.2f} s")

    # phase 18's: the K1 kernels of the three HMC functions, from the same
    # functions linked for the CPU (phase 18's reference); threefry is
    # built in the pool below
    t0 = time.perf_counter()
    random_k1, hmc_cpu = random_kernels(dev)
    say(f"the random slice's graphs: {len(random_k1)} K1 kernels of the HMC functions; graph, "
        f"rewrite and link for the CPU in {time.perf_counter() - t0:.2f} s")

    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    with ThreadPoolExecutor(32) as pool:
        k1_jobs = [pool.submit(fused_kernel.build, kerns, verbose=True)
                   for kerns in [*k1_kernels.values(), list(op_kerns.values()), model_kerns,
                                 elman_k1, linalg_k1, *special_libs,
                                 list(special_group_kerns.values()),
                                 [k for k, _ in bf16_one_node.values()] + [bf16_cls],
                                 bf16_model_k1, tail_k1 + list(tail_signs.values()), opt_k1,
                                 random_k1,
                                 *[[k for (_, d), k in complex_one_node.items() if d == dt]
                                   for dt in ("complex64", "complex128")]]]
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
                **loop_builds(pool, timed),
                **{f"K2 case: {tag}": pool.submit(timed, lambda k=k: k.build(verbose=True))
                   for tag, _, _, k, _ in k2_cases},
                **{"K2 static BPTT": pool.submit(timed, lambda k=k: k.build(verbose=True))
                   for k in elman_k2},
                **{"K2 bessel loop": pool.submit(timed, lambda k=k: k.build(verbose=True))
                   for k in special_k2},
                **{f"K2 ewma {dt}": pool.submit(timed, lambda k=k: k.build(verbose=True))
                   for dt, k in bf16_k2.items()},
                **{f"K2 scan {kind}": pool.submit(timed, lambda k=k: k.build(verbose=True))
                   for kind, k in tail_k2.items()}}
        build_s = {tag: job.result() for tag, job in jobs.items()}
        for job in k1_jobs:
            job.result()
    logs = {"K3": radon_kernel.BUILD_LOGS[()],
            "K3 stamped": radon_kernel.BUILD_LOGS[radon_kernel.STAMPED],
            "K3, rows in shared memory": radon_kernel.BUILD_LOGS[K3_SHARED_WALK],
            "K3 stamped, rows in shared memory":
                radon_kernel.BUILD_LOGS[radon_kernel.STAMPED + K3_SHARED_WALK],
            "K2": k2.build_log, "K2 stamped": k2_stamped.build_log, "K4": spmv_kernel.BUILD_LOG,
            **loop_build_logs(build_s),
            **{f"K2 case: {tag}": k.build_log for tag, _, _, k, _ in k2_cases},
            **{"K2 static BPTT": k.build_log for k in elman_k2},
            **{"K2 bessel loop": k.build_log for k in special_k2},
            **{f"K2 ewma {dt}": k.build_log for dt, k in bf16_k2.items()},
            **{f"K2 scan {kind}": k.build_log for kind, k in tail_k2.items()}}
    say_builds(logs, build_s)
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
    # every special function of the expression table, a fused node a float dtype
    for dt, (ins, outs, names) in special_groups.items():
        kern = special_group_kerns[dt]
        args = [as_torch(v, dev) for v in cases.special_group_inputs(dt, 4099)]
        got, want = kern.launch(*args), kern.plain(*args)
        torch.cuda.synchronize()
        worst_sp = 0.0
        for op_name, g, w in zip(names, got, want):
            g, w = g.double().cpu(), w.double().cpu()
            if not (torch.equal(g.isnan(), w.isnan()) and torch.equal(g[w.isinf()], w[w.isinf()])):
                raise AssertionError(f"K1 special op {op_name} {dt}: NaN or inf where the plain "
                                     f"version has none")
            fin = torch.isfinite(w)
            err = float(((g[fin] - w[fin]).abs() / w[fin].abs().clamp(min=1.0)).max())
            if not err <= SPECIAL_RTOL[dt]:
                raise AssertionError(f"K1 special op {op_name} {dt}: rel err {err} > "
                                     f"{SPECIAL_RTOL[dt]}")
            worst_sp = max(worst_sp, err)
        say(f"  K1 special ops {dt}: {len(names)} ops in one fused node on 4,099 in-domain "
            f"elements, max rel err {worst_sp:.2e} against the plain version (tol "
            f"{SPECIAL_RTOL[dt]:g}); wall {wall_ms(lambda: kern.launch(*args), 20) * 1e3:.1f} us "
            f"a launch")
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
        cold4 = k4_ms(lambda: spmv_kernel.launch(*args), 50, cold=True)
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
                                       k4_ms(lambda: fn(*args), 50, cold=True)))
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
    if k4_power:
        say(f"K4 inside the power iteration: {k4_power[0][0] / k4_power[0][1] * 1e3:.2f} us a "
            f"launch (device), {k4_power[0][1]:.0f} launches a call")

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

    # 14. the special functions and the bessel loop ------------------------
    special_launches, k1_special_abs, k2_special_abs, _, _ = phase_special(dev, smi,
                                                                          special_one_node)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_special_abs)
    k2_abs = max(k2_abs, k2_special_abs)
    model_launches["special"] = {
        kind: sum(v[kind] for v in special_launches.values())
        for kind in ("fused_elemwise", "scan_whole_loop")}

    # 15. bfloat16 -----------------------------------------------------------
    bf16_launches, k1_bf16_abs, k2_bf16_abs, bf16_rows = phase_bf16(dev, smi, bf16_one_node,
                                                                    bf16_cls)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_bf16_abs)
    k2_abs = max(k2_abs, k2_bf16_abs)
    model_launches.update(bf16_launches)
    k1_bf16 = bf16_rows["k1"]
    k2_bf16 = {dt: {"ms": ms, "us_a_step": ms / EWMA_N * 1e3, "plain_wall_ms": p,
                    "bound_ms": b, "bound_by": by, "bound_one_sm_ms": b * n_sms}
               for dt, (ms, p, b, by) in bf16_rows["k2"].items()}

    # 16. the tensor library's tail: the einsum loop, the scan rows --------
    tail_launches, k1_tail_abs, k2_tail_abs, tail_rows = phase_tail(dev, smi, tail_signs)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_tail_abs)
    k2_abs = max(k2_abs, k2_tail_abs)
    model_launches.update(tail_launches)

    # 17. tensor/optimize.py and the complex ops -------------------------------
    opt_launches, k1_opt_abs, opt_rows = phase_optimize(dev, smi, complex_one_node)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_opt_abs)
    model_launches.update(opt_launches)

    # 18. random and HMC ----------------------------------------------------------
    random_launches, k1_random_abs, random_rows = phase_random(dev, smi, hmc_cpu, opts.parent)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_random_abs)
    model_launches.update(random_launches)
    main_draw = random_rows["threefry"]["folded normal 256x89"]

    # 19. jax's loop samplers and the RBM Gibbs chain ----------------------------
    loop_launches, loop_rows = phase_loops(dev, smi, build_s["stamped"], opts.parent)
    loop_entries = []
    for kname, timed_at in (("gamma", "gamma 2e20"), ("poisson", "poisson 2e20"),
                            ("binomial", "binomial gibbs visible")):
        r = loop_rows["kernels"][timed_at]
        by_path = {tag: v[kname] for tag, v in loop_launches.items()}
        held = [h for t, h in loop_rows["holds"].items()
                if cases.LOOP_SAMPLERS[t.split()[0]] == kname]
        loop_entries.append({
            "name": f"{kname} (jax's loop sampler)", "route": "cuda",
            "source": f"pytensor_tpu_torch/csrc/{kname}.cu",
            "replaces": "jax.random's while_loop sampler (XLA; no Pallas kernel)",
            "launches": sum(by_path.values()), "launches_by_path": by_path,
            "max_abs_err": max(h["abs"] for h in held), "max_ulps": max(
                h["ulps"] for h in held),
            "ms": r["ms"], "plain_ms": r["plain_ms"], "wall_ms": r["wall_ms"],
            "plain_wall_ms": r["plain_wall_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "library": r["library"], "timed_at": f"{timed_at} ({r['n']:,} draws)",
            "hashes": r["hashes"],
            **{k: r[k] for k in ("bound_pipe", "hash_bound_ms", "fp64_ms", "passes") if k in r},
            "timings": {t: v for t, v in loop_rows["kernels"].items() if t.startswith(kname)},
            **({"gibbs": loop_rows["gibbs"], "samplers": loop_rows["samplers"]}
               if kname == "binomial" else {})})

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
         "bound_ms": k1["bound_ms"], "bound_by": k1["bound_by"], "library_ms": None,
         "bf16_mfu_class_node": k1_bf16, "complex_ops_2e24": opt_rows["complex_ops_2e24"],
         "periodogram_node": opt_rows["periodogram"],
         "logreg_map": {k: v for k, v in opt_rows.items() if k.startswith("logreg")}},
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
         "bound_one_sm_ms": k2_bound[0] * n_sms, "library_ms": None,
         "ewma_n4096": k2_bf16,
         "scan_rows_n4096": {k: v for k, v in tail_rows.items() if k.startswith("scan")}},
        {"name": "spmv_csr (K4)", "route": "cuda",
         "source": "pytensor_tpu_torch/csrc/spmv_csr.cu",
         "replaces": "pytensor_tpu/link/pallas/route.py:194",
         "launches": power_launches["spmv_csr"], **k4},
        {"name": "threefry2x32", "route": "cuda",
         "source": "pytensor_tpu_torch/csrc/threefry.cu",
         "replaces": "jax.random threefry2x32 (XLA; no Pallas kernel)",
         "launches": sum(v["threefry"] for v in random_launches.values()),
         "launches_by_path": {tag: v["threefry"] for tag, v in random_launches.items()},
         "max_abs_err": random_rows["threefry_abs"],
         "ms": main_draw["ms"], "plain_ms": main_draw["plain_ms"],
         "bound_ms": main_draw["bound_ms"], "bound_by": main_draw["bound_by"],
         "library_ms": None,
         "timed_at": "folded normal 256x89 (the 256-chain momenta, with their split)",
         "hash_instructions": HASH_SASS, "kernel_instructions": THREEFRY_SASS,
         "draws": random_rows["threefry"], "hmc": random_rows["hmc"]},
        *loop_entries,
    ]
    for entry in kernels:
        within_bound(entry["name"], entry)
    say(f"chip_smoke: every phase passed in {time.perf_counter() - t_start:.1f} s")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": device_name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    cli = argparse.ArgumentParser(description="Drive the torch port on one NVIDIA GPU.")
    cli.add_argument("--parent", metavar="DIR",
                     help="a checkout of an earlier commit whose K4 (phase 9) and gamma, "
                          "Poisson and binomial kernels (phase 19) are held and timed beside "
                          "this tree's")
    sys.exit(main(cli.parse_args()))

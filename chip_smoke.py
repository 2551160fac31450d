"""Drive the torch port's radon, sparse, logistic-regression, MLP, Elman
RNN, linalg (GP, Kalman filter, batched Cholesky), special-function (the
bessel loop), bfloat16 (the MLP "MFU" step, the GEMM chain), tensor
library tail (the einsum loop, the scan rows, the new lowerings),
optimize and complex (the logistic-regression MAP, a periodogram),
random (threefry, the HMC transitions), loop-sampler (jax's gamma,
Poisson and binomial loops, the RBM Gibbs chain), while-scan, compile
driver, graph-layer (the rewrite probe, printing, the destroy
handler), control and debug (IfElse, asserts, the debug modes, typed
lists) and sparse (learned edge weights, a tf-idf SGD step, a row an op)
paths on one NVIDIA GPU.

    python3 chip_smoke.py [--parent DIR]

Phases, one line or more each, and any failure raises:

1. device: require CUDA; print the card's name and power limit.
2. build: the fused elementwise kernels (K1) of the four radon graphs in
   one library, the radon leapfrog kernel (K3), the whole-loop scan kernel
   (K2) of the leapfrog chain at full width and the CSR matvec kernel
   (K4), with nvcc, the compilers started together, and K3 built to walk
   every county's rows from shared memory (K3's and K2's stamped
   variants, diagnostics of their redesigns, are no longer built); print K2's loops, barriers, arena bytes,
   placement and source sha256, each build's seconds and the ``-Xptxas -v``
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
   its outputs (one chain and 1,024 chains).  The build that walks every
   county's rows from shared memory (the path a county of more than
   ``K3_ROW_CAP`` rows takes) must give K3's bits.
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
   theta, m and logp.  Then K2 on
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
   lists) beside it; a ``LONG_CAPTURE_STEPS``-step float64 chain through
   the step loop (128 steps, ~18,000 nodes) as the longest capture.  Then the kernels that take
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
   each (K1 once a fused node, none in a loop; K2 never); the replay of a
   ``function()`` path against its eager plan by sha256 (the loops' eager
   twins were cut for phase 25's room); the values against float64 NumPy
   (``LINALG_TOL``); each loop against as many calls of its step; every
   K1 node of the paths against its plain version at the path's shapes;
   the Cholesky calls of path (c), one a step of 128 matrices; wall and
   device ms a call, captured (and eager, for a ``function()`` path), busy
   share, steps/s, kernels a call with the top ones by name and cuSOLVER's
   factorisation kernels a step.
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
   steps of 0.02), with the default flags (not again under
   ``scan__pallas``, which gives the same rows: K2 refuses the leapfrog
   scans, and the verdict is printed): each
   call one replay of one captured CUDA graph, no host read; the first
   ``HMC_HELD`` transitions against the CPU (accepts and indices equal,
   ``HMC_RTOL``); K1, K2 and threefry launches in one replayed call
   (counts set to 0 just before it, read just after; threefry twice a
   transition, the momenta and the uniforms, each folded), K2's verdict on
   each scan and why; ms a transition, transitions/s, busy share; each K1
   node of the calls against its plain version.  K1's and K2's
   ``launches_by_path`` gain the three paths; the kernel line gains the
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
   built with ``-fmad=false`` against the plain loops, by alpha (the
   stamped variants' split of the draws, ``-DLOOP_STAMPS``, is no longer
   run: a diagnostic of the kernels' redesigns); (f) with ``--parent
   DIR``, DIR's ``csrc/poisson.cu`` and
   ``csrc/binomial.cu`` built with their own headers (``parent_loops``,
   which calls the two-pass C entry of the loop kernels' first tree or the
   one-launch entry of this one, and refuses another), their draws
   required to be this tree's at both Gibbs draws and at 2**20, and the
   two timed in turn, twice.  The kernel line gains an entry for each of
   the three kernels.
20. the censored-likelihood gradient (``phase_censored``): the
   shape-parameter gradients' main path, one captured graph.
21. while-scans (``phase_while``): (a) ``benchsuite.py:160``'s power
   iteration as a while-scan (``models/power.py``: at most 64 steps,
   stopped where ``max|x_new - x|`` falls below a tolerance chosen from
   the float64 scipy loop so that it fires after step 16), through
   ``function()``, eager (the step loop reads its condition after each
   step): the counts set to 0 before one call of the iterates' function
   and one of the gradient of ``sum(xs[-1] * w)`` in ``x0`` and read
   after (K4 once a forward step, once on Aᵀ a reverse step), the exit
   step against the float64 loop's, the iterates against the plain SpMV
   step loop on the card and float64 scipy, the gradient against
   torch's autograd of the plain loop in float64 (within four times the
   float32 plain loop's own error); (b) the radon leapfrog trajectory in
   float64 at full width (``models/radon.py make_radon_trajectory``),
   stopped where ``|H - H0| > 1000``, at a step size where that fires
   mid-way and one where it never does: the exit steps, the rows against
   the same steps as a for-scan, the divergence test against the
   energies, and each call with torch's defaults against the held rows;
   each path's K1 nodes against their plain version; the power
   iteration's step cost with the condition's read against the step of a
   for-scan that computes and traces the same test, both eager, in
   alternated calls; the trajectory's read by its span in
   ``torch.profiler`` (its alternated calls were cut to make room for
   phase 22: they did not resolve the read in 6-10 s).
22. the compile driver (``phase_compile``): the radon logp and dlogp at
   full width in float64 under ``mode="FAST_COMPILE"``, ``"PY"`` and
   ``"FAST_RUN"`` (compile seconds, ms a call, K1 launches a call: none
   under ``FAST_COMPILE``), each against the others and the CPU; the
   Hessian-vector product ``pushforward(dlogp, theta, v)`` against central
   differences of ``dlogp`` and the CPU; ``Function.copy`` of phase 10's
   power iteration in its three forms (K4 64 launches a call, the
   original's bits, only its own shared tensor moving) and the same
   function through ``pkl_utils.dump_function``/``load_function``; phase
   7's 8,192-step chain through ``pickle`` (one K2 launch a call, the
   original's bits; seconds from ``loads`` to the first result); and
   ``profile=True`` under ``FAST_RUN`` and ``PY`` (calls, host and device
   ms, the first call's peak bytes, the static op table's top 5).  Each K1
   node of the ``FAST_RUN`` functions against its plain version.
23. the graph layer (``phase_graph``; its K1 kernels from
   ``graph_kernels``, built in phase 2's pool): (a) each probe graph of
   ``pytensor_tpu_torch/link/cuda/rewrite_cases.py`` (the ShapeFeature's
   two graphs on inputs of unknown shape, and one or more graphs for each
   of the 54 ``local_*`` rewrites of ``tensor/rewriting/{basic,subtensor,
   math}.py`` that ROADMAP Queue 1 item 6 ported) at 4,096 x 4,096 or
   2**24 float32 elements under ``FAST_RUN``, captured: the rewrite fires
   while linking (counted by wrapping ``FromFunctionNodeRewriter
   .transform``), nodes as on the CPU and against the graph without the
   rewrite, K1 and K2 launches in one replayed call, the value against
   float64 numpy (``GRAPH_TOL``), every K1 node against its plain
   version; the ShapeFeature's graphs and the four rewrites that move a
   product or a reduction timed with the rewrite and without it (device
   ms); one line a family (shape, basic, subtensor, math).  (b) ``dprint``
   of the radon logp and dlogp at 919/85 in float64 (its FusedElemwise
   nodes), ``pprint`` of logp, ``Print`` on dlogp (the plan eager and
   why, the message once a call, the captured function's bits).  (c) The
   radon function and phase 7's chain again under
   ``FAST_RUN.register(AddDestroyHandler())``: ``validate``, the donation
   report, one K2 launch a chain call with the original's bits, and
   destroyers in a cycle refused.  (d) ``misc/check_blas.py``'s GEMM at
   4,096 in float32 and bfloat16 (cuBLAS; GFLOP/s).  K1's and K2's
   ``launches_by_path`` gain ``graph`` and the paths of (b) and (c).
24. control and debug ops (``phase_control``; its K1 kernels from
   ``control_kernels``, built in phase 2's pool): (a) the guarded radon
   function of ``models/radon.py guarded_graphs`` (919/85, float64 and
   float32: ``ifelse(all(isfinite(theta)), [logp, dlogp], [-inf, 0])``,
   an assert the assumptions prove and one on the data): its ``IfElse``
   and ``CheckAndRaise`` nodes as on the CPU; at a finite theta K1
   launches as the unguarded function does (captured), with its bits, and
   the two conditions' own fused nodes, and so does the float64 function
   with the asserts alone (captured, its flags read after each replay);
   at a theta holding a NaN only the condition's node, and -inf and
   zeros; observations holding an inf raising the data assert's
   message and node from both; the float64 values against the CPU
   (``CONTROL_RTOL``); ms a call of each in turn and the host's reads of
   a guarded call in ``torch.profiler``.  (b) A nested ``ifelse`` whose
   untaken branches hold a counting probe op: the probe runs only where
   its branch is taken.  (c) ``DebugMode`` on the float64 radon function:
   every node held against its oracle, each K1 node against its plain
   version (launched once a node), ms a call; a toy op's wrong lowering
   raising ``BadThunkOutput``; a rewrite that scales ``exp`` named by
   ``BadOptimization``.  (d) ``NanGuardMode`` at a NaN theta raising the
   CPU's message, ms a call at a finite one; (e) ``MonitorMode``'s
   callback seeing every node once a call; (f) each typed-list op on a
   list of four thetas against the CPU, and whether its plan captures;
   (g) ``PdbBreakpoint`` with its debugger replaced by a counter, firing
   only where its condition holds, with the card's values.  K1's
   ``launches_by_path`` gains the ``control`` paths.
25. the sparse slice (``phase_sparse``; its K1 kernels from
   ``sparse_kernels``, built in phase 2's pool, its references, the same
   functions on the CPU and float64 scipy/NumPy, from
   ``sparse_cpu_reference`` at the phase's start): (a) learned edge
   weights (``models/sparse_learning.py``) on ``benchsuite.py:160``'s
   65,536² pattern, ten stored a row, float32, width 16: ``W =
   CSM("csr")(w, ...)``, ``sum(sqr(structured_dot(W, X) - T))`` and its
   gradient in ``w`` through ``function()``: its rewritten ops, whether
   ``local_csm_grad_same_pattern`` fired, captured with one capture, K1
   launches a replayed call, wall and device ms, busy share, the loss and
   gradient against the CPU and scipy (``SPARSE_PATH_TOL``); (b) the tf-idf
   softmax-regression SGD step on a matrix shaped like
   ``fetch_20newsgroups_vectorized``'s training split (11,314 x 130,107,
   ~158 a row, 20 classes, from ``SPARSE_SEED``): captured or not with the
   reason, K1 launches a step, ms a step, ``W`` and ``b`` after
   ``TFIDF_STEPS`` steps against the CPU and float64 NumPy, each over its
   own largest magnitude, and a control (``W`` without its gradient's data
   term) that the hold must refuse; each K1 node of
   (a) and (b) against its plain version; (c) a function a row of
   ``link/cuda/sparse_cases.py`` (``SamplingDot`` at MovieLens-1M's
   pattern, ``Usmm`` through ``local_usmm``, ``AddSD``, ``AddSS``,
   ``MulSV``, ``MulSS``, ``hstack``/``vstack`` of (b)'s halves,
   ``csr_from_dense`` at 4,096² and 1 %, ``remove0``, ``GetItemList`` of
   1,024 rows, ``GetItem2Lists``, ``GetItemScalar``, ``Diag``,
   ``block_diag`` of 256 blocks of 64 x 64): ms a call, captured or eager
   with the op that reads back, the host's reads of a call in
   ``torch.profiler`` (``READ_SPANS``), the result against the CPU and
   scipy (dense values, and the structure where scipy's is canonical).
   K1's ``launches_by_path`` gains the two paths.

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
import atexit
import ctypes
import hashlib
import json
import multiprocessing
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
# the steps of phase 8's longest capture (a float64 chain through the step
# loop; 1,024 before it was cut with the script's other repeats, 512 before
# it was cut to make room for phase 25)
LONG_CAPTURE_STEPS = 128
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


class Laps:
    """Each phase's seconds: ``lap(n)`` ends phase ``n`` where the last lap
    (or the start) ended, prints its seconds and keeps them in ``seconds``."""

    def __init__(self):
        self.seconds: dict = {}
        self.last = time.perf_counter()

    def __call__(self, n):
        now = time.perf_counter()
        self.seconds[f"phase {n}"] = now - self.last
        self.last = now
        say(f"phase {n}: {self.seconds[f'phase {n}']:.1f} s")


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
    if not eager_calls:
        eager()
    else:
        # the eager side's timed calls count the nodes (a call of seconds)
        e_wall = wall_ms(eager, eager_calls, warmup=0)
    nodes = torch_linker.NODES_RUN // (eager_calls or 1)
    graphs = [g for f in functions for g in f.graphs.values()]
    row = {}
    for kind, call in (("captured", captured), ("eager", eager)):
        if kind == "eager" and eager_calls:
            row[kind] = {"wall": e_wall, "dev": float("nan"), "by": {}, "peak": float("nan")}
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
    # (in float64 on the card: NumPy took ~50 s of the host)
    mfu_ref = mlp_mfu_reference(Xg, Tg, mfu_init, MFU_LR, MFU_STEPS, masks, device=dev)
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
        say(f"{tag}: loss {loss:.7f} vs float64 {r_loss:.7f} (rel err {e_loss:.2e}, tol "
            f"{MODEL_TOL[tol_l]:g}); after {steps} step(s), {what}")
    del mfu_ref
    say(f"float64 references (NumPy; the MFU steps by torch on the card) in "
        f"{time.perf_counter() - t_ref:.1f} s")
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
        # an eager loop call takes ~2 s on the host: one, untraced
        n_iter = 20 if steps == 1 else 2
        row = captured_vs_eager(tag, lambda f=f, a=args: f(*a), lambda f=f_e, a=args: f(*a),
                                [f.linked], n_iter, n_dev=max(1, n_iter // 4),
                                eager_calls=None if steps == 1 else 1)
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
# (the SGD loop 8 steps a call, 16 before it was cut: its eager call took
# ~8 s, twice; cut with the script's other repeats)
KALMAN_T, KALMAN_K, KALMAN_P, KALMAN_LOOP, KALMAN_LR = 64, 4, 2, 8, 1e-5
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


# the paths with an eager twin in phase 13: the ``function()`` paths, and of
# the loops the Cholesky loop alone, whose Cholesky calls are counted (the
# other loops' eager twins, some 10 s of eager calls, were cut to make room
# for phase 25); the other loops hold no K1 node (nothing fuses inside a scan)
LINALG_EAGER = ("gp step", "gp mll float64", "kalman loglike+grad", "kalman step", "chol step",
                f"chol loop x{CHOL_LOOP}")


def linalg_paths(dev, tags=None):
    """The functions of paths (a)-(c) on ``dev``: ``{tag: (f, state, args,
    steps)}`` with the shared variables a call updates and the arguments
    it takes (numpy values); those of ``tags`` alone where given."""
    from pytensor_tpu_torch.models.batched_cholesky import make_batched_cholesky_step
    from pytensor_tpu_torch.models.gp import make_gp_marginal_likelihood, make_gp_sgd_step
    from pytensor_tpu_torch.models.kalman import (
        make_kalman_loglike_and_grad,
        make_kalman_sgd_step,
    )

    def gp(steps):
        f, params = make_gp_sgd_step(GP_N, dtype="float32", lr=GP_LR, n_steps_per_call=steps,
                                     device=dev)
        return f, params, [], steps

    def gp_mll():
        f, theta0 = make_gp_marginal_likelihood(GP_N, dtype="float64", device=dev)
        return f, [], list(theta0), 1

    def kalman_grad():
        f, theta0, _ = make_kalman_loglike_and_grad(KALMAN_T, KALMAN_K, KALMAN_P, "float32",
                                                    device=dev)
        return f, [], list(theta0), 1

    def kalman(steps):
        f, T, _ = make_kalman_sgd_step(KALMAN_T, KALMAN_K, KALMAN_P, KALMAN_LR,
                                       n_steps_per_call=steps, device=dev)
        return f, [T], [], steps

    def chol(steps):
        f, A = make_batched_cholesky_step(CHOL_BATCH, CHOL_N, n_steps_per_call=steps, device=dev)
        return f, [A], [], steps

    makers = {"gp step": lambda: gp(1), f"gp loop x{GP_LOOP}": lambda: gp(GP_LOOP),
              "gp mll float64": gp_mll, "kalman loglike+grad": kalman_grad,
              "kalman step": lambda: kalman(1),
              f"kalman loop x{KALMAN_LOOP}": lambda: kalman(KALMAN_LOOP),
              "chol step": lambda: chol(1), f"chol loop x{CHOL_LOOP}": lambda: chol(CHOL_LOOP)}
    return {tag: make() for tag, make in makers.items() if tags is None or tag in tags}


def linalg_kernels(dev):
    """The K1 kernels of the linalg paths' functions, their graphs
    rewritten on the CPU (the same sources as linking them for the card),
    for the build pool of phase 2 (phase 13 finds them built): those of
    ``LINALG_EAGER``, as the other loops hold no K1 node."""
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    return [fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
            for f, *_ in linalg_paths("cpu", LINALG_EAGER).values()
            for nd in f.fgraph.toposort() if isinstance(nd.op, FusedElemwise)]


def op_calls(call, name):
    """Calls of the torch op ``name`` (``aten::...``) in one call, from a
    trace of its host side."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    return sum(e.count for e in prof.key_averages() if e.key == name)


def phase_linalg(dev, smi_line):
    """Phase 13: paths (a)-(c) of the linalg slice (``linalg_paths``), each
    captured, those of ``LINALG_EAGER`` with an eager twin:
    ``Plan.capturable``, K1's and K2's launches in one replayed call
    (counts set to 0 just before it), the replay's sha256 against the eager
    plan's from the same state; the
    values against float64 NumPy (``LINALG_TOL``): the GP's nmll, gradient
    and updates (``models/gp.py gp_reference``), the float64 mll, the
    Kalman log-likelihood and gradient (``numpy_kalman_loglike``, central
    differences) and its loop's update, the batched Cholesky's loss, L and
    gradient, each loop against as many calls of its step; each K1 node of
    the ``function()`` paths against its plain version at the path's
    shapes; Cholesky calls and kernels a step of path (c) (one batched call,
    not 128); then wall and device ms a call, captured (and eager, for the
    ``LINALG_EAGER`` paths), busy share, steps/s, kernels a call with the top
    ones by name.  Returns the
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
        eager = linalg_paths(dev, LINALG_EAGER)
    say(f"linalg paths linked for the card in {time.perf_counter() - t13:.2f} s: "
        + ", ".join(f"{tag} {type(p[0].linked).__name__}" for tag, p in paths.items()))
    launches, results = {}, {}
    for tag, (f, state, args, steps) in paths.items():
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
        d_cap, d_eager = digest(*res, *after), "(no eager twin)"
        if tag in eager:
            f_e, state_e = eager[tag][0], eager[tag][1]
            reset(state_e, init)
            res_e = outs(f_e(*a))
            d_eager = digest(*res_e, *values(state_e))
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

    # the times: captured and eager in turn, per call; a loop captured only
    for tag, (f, state, args, steps) in paths.items():
        a = results[tag][3]
        if tag in eager:
            f_e = eager[tag][0]
            row = captured_vs_eager(tag, lambda f=f, a=a: f(*a), lambda f=f_e, a=a: f(*a),
                                    [f.linked], 6, n_dev=2)
            c = row["captured"]
        else:
            wall = wall_ms(lambda f=f, a=a: f(*a), 2)
            dev_ms, by = device_ms(lambda f=f, a=a: f(*a), 1)
            c = {"wall": wall, "dev": dev_ms, "by": by}
            say(f"linked {tag}: captured wall {wall:.4f} ms/call, device {dev_ms:.4f} ms, busy "
                f"{dev_ms / wall:.3f} (no eager twin)")
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
    # functions (the longest sources) a library each dtype, the shape-parameter
    # gradients a library each dtype, the others in two
    def group(n):
        return 0 if n in cases.BESSEL_OPS else 1 if n in cases.GRAD_OPS else 2

    libs = [[one_node[n, d].k1 for n in sorted(cases.SPECIAL_GRIDS) if group(n) == g]
            for d in ("float32", "float64") for g in (0, 1, 2)]
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
    elif name in cases.GRAD_OPS:
        fin = np.isfinite(w)
        err = np.abs(gg[fin] - w[fin]) / np.maximum(1.0, np.abs(w[fin]))
        ok = err <= GRAD_ORACLE_RTOL
        worst = float(err.max(initial=0.0))
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
            # (the shape-parameter gradients are timed at 2**20 in float64,
            # ``special_grads``)
            if dtype != "float32" or name in cases.GRAD_OPS:
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
    grads_abs, launches["special gradients"] = special_grads(dev, smi_line, one_node)
    k1_abs = max(k1_abs, grads_abs)
    scalar_loop_on_the_card(dev)
    say(f"special phase done in {time.perf_counter() - t14:.1f} s")
    return launches, k1_abs, k2_abs, rows, prof


# --- 14, continued: the shape-parameter gradients and ScalarLoop -------------------

# the seven gradients' one-node K1 launches at GRAD_N elements in each float
# dtype, held against their plain versions on the card (SPECIAL_RTOL of
# max(1, |plain|), NaN and infinities where the plain version has them) and
# timed in float64 against their bound
GRAD_N = 2 ** 20
# their float64 oracle, scipy's central differences (step 1e-5 of the
# parameter), on phase 14's grids: 1e-8 of max(1, |oracle|), the
# differences' own error (~1e-11 of the function over the step, readings
# up to 3e-10 in the CPU tests)
GRAD_ORACLE_RTOL = 1e-8
# FP64-pipe instructions of one iteration of each gradient's loops
# (``grad_fp64_instructions``), set by say_builds; and phase 14's rows of
# the seven at GRAD_N, float64, for the kernels line
GRAD_FP64: dict = {}
GRAD_ROWS: dict = {}
GRAD_PATH_LAUNCHES: dict = {}
# the operands of each gradient's family
GRAD_NIN = {"betainc": 3, "gammainc": 2, "hyp2f1": 4}
# the for-form ScalarLoop at GRAD_N: 8 of Newton's steps to sqrt(c) from c,
# float64, on the card against the CPU (the same torch ops, each rounded
# alone: 1e-15 of max(1, |cpu|))
SCALAR_LOOP_STEPS, SCALAR_LOOP_RTOL = 8, 1e-15


def grad_fp64_instructions():
    """FP64-pipe instructions of one iteration of each gradient's loops
    (``special.GRAD_STEPS``: betainc's two fractions, gammainc's series and
    fraction, hyp2f1's series): each loop body alone in a probe kernel that
    loads its operands and duals from memory and stores the duals, read by
    ``cuobjdump -sass``, the least path through it (``sass_least``, which
    skips the divisions' slow paths) less that of the probe with no body.
    The set-up outside the loops (lgamma, digamma, exp, log) is left out:
    the count times the iterations is a floor of what a call executes."""
    from pytensor_tpu_torch.link.cuda import cexpr, special

    def probe(tag, body):
        return (f'extern "C" __global__ void probe_{tag}(const double* __restrict__ in, '
                f"double* __restrict__ out) {{\n  const int t = threadIdx.x;\n"
                f"  const double* a = in + 20 * t;\n  ks_dual d[4];\n"
                f"  for (int j = 0; j < 4; ++j)\n"
                f"    d[j] = {{a[4 + 4 * j], a[5 + 4 * j], a[6 + 4 * j] != 0.0, "
                f"a[7 + 4 * j] != 0.0}};\n  {body};\n"
                f"  for (int j = 0; j < 4; ++j) {{\n    out[20 * t + 4 * j] = d[j].v;\n"
                f"    out[20 * t + 4 * j + 1] = d[j].d;\n"
                f"    out[20 * t + 4 * j + 2] = d[j].z ? 1.0 : 0.0;\n"
                f"    out[20 * t + 4 * j + 3] = d[j].p ? 1.0 : 0.0;\n  }}\n}}\n")

    kernels, names = [probe("base", "(void)0")], ["probe_base"]
    for name, steps in special.GRAD_STEPS.items():
        for k, body in enumerate(steps):
            kernels.append(probe(f"{name}_{k}", body))
            names.append(f"probe_{name}_{k}")
    source = ("#include <cuda_runtime.h>\n#include <math.h>\n"
              + cexpr.helpers("ks_betainc_dda(", have=()) + "".join(kernels))
    code = sass_code(source)
    least = {n: sass_least(next(v for k, v in code.items() if k.endswith(n)), is_fp64)
             for n in names}
    got = {}
    for name, steps in special.GRAD_STEPS.items():
        per = [least[f"probe_{name}_{k}"] - least["probe_base"] for k in range(len(steps))]
        if min(per) <= 0:
            raise AssertionError(f"the gradients' FP64 probe, {name}: {per} a loop body")
        got[name] = sum(per)
    return got


def grad_bound(name, n, n_bytes):
    """(ms, by) of a gradient at ``n`` elements: the larger of its bytes at
    HBM_BYTES_S and its loops' FP64-pipe instructions (``GRAD_FP64``, an
    iteration of each loop, times the iterations) at FP64_LANES lanes an
    SM a clock."""
    from pytensor_tpu_torch.link.cuda import special

    iters = special.GRAD_ITERATIONS[special.GRAD_FAMILY[name]]
    t_ops = n * GRAD_FP64[name] * iters / (SM_CLOCKS_S * FP64_LANES)
    t_bytes = n_bytes / HBM_BYTES_S
    return (t_bytes * 1e3, "bytes") if t_bytes >= t_ops else (t_ops * 1e3, "operations")


def special_grads(dev, smi_line, one_node):
    """Phase 14's shape-parameter gradients at GRAD_N: each as a one-node
    K1 launch in float64 and float32 on its grid (``cases.SPECIAL_GRIDS``)
    against its plain version on the card (reverse-mode autograd in
    float64), and in float64 timed by CUDA events after an L2 flush beside
    the plain version and its bound; then this phase's path of the four
    that phase 20's does not run (``grads_path``).  Rows into
    ``GRAD_ROWS``; returns the largest absolute error and the path's
    launches."""
    import torch

    from pytensor_tpu_torch.link.cuda import cases
    from pytensor_tpu_torch.link.torch.convert import as_torch

    rng = np.random.default_rng(20)
    worst_abs = 0.0
    held = {}
    for name in cases.GRAD_OPS:
        grids = cases.SPECIAL_GRIDS[name]
        vals = [rng.uniform(*g, size=GRAD_N) for g in grids]
        for dtype in ("float64", "float32"):
            fn = one_node[name, dtype]
            args = [as_torch(v.astype(dtype), dev) for v in vals]
            got = fn.k1.launch(*args)[0]
            # the plain version once (seconds a call), timed by CUDA events
            torch.cuda.synchronize()
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            plain = fn.k1.plain(*args)[0]
            end.record()
            torch.cuda.synchronize()
            plain_ms = start.elapsed_time(end)
            g, p = got.double().cpu().numpy(), plain.double().cpu().numpy()
            if not (np.array_equal(np.isnan(g), np.isnan(p))
                    and np.array_equal(g[np.isinf(p)], p[np.isinf(p)])
                    and not np.isinf(g[~np.isinf(p)]).any()):
                raise AssertionError(f"phase 14 {name} {dtype} at {GRAD_N}: NaN or inf where the "
                                     f"plain version has none")
            fin = np.isfinite(p)
            diff = np.abs(g[fin] - p[fin])
            err = float((diff / np.maximum(1.0, np.abs(p[fin]))).max(initial=0.0))
            if not err <= SPECIAL_RTOL[dtype]:
                raise AssertionError(f"phase 14 {name} {dtype} at {GRAD_N}: rel err {err} against "
                                     f"the plain version > {SPECIAL_RTOL[dtype]}")
            if dtype == "float32":
                say(f"  gradient {name:13s} float32 at 2**20: max err vs plain {err:.2e} (tol "
                    f"{SPECIAL_RTOL[dtype]:g})")
                continue
            worst_abs = max(worst_abs, float(diff.max(initial=0.0)))
            held[name] = (args, got)
            ms = stream_ms(lambda: fn.k1.launch(*args), 10)
            b_ms, b_by = grad_bound(name, GRAD_N, nbytes(*args, got))
            GRAD_ROWS[name] = {"ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms,
                               "bound_by": b_by, "max_abs_err": float(diff.max(initial=0.0)),
                               "max_rel_err": err}
            say(f"  gradient {name:13s} float64 at 2**20 ({smi_line}): K1 {ms * 1e3:.1f} us, plain "
                f"{plain_ms * 1e3:.1f} us (reverse-mode autograd, one call), bound "
                f"{b_ms * 1e3:.1f} us "
                f"({b_by}; {GRAD_FP64[name]} FP64-pipe instructions an iteration); max err vs "
                f"plain {err:.2e} (tol {SPECIAL_RTOL[dtype]:g}); library: none")
            within_bound(f"gradient {name}", GRAD_ROWS[name])
            del args, got, plain
    say(f"shape-parameter gradients: {len(cases.GRAD_OPS)} device functions at 2**20 in float32 "
        f"and float64 against their plain versions on the card, largest abs err {worst_abs:.2e}")
    return worst_abs, grads_path(dev, held, one_node)


# the device functions of phase 14's path (phase 20's runs the other three)
GRADS_PATH_OPS = ("gammainc_ddk", "hyp2f1_dda", "hyp2f1_ddb", "hyp2f1_ddc")


def grads_path(dev, held, one_node):
    """Phase 14's path through ``function()``: the gradient of
    sum(hyp2f1(a, b, c, z)) in a, b and c and of sum(gammainc(k, x)) in k,
    at GRAD_N float64 on the inputs ``hyp2f1_dda``'s and ``gammainc_ddk``'s
    one-node launches were held on (``held``: {name: (inputs, output)}),
    one captured CUDA graph of K1 launches.  The counts are set to 0 just
    before a replayed call and read after it: each device function of
    GRADS_PATH_OPS must have been launched; the outputs (the gradients,
    times the sum's ones) are the one-node launches' (``one_node``) bit for
    bit.  Returns the path's launches, and
    puts the launches by device function into ``GRAD_PATH_LAUNCHES``."""
    import torch

    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.tensor import fused_kernel

    a, b, c, z, k, x = (pt.dvector(n) for n in "abczkx")
    outs = [*ptt.grad(pt.sum(pt.hyp2f1(a, b, c, z)), [a, b, c]),
            ptt.grad(pt.sum(pt.gammainc(k, x)), k)]
    f = ptt.function([a, b, c, z, k, x], outs, device=dev)
    plan = getattr(f.linked, "plan", f.linked)
    if not isinstance(f.linked, CapturedFunction) or plan.host_reads:
        raise AssertionError(f"the gradients' path: not one captured graph: {plan.host_reads}")
    args = [*held["hyp2f1_dda"][0], *held["gammainc_ddk"][0]]
    f(*args)
    torch.cuda.synchronize()
    fused_kernel.LAUNCHES = 0
    fused_kernel.OP_LAUNCHES.clear()
    got = f(*args)
    torch.cuda.synchronize()
    launches = {"fused_elemwise": fused_kernel.LAUNCHES, "scan_whole_loop": 0}
    GRAD_PATH_LAUNCHES.update({name: fused_kernel.OP_LAUNCHES[name] for name in GRADS_PATH_OPS})
    if min(GRAD_PATH_LAUNCHES.values()) < 1:
        raise AssertionError(f"the gradients' path: launches {GRAD_PATH_LAUNCHES}")
    for name, g in zip(("hyp2f1_dda", "hyp2f1_ddb", "hyp2f1_ddc", "gammainc_ddk"), got):
        family = "gammainc_ddk" if name == "gammainc_ddk" else "hyp2f1_dda"
        if not torch.equal(g, one_node[name, "float64"].k1.launch(*held[family][0])[0]):
            raise AssertionError(f"the gradients' path, {name}: not the one-node launch's bits")
    say(f"the gradients' path (hyp2f1's in a, b, c and gammainc's in k at 2**20, one captured "
        f"graph): a replayed call launched K1 {launches['fused_elemwise']} times, "
        + ", ".join(f"{k} {v}" for k, v in GRAD_PATH_LAUNCHES.items())
        + "; its outputs the one-node launches' bits")
    return launches


def scalar_loop_on_the_card(dev):
    """A for-form ScalarLoop (SCALAR_LOOP_STEPS of Newton's square root) at
    GRAD_N through ``function()`` on the card, captured, against the same
    function on the CPU."""
    import torch

    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.scalar.loop import ScalarLoop

    st, cc = pt.dscalar("st"), pt.dscalar("cc")
    loop = ScalarLoop([st], [0.5 * (st + cc / st)], [cc], name="newton_sqrt")
    c = pt.dvector("c")
    out = loop(SCALAR_LOOP_STEPS, c, c)
    cv = np.random.default_rng(21).uniform(0.5, 4.0, GRAD_N)
    f, f_cpu = (ptt.function([c], out, device=d) for d in (dev, "cpu"))
    plan = getattr(f.linked, "plan", f.linked)
    if plan.host_reads or not isinstance(f.linked, CapturedFunction):
        raise AssertionError(f"the for-form ScalarLoop: not captured: {plan.host_reads}")
    want = np.asarray(f_cpu(cv))
    cv_d = as_torch(cv, dev)
    f(cv_d)
    got = f(cv_d)
    torch.cuda.synchronize()
    err = rel_err(got.cpu().numpy(), want)
    if not err <= SCALAR_LOOP_RTOL or not np.allclose(want, np.sqrt(cv), rtol=1e-12):
        raise AssertionError(f"ScalarLoop on the card: rel err {err} against the CPU")
    ms = wall_ms(lambda: f(cv_d), 5)
    say(f"ScalarLoop (for form, {SCALAR_LOOP_STEPS} Newton steps to sqrt) at 2**20 float64, "
        f"captured: rel err vs the CPU {err:.2e} (tol {SCALAR_LOOP_RTOL:g}); wall {ms:.4f} ms a "
        f"call")


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


def hmc_functions(dev):
    """The three HMC entry points of ``models/hmc.py`` at the radon model's
    full width (919 observations, 85 counties, 16 leapfrog steps of 0.02;
    256 chains), linked for ``dev``."""
    import pytensor_tpu_torch.models.hmc as hmc

    kw = dict(n_obs=N_OBS, n_counties=N_COUNTIES, n_leapfrog=HMC_STEPS, step_size=HMC_EPS,
              device=dev)
    return {"hmc 1 chain": hmc.make_radon_hmc(**kw),
            "hmc 256 chains": hmc.make_radon_hmc_chains(n_chains=HMC_CHAINS, **kw),
            "multinomial hmc": hmc.make_radon_multinomial_hmc(**kw)}


def hmc_cpu_reference(cpu_fns=None):
    """Phase 18's reference: the first HMC_HELD transitions of each HMC path
    linked for the CPU (``hmc_functions("cpu")`` unless given), in the
    references' process beside phases 3-17.  Returns ({path: [outputs and
    position, a transition]}, seconds)."""
    import torch

    t0 = time.perf_counter()
    if cpu_fns is None:
        torch.set_num_threads(REF_THREADS)
        cpu_fns = hmc_functions("cpu")
    # numpy arrays, which a pool's pipe carries by value
    ref = {path: [[o.numpy().copy() for o in g()] + [g_pos.get_value().numpy().copy()]
                  for _ in range(HMC_HELD)]
           for path, (g, g_pos, *_) in cpu_fns.items()}
    return ref, time.perf_counter() - t0


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
    width, with the default flags: each call one
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
    # (``hmc_cpu_reference``: ``cpu_fns`` is the job computing them in the
    # references' process, or, in a rehearsal, the CPU functions)
    t0 = time.perf_counter()
    ref, ref_s = hmc_cpu_reference(cpu_fns) if isinstance(cpu_fns, dict) else cpu_fns.get()
    say(f"phase 18: the CPU's {HMC_HELD} transitions of each HMC path in {ref_s:.1f} s (waited "
        f"{time.perf_counter() - t0:.1f} s for them)")
    launches, k1_abs, k1_nodes = {}, 0.0, 0
    # not again under scan__pallas, which gives the same rows: K2 refuses
    # the leapfrog scans, as the verdicts say
    flags = "default flags"
    t0 = time.perf_counter()
    fns = hmc_functions(dev)
    say(f"phase 18: the HMC functions linked for {dev} with {flags} in "
        f"{time.perf_counter() - t0:.1f} s")
    for path, (f, pos, *_) in fns.items():
        tag = f"{path}, {flags}"
        plan = getattr(f.linked, "plan", f.linked)
        if plan.host_reads:
            raise AssertionError(f"{tag}: host reads {plan.host_reads}")
        for step in range(HMC_HELD):
            out = [o.cpu() for o in f()] + [pos.get_value().cpu()]
            want = [torch.as_tensor(w) for w in ref[path][step]]
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
        say(f"{tag}: launches in one replayed call (counts set to 0 just before it) "
            f"{launches[tag]}; {'; '.join(verdicts)}; the first {HMC_HELD} transitions "
            f"held against the CPU (accepts/indices equal, logp and position within "
            f"{HMC_RTOL:g})")
        row = {"launches": launches[tag], "k2": verdicts}
        if on_card:
            ms = wall_ms(f, 50)
            per = HMC_CHAINS if path == "hmc 256 chains" else 1
            row.update(ms=ms, transitions_s=per * 1e3 / ms)
            dev_ms, by = device_ms(f, 10)
            row.update(device_ms=dev_ms, busy=dev_ms / ms,
                       kernels_a_call=sum(c for _, c in by.values()))
            tfr = [(k_ms, c) for kn, (k_ms, c) in by.items() if "threefry" in kn]
            row["threefry_device_us"] = sum(k for k, _ in tfr) * 1e3
            say(f"  {tag}: {ms:.3f} ms a transition (wall, CUDA events over 50 calls), "
                f"{row['transitions_s']:,.0f} {'chain-' if per > 1 else ''}transitions/s; "
                f"device {row['device_ms']:.3f} ms a call, busy {row['busy']:.2f}, "
                f"{row['kernels_a_call']:.0f} kernels a call, threefry "
                f"{row['threefry_device_us']:.1f} us of it ({smi_line})")
        rows["hmc"][tag] = row
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
           # (the plain loops take ~0.2 s a call at 2**20: one call each, warm)
           "plain_ms": device_ms(lambda: mod.plain(key, *args, *extra, split=psplit), 1,
                                 warmup=0)[0],
           "plain_wall_ms": wall_ms(lambda: mod.plain(key, *args, *extra, split=psplit), 1,
                                    warmup=0),
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


def phase_loops(dev, smi_line, parent=None):
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
    FP64 pipe's, ``gamma_fp64_ms``).  (f) With ``parent`` (a checkout), its
    gamma, Poisson
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
    normal probe, the FP64 probe, the three loop kernels and gamma with
    ``-fmad=false``."""
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
            "gradients' fp64 probe": pool.submit(grad_fp64_instructions)}


def loop_build_logs(build_s):
    """The build logs of ``loop_builds``' jobs."""
    from pytensor_tpu_torch.link.cuda import (
        binomial_kernel,
        gamma_kernel,
        poisson_kernel,
        threefry_kernel,
    )

    return {"threefry": threefry_kernel.BUILD_LOG, "gamma": gamma_kernel.BUILD_LOG,
            "poisson": poisson_kernel.BUILD_LOG, "binomial": binomial_kernel.BUILD_LOG}


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
    # the shape-parameter gradients' loops, for their bounds in phase 14
    GRAD_FP64.update(build_s.pop("gradients' fp64 probe"))
    say("the shape-parameter gradients' loops (cuobjdump -sass of their templates at 2 and 3 "
        "iterations): FP64-pipe instructions an iteration "
        + ", ".join(f"{k} {v}" for k, v in GRAD_FP64.items()) + f", at {FP64_LANES} lanes an SM "
        "a clock")
    # gamma's float64 work, for its bound in phase 19
    GAMMA_FP64.update(build_s.pop("fp64 probe"))
    say("gamma's float64 work (cuobjdump -sass of FP64_PROBE; every branch of erfinv, log and "
        "pow): FP64-pipe instructions " + ", ".join(f"{k} {v}" for k, v in GAMMA_FP64.items())
        + f", at {FP64_LANES} lanes an SM a clock")


# --- 20. a censored-likelihood gradient (models/censored.py) ----------------------

# PyMC's right-censored Gamma term and a Beta log-CDF term at 2**20 float64
# elements each, and the gradient in (k, theta, a, b): data from seed 20
CENSORED_SEED = 20
# against the same graph through the port's plain versions on the CPU:
# logp and each gradient within 1e-9 of its magnitude (the device functions
# are within 5e-9 of their plain versions an element, the sums of 2**20
# terms run in other orders); against scipy's central differences of logp
# (step 1e-5 of the parameter; their own error ~1e-11 of |logp| over the
# step): 1e-6
CENSORED_TOL = {"cpu": 1e-9, "differences": 1e-6}
# replays a call of the counted run
CENSORED_CALLS = 3
# the CPU threads of the process that computes phase 18's and 20's
# references beside the other phases (the host has 8 cores)
REF_THREADS = 4
# the device functions the path must launch
CENSORED_GRADS = ("gammaincc_ddk", "betainc_dda", "betainc_ddb")


def censored_cpu_reference(seed):
    """Phase 20's references, computed in a process of their own while the
    card runs phases 3-19 (some two minutes of the host's CPU): the
    function linked for the CPU (the port's plain versions) on the data
    of ``seed``, and scipy's logp with its central differences.  Returns
    (outputs, seconds, (logp, gradients), seconds)."""
    import torch

    from pytensor_tpu_torch.models import censored

    torch.set_num_threads(REF_THREADS)
    t, y = censored.censored_data(censored.CENSORED_N, seed)
    t0 = time.perf_counter()
    f_cpu = censored.make_censored_logp(device="cpu")
    want = [float(np.asarray(o)) for o in f_cpu(t, y, *[np.asarray(p) for p in censored.PARAMS])]
    t1 = time.perf_counter()
    ref = censored.censored_reference(t, y)
    return want, t1 - t0, ref, time.perf_counter() - t1


def start_references():
    """The host's references that need no card, in a spawned process of
    their own beside phases 3-19: phase 18's HMC transitions on the CPU
    (``hmc_cpu_reference``) and phase 20's (``censored_cpu_reference``).
    Returns (the pool, the HMC job, (the pool, the censored job)); the
    pool is terminated when the script exits, however it exits."""
    pool = multiprocessing.get_context("spawn").Pool(1)
    atexit.register(pool.join)
    atexit.register(pool.terminate)
    hmc = pool.apply_async(hmc_cpu_reference)
    return pool, hmc, (pool, pool.apply_async(censored_cpu_reference, (CENSORED_SEED,)))


def censored_kernels(dev):
    """The K1 kernels of phase 20, for the build pool of phase 2: the
    function's fused nodes and its special functions' one-node kernels,
    made from the function linked for the CPU (the same graph, so the same
    sources; phase 20 runs that function as the card's reference).
    Returns (the kernels, the CPU function)."""
    from pytensor_tpu_torch.link.torch.dispatch import _one_node_k1
    from pytensor_tpu_torch.models import censored
    from pytensor_tpu_torch.tensor.elemwise import Elemwise

    f_cpu = censored.make_censored_logp(device="cpu")
    kerns = plan_kernels(f_cpu.linked, dev, {})
    for nd in f_cpu.fgraph.toposort():
        if isinstance(nd.op, Elemwise) and nd.op.scalar_op.special:
            k = _one_node_k1(nd.op, nd, dev).k1
            kerns.setdefault(k.key, k)
    return list(kerns.values()), f_cpu


def phase_censored(dev, smi_line, reference):
    """Phase 20: ``models/censored.py``'s logp and its gradient in (k,
    theta, a, b) at 2**20 survival times and 2**20 proportions, float64,
    linked by ``function()`` for the card as one captured CUDA graph: the
    main path of the shape-parameter gradients.  The counts are set to 0,
    the function replayed CENSORED_CALLS times and the counts read: K1
    launches and the launches of the kernels holding each of
    CENSORED_GRADS.  Held against the same graph through the plain
    versions on the CPU at full size and against scipy's central
    differences; each K1 node against its plain version on the inputs the
    graph gives it; wall and device ms a call, kernels by name.  Returns
    ({"censored": launches}, K1's largest absolute error, the row)."""
    import torch

    from pytensor_tpu_torch.graph.basic import Constant
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.link.torch.dispatch import _one_node_k1
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction, fgraph_to_torch
    from pytensor_tpu_torch.models import censored
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.elemwise import Elemwise
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    t20 = time.perf_counter()
    t, y = censored.censored_data(censored.CENSORED_N, CENSORED_SEED)
    params = [np.asarray(p) for p in censored.PARAMS]
    f = censored.make_censored_logp(device=dev)
    plan = getattr(f.linked, "plan", f.linked)
    if not isinstance(f.linked, CapturedFunction) or plan.host_reads:
        raise AssertionError(f"censored logp: not one captured graph: "
                             f"{type(f.linked).__name__}, {plan.host_reads}")
    args = [as_torch(v, dev) for v in (t, y, *params)]
    f(*args)
    # the main path: counts to 0, the replays, the counts
    torch.cuda.synchronize()
    fused_kernel.LAUNCHES = 0
    fused_kernel.OP_LAUNCHES.clear()
    for _ in range(CENSORED_CALLS):
        out = f(*args)
    torch.cuda.synchronize()
    launches = {"fused_elemwise": fused_kernel.LAUNCHES, "scan_whole_loop": 0}
    by_grad = {name: fused_kernel.OP_LAUNCHES[name] for name in CENSORED_GRADS}
    if min(by_grad.values()) < CENSORED_CALLS:
        raise AssertionError(f"censored logp: the gradients' kernels were launched {by_grad} "
                             f"times in {CENSORED_CALLS} calls")
    got = [float(o.cpu()) for o in out]
    if not all(np.isfinite(got)):
        raise AssertionError(f"censored logp: {got}")
    say(f"censored logp at 2**20 + 2**20 float64, one captured graph: {CENSORED_CALLS} replayed "
        f"calls launched K1 {launches['fused_elemwise']} times, the kernels holding "
        + ", ".join(f"{k} {v}" for k, v in by_grad.items()))
    # against the plain versions on the CPU at full size, and scipy's central
    # differences of logp (``censored_cpu_reference``, run beside phases 3-19)
    t_ref = time.perf_counter()
    pool, job = reference
    want, cpu_s, (logp_ref, grads_ref), diff_s = job.get()
    pool.close()
    pool.join()
    say(f"censored references: waited {time.perf_counter() - t_ref:.1f} s for them")
    e_cpu = [abs(g - w) / max(1.0, abs(w)) for g, w in zip(got, want)]
    e_diff = [abs(g - w) / max(1.0, abs(w)) for g, w in zip(got, [logp_ref, *grads_ref])]
    names = ("logp", "dk", "dtheta", "da", "db")
    say(f"censored logp: " + ", ".join(f"{n} {g:.10g}" for n, g in zip(names, got))
        + f"; rel err vs the CPU's plain versions {max(e_cpu):.2e} (tol {CENSORED_TOL['cpu']:g}, "
        f"{cpu_s:.1f} s), vs scipy and its central differences {max(e_diff):.2e} (tol "
        f"{CENSORED_TOL['differences']:g}, {diff_s:.1f} s)")
    if not (max(e_cpu) <= CENSORED_TOL["cpu"] and max(e_diff) <= CENSORED_TOL["differences"]):
        raise AssertionError(f"censored logp: {dict(zip(names, got))} against the CPU "
                             f"{dict(zip(names, want))}, scipy "
                             f"{dict(zip(names, [logp_ref, *grads_ref]))}")
    # each K1 node against its plain version, on the inputs the graph gives it
    k1_nodes = [nd for nd in f.fgraph.toposort() if isinstance(nd.op, FusedElemwise)
                or (isinstance(nd.op, Elemwise) and nd.op.scalar_op.special)]
    # (a one-node kernel takes its node's inputs but the constants, its literals)
    needed = [i for nd in k1_nodes for i in nd.inputs if not isinstance(i, Constant)]
    feed = fgraph_to_torch(FunctionGraph(f.fgraph.inputs, needed, clone=True), dev)
    values = iter(feed(*args))
    k1_abs = 0.0
    for nd in k1_nodes:
        xs = [next(values) for i in nd.inputs if not isinstance(i, Constant)]
        if isinstance(nd.op, FusedElemwise):
            kern = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
            ops = [m.op.scalar_op.name for m in nd.op.fgraph.toposort()]
        else:
            kern = _one_node_k1(nd.op, nd, dev).k1
            ops = [nd.op.scalar_op.name]
        g_, w_ = kern.launch(*xs), kern.plain(*xs)
        torch.cuda.synchronize()
        node_err = 0.0
        for a, b in zip(g_, w_):
            a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
            if not np.array_equal(np.isnan(a), np.isnan(b)):
                raise AssertionError(f"censored K1 {ops}: NaN where the plain version has none")
            fin = np.isfinite(b)
            diff = np.abs(a[fin] - b[fin])
            err = float((diff / np.maximum(1.0, np.abs(b[fin]))).max(initial=0.0))
            if not err <= SPECIAL_RTOL["float64"]:
                raise AssertionError(f"censored K1 {ops}: rel err {err} > "
                                     f"{SPECIAL_RTOL['float64']}")
            k1_abs = max(k1_abs, float(diff.max(initial=0.0)))
            node_err = max(node_err, err)
        say(f"  censored K1 node {'fused' if isinstance(nd.op, FusedElemwise) else 'one-node'}: "
            f"ops {ops}, inputs {[tuple(x.shape) for x in xs]}, max err vs plain "
            f"{node_err:.2e} (tol {SPECIAL_RTOL['float64']:g})")
    # the times
    wall = wall_ms(lambda: f(*args), 10)
    dev_ms, by = device_ms(lambda: f(*args), 3)
    n_kern = sum(n for _, n in by.values())
    row = {"wall_ms": wall, "device_ms": dev_ms, "kernels": n_kern, "launches": launches,
           "by_grad": by_grad, "rel_err_cpu": max(e_cpu), "rel_err_differences": max(e_diff)}
    say(f"censored logp+grad ({smi_line}): wall {wall:.4f} ms/call, device {dev_ms:.4f} ms, busy "
        f"{dev_ms / wall:.3f}, {n_kern:.0f} kernels a call")
    for kname, (ms, count) in sorted(by.items(), key=lambda kv: -kv[1][0])[:8]:
        say(f"  censored: {ms:.4f} ms/call  {count:.0f} launches/call  {kname[:90]}")
    say(f"censored phase done in {time.perf_counter() - t20:.1f} s")
    return {"censored": launches}, k1_abs, row


# --- phase 21: while-scans -------------------------------------------------------------

# the converged power iteration: benchsuite.py:160's matrix, start and step
# as a while-scan of at most POWER_STEPS steps, whose tolerance fires after
# step POWER_EXIT of the float64 loop (power.choose_tol: the geometric mean
# of its differences after steps POWER_EXIT - 1 and POWER_EXIT)
POWER_STEPS, POWER_EXIT = 64, 16
# the iterates against the plain SpMV step loop on the card (the rows add in
# another order: ~1e-7 a step) and against float64 scipy; the gradient's
# error against torch's autograd of the plain loop in float64 on the card,
# over its largest magnitude, within four times the float32 plain loop's own
# (autograd's) plus 1e-6: the normalisation's gradient cancels, and at
# 4,096 rows on the CPU the graph's gradient is 4.2e-6 off, autograd's
# 2.0e-6, in other orders of the same float32 operations
POWER_TOL = {"plain": 1e-6, "float64": 1e-5, "grad": 1e-6}
POWER_CALLS = 10
# the condition's read a step: alternated calls of the while-scan and of
# the for-scan that computes and traces the same test, at least this many
# pairs and at most this many seconds (alternated_ms)
POWER_PAIRS = (20, 3.0)
# the divergence-stopped radon trajectory: float64, at most TRAJ_STEPS
# leapfrog steps of each size, stopped after the first at which |H - H0| >
# models/radon.py MAX_DH; at the first size the energy diverges on the way
# (the CPU's exit step 49, the same from starts moved by 1e-14; at 0.02 it
# crossed 1,000 slowly, at step 870 on the CPU and never on the card), at
# the second never (|H - H0| at most ~150 on the CPU).  The trajectory
# amplifies rounding (starts 1e-14 apart end ~5 apart after 1,024 steps of
# 0.01), so the while- and for-scans are held with torch's deterministic
# algorithms: the float64 gradient's scatter-add (index_add_) then adds in
# a fixed order, and the two give the same bits; timed without them
TRAJ_STEPS = 1024
TRAJ_EPS = {"fires": 0.022, "never": 0.01}
TRAJ_SEED = 1
# a call with torch's defaults against the held rows: within rtol of
# max(1, |row|) over the first `steps` steps (on the CPU a start moved by
# 1e-15 moves the rows by at most 6.9e-11 in the 49 steps of 0.022 and
# 2.2e-11 in the first 200 of 0.01); past them rounding alone parts the
# trajectories (by 0.9 at step 1,024 of 0.01), and the rows are held by
# the energy's test: the same exit step and |H - H0| <= MAX_DH before it
TRAJ_DEFAULT = {"rtol": 1e-8, "steps": 200}


def while_setup():
    """The power iteration's matrix, start and tolerance (phase 2 builds
    its kernels from them, phase 21 runs them): ``(A, x0, the float64
    loop's differences, tol, margin)``."""
    from pytensor_tpu_torch.models.power import choose_tol, power_matrix, power_reference

    A, x0 = power_matrix(SPARSE_N, SPARSE_NNZ_ROW, seed=0)  # benchsuite.py's SUITE_SEED
    diffs = power_reference(A, x0, POWER_STEPS)
    tol, margin = choose_tol(diffs, POWER_EXIT)
    return A, x0, diffs, tol, margin


def while_functions(setup, dev):
    """Phase 21's functions on ``dev``: the power iteration's (while and
    for, ``make_power_functions``) and the radon trajectory's (while and
    for, ``make_radon_trajectory``: the step size and count are inputs).
    The for-scans compute and trace the while-scans' test a step; they are
    linked eager, like the while-scans, and without the scan rewrites,
    which a while-scan refuses (pushed out of the loop, a step's
    subexpression would run as a K1 node, whose rounding is not torch's),
    so that both run the same step."""
    from pytensor_tpu_torch.compile.mode import get_mode
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.models.power import make_power_functions
    from pytensor_tpu_torch.models.radon import make_radon_trajectory

    A, _, _, tol, _ = setup
    same_step = get_mode(None).excluding("scan")
    fns = {"power": make_power_functions(A, tol, POWER_STEPS, device=dev)}
    with config.change_flags(xla__jit=False):
        fns["power for"] = make_power_functions(A, tol, POWER_EXIT, False, same_step,
                                                device=dev)
        fns["radon"] = make_radon_trajectory(True, N_OBS, N_COUNTIES, device=dev)
        fns["radon for"] = make_radon_trajectory(False, N_OBS, N_COUNTIES, same_step,
                                                 device=dev)
    return fns


def while_kernels(dev, setup):
    """The K1 kernels of phase 21's functions, for phase 2's pool: made
    from the functions linked for the CPU (the same graphs; a scan's inner
    graph fuses nothing, so only the outer graphs' nodes)."""
    kerns: dict = {}
    for fs in while_functions(setup, "cpu").values():
        for f in (fs if isinstance(fs, tuple) else (fs,)):
            plan_kernels(f.linked, dev, kerns)
    return list(kerns.values())


def k1_nodes_held(f, args, dev, tag, quiet=False):
    """Each K1 node of ``f``'s graph against its plain version, on the
    inputs the graph gives it (``SPECIAL_RTOL`` of its dtype); returns the
    largest absolute error.  ``quiet`` prints no line a node."""
    import torch

    from pytensor_tpu_torch.graph.basic import Constant
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    nodes = [nd for nd in f.fgraph.toposort() if isinstance(nd.op, FusedElemwise)]
    if not nodes or dev.type != "cuda":  # (a rehearsal on the CPU has no kernel)
        return 0.0
    needed = [i for nd in nodes for i in nd.inputs if not isinstance(i, Constant)]
    values = iter(fgraph_to_torch(FunctionGraph(f.fgraph.inputs, needed, clone=True), dev)(*args))
    worst = 0.0
    for nd in nodes:
        xs = [next(values) for i in nd.inputs if not isinstance(i, Constant)]
        kern = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
        got, want = kern.launch(*xs), kern.plain(*xs)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            # an integer or bool output is exact
            rtol = SPECIAL_RTOL.get(str(b.dtype).replace("torch.", ""), 0.0)
            a, b = a.double().cpu().numpy(), b.double().cpu().numpy()
            with np.errstate(invalid="ignore"):
                # equal infinities agree, and NaN with NaN
                diff = np.where((a == b) | (np.isnan(a) & np.isnan(b)), 0.0, np.abs(a - b))
            err = float((diff / np.maximum(1.0, np.abs(b))).max(initial=0.0))
            if not (np.array_equal(np.isnan(a), np.isnan(b)) and err <= rtol):
                raise AssertionError(f"{tag} K1 node {nd}: rel err {err} > {rtol}")
            worst = max(worst, float(np.nan_to_num(diff).max(initial=0.0)))
        if not quiet:
            say(f"  {tag} K1 node: ops {[m.op.scalar_op.name for m in nd.op.fgraph.toposort()]}, "
                f"inputs {[tuple(x.shape) for x in xs]}, held against plain")
    return worst


def phase_while(dev, smi_line, setup):
    """Phase 21: while-scans.  (a) The converged power iteration at
    ``benchsuite.py:160``'s size, through ``scan`` with ``until`` and
    ``function()`` (eager: the step loop reads its condition after each
    step): the counts set to 0 before one call of the iterates' function
    and one of the gradient's, and read after (K4 once a forward step, and
    on Aᵀ once a reverse step, over the executed steps only); the exit step
    against the float64 loop's, the iterates against the plain SpMV step
    loop on the card and float64 scipy, the gradient against torch's
    autograd of the plain loop.  (b) The radon trajectory, float64, at each
    ``TRAJ_EPS``: its exit step, its rows against the same steps as an
    eager for-scan, the divergence test against the energies.  Each
    path's K1 nodes against their plain version; each step's cost with the
    condition's read against the step of a for-scan that computes the same
    test.  Returns ({path: launches},
    {path: K4 launches}, K1's largest absolute error, the row)."""
    import torch

    from pytensor_tpu_torch.link.cuda import scan_kernel, spmv_kernel
    from pytensor_tpu_torch.link.torch.convert import sparse_as_torch
    from pytensor_tpu_torch.models.radon import radon_logp_dlogp_reference, theta_start
    from pytensor_tpu_torch.tensor import fused_kernel

    t21 = time.perf_counter()
    cuda = dev.type == "cuda"
    A, x0, diffs, tol, margin = setup
    n = A.shape[0]
    t0 = time.perf_counter()
    fns = while_functions(setup, dev)
    f, fg = fns["power"]
    f_for, _ = fns["power for"]
    say(f"while-scan functions built in {time.perf_counter() - t0:.2f} s; the power iteration's "
        f"plan: {[type(nd.op).__name__ for nd in f.fgraph.toposort()]}, host reads "
        f"{f.linked.host_reads}")

    def reset():
        if cuda:
            torch.cuda.synchronize()
        fused_kernel.LAUNCHES = spmv_kernel.LAUNCHES = scan_kernel.LAUNCHES = 0

    def counts():
        if cuda:
            torch.cuda.synchronize()
        return {"spmv_csr": spmv_kernel.LAUNCHES, "fused_elemwise": fused_kernel.LAUNCHES,
                "scan_whole_loop": scan_kernel.LAUNCHES}

    # (a) the converged power iteration ------------------------------------------
    say(f"converged power iteration: {n:,}² CSR, {A.nnz:,} nonzeros, float32, at most "
        f"{POWER_STEPS} steps; tol {tol:.6g}, from the float64 loop's max|x_new - x| after steps "
        f"{POWER_EXIT - 1} and {POWER_EXIT} ({diffs[POWER_EXIT - 2]:.6g}, "
        f"{diffs[POWER_EXIT - 1]:.6g}: a margin of {margin:.3f} on either side)")
    x0_d = torch.from_numpy(x0).to(dev)
    w = np.random.default_rng(TRAJ_SEED).standard_normal((n, 1)).astype("float32")
    w_d = torch.from_numpy(w).to(dev)
    reset()
    (xs,) = f(x0_d)
    fwd = counts()
    steps = int(xs.shape[0])
    reset()
    last, g = fg(x0_d, w_d)
    bwd = counts()
    say(f"converged power iteration: exit after step {steps} of {POWER_STEPS} (the float64 "
        f"loop's: {POWER_EXIT}); launches of one call of the iterates' function {fwd}, of one "
        f"call of the gradient's {bwd}")
    if steps != POWER_EXIT:
        raise AssertionError(f"power iteration: exit after step {steps}, not {POWER_EXIT}")
    if cuda and (fwd["spmv_csr"] != steps or bwd["spmv_csr"] != 2 * steps):
        raise AssertionError(f"power iteration: K4 launched {fwd['spmv_csr']} and "
                             f"{bwd['spmv_csr']} times, not {steps} and {2 * steps}")
    # the plain SpMV step loop on the card, and float64 scipy
    c = sparse_as_torch(A, dev)

    def plain_loop(x, n_steps, stop, data=c.data):
        rows = []
        for _ in range(n_steps):
            y = spmv_kernel.plain(c.indptr, c.indices, data, x.reshape(-1)).reshape(n, 1)
            x_new = y / (y.abs().max() + 1e-9)
            rows.append(x_new)
            done = stop and bool((x_new - x).abs().max() < np.float32(tol))
            x = x_new
            if done:
                break
        return torch.stack(rows)

    plain_xs = plain_loop(x0_d, POWER_STEPS, True)
    if plain_xs.shape != xs.shape:
        raise AssertionError(f"power iteration: the plain loop ran {plain_xs.shape[0]} steps, "
                             f"the while-scan {steps}")
    e_plain = float((xs - plain_xs).abs().max())
    v = x0.astype("float64")
    A64 = A.astype("float64")
    e64 = 0.0
    for t in range(steps):
        yv = A64 @ v
        v = yv / (np.max(np.abs(yv)) + 1e-9)
        e64 = max(e64, float(np.max(np.abs(xs[t].cpu().numpy() - v))))
    # the gradient: autograd of the plain loop, in float32 and in float64
    grads = []
    for dt in (torch.float32, torch.float64):
        x_req = x0_d.to(dt).requires_grad_(True)
        out = plain_loop(x_req, steps, False, c.data.to(dt))[-1]
        grads.append(torch.autograd.grad((out * w_d.to(dt)).sum(), x_req)[0])
    g_plain, g64 = grads
    e_grad = float((g.double() - g64).abs().max() / g64.abs().max())
    e_grad32 = float((g_plain.double() - g64).abs().max() / g64.abs().max())
    e_last = float((last - xs[-1]).abs().max())
    say(f"converged power iteration: iterates vs the plain step loop on the card max|err| "
        f"{e_plain:.3e} (tol {POWER_TOL['plain']:g}), vs float64 scipy {e64:.3e} (tol "
        f"{POWER_TOL['float64']:g}); gradient vs float64 autograd of the plain loop "
        f"max|err|/max|g| {e_grad:.3e}, the float32 plain loop's {e_grad32:.3e} (tol 4x it "
        f"+ {POWER_TOL['grad']:g}); the gradient function's last iterate vs the iterates' "
        f"{e_last:.3e}")
    if not (torch.isfinite(xs).all() and torch.isfinite(g).all() and e_plain <= POWER_TOL["plain"]
            and e64 <= POWER_TOL["float64"] and e_grad <= 4 * e_grad32 + POWER_TOL["grad"]
            and e_last == 0.0):
        raise AssertionError("power iteration: a hold failed (above)")
    k1_abs = max(k1_nodes_held(f, [x0_d], dev, "power iteration"),
                 k1_nodes_held(fg, [x0_d, w_d], dev, "power iteration gradient"))
    # a step with the condition's read against the same step of the
    # for-scan of the executed steps, which computes and traces the same
    # test (the same inner graph), both eager
    xs_for, converged = f_for(x0_d)
    converged = converged.cpu().numpy()
    if not (torch.equal(xs_for, xs) and converged[-1] and not converged[:-1].any()):
        raise AssertionError(f"power iteration: the for-scan of the executed steps gives other "
                             f"iterates or tests {converged}")
    timing = {}
    if cuda:
        def same_iterates(out):
            if not torch.equal(out[0], xs):
                raise AssertionError("power iteration: a timed call gave other iterates")

        pair = alternated_ms(lambda: f(x0_d), lambda: f_for(x0_d), POWER_PAIRS, same_iterates)
        w_grad = wall_ms(lambda: fg(x0_d, w_d), POWER_CALLS)
        d_while, by = device_ms(lambda: f(x0_d), 3)
        timing = {**read_cost(pair, steps), "grad_wall_ms": w_grad, "device_ms": d_while,
                  "read_span_us": read_span(lambda: f(x0_d), steps, same_iterates),
                  "kernels": sum(c_ for _, c_ in by.values())}
        say(f"converged power iteration ({smi_line}): {say_read(timing, steps)}; device "
            f"{d_while:.4f} ms a call, busy {d_while / timing['wall_ms']:.3f}, "
            f"{timing['kernels']:.0f} kernels a call; the gradient's call {w_grad:.4f} ms")
        for kname, (ms, cnt) in sorted(by.items(), key=lambda kv: -kv[1][0])[:6]:
            say(f"  power until: {ms:.4f} ms/call  {cnt:.0f} launches/call  {kname[:90]}")
    row = {"power": {"exit": steps, "tol": tol, "launches": fwd, "grad_launches": bwd,
                     "err_plain": e_plain, "err_float64": e64, "err_grad": e_grad,
                     "err_grad_plain32": e_grad32, **timing}}
    launches = {"power until": fwd, "power until gradient": bwd}
    k4_by_path = {"converged power iteration": fwd["spmv_csr"],
                  "its gradient": bwd["spmv_csr"]}

    # (b) the divergence-stopped radon trajectory --------------------------------------
    n_params = N_COUNTIES + 4
    th0 = theta_start(n_params)
    m0 = np.random.default_rng(TRAJ_SEED).standard_normal(n_params)
    logp0, _ = radon_logp_dlogp_reference(th0, N_OBS, N_COUNTIES)
    H0 = -float(np.ravel(logp0)[0]) + 0.5 * float(m0 @ m0)
    th_d, m_d = torch.from_numpy(th0).to(dev), torch.from_numpy(m0).to(dev)
    k1_abs = max(k1_abs, trajectories(fns, th_d, m_d, H0, launches, row, reset, counts, dev,
                                      smi_line))
    say(f"while-scan phase done in {time.perf_counter() - t21:.1f} s")
    return launches, k4_by_path, k1_abs, row


def paired(d):
    """The median of paired differences ``d`` and its standard error, from
    their median absolute deviation (a host's stall in one call moves
    neither)."""
    med = float(np.median(d))
    return med, 1.2533 * 1.4826 * float(np.median(np.abs(d - med))) / np.sqrt(len(d))


def alternated_ms(fa, fb, budget, check):
    """Wall ms of calls of ``fa`` and of ``fb`` in turn (a b, b a, a b,
    ...), each alone (the card idle before and after), until the pairs'
    differences resolve (``paired``: their median more than three standard
    errors from 0, after at least ``budget[0]`` pairs) or ``budget[1]``
    seconds have gone; ``check`` is given each call's output.  Returns
    (a's, b's)."""
    import torch

    times: tuple[list, list] = ([], [])
    t0 = time.perf_counter()
    while True:
        for k in ((0, 1) if len(times[0]) % 2 == 0 else (1, 0)):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = (fa, fb)[k]()
            torch.cuda.synchronize()
            times[k].append((time.perf_counter() - t) * 1e3)
            check(out)
        med, se = paired(np.subtract(*times))
        n = len(times[0])
        if n >= 2 and (time.perf_counter() - t0 > budget[1] or (
                n >= budget[0] and abs(med) > 3 * se)):
            return times


def read_cost(pair, steps):
    """The condition's read a step from ``alternated_ms``' while- and
    for-scan calls of ``steps`` steps: the pairs' median difference and
    its standard error (``paired``), the mean's and the minima's
    differences, in µs."""
    a, b = (np.asarray(t) for t in pair)
    d = (a - b) / steps * 1e3
    med, se = paired(d)
    return {"pairs": len(d), "wall_ms": float(np.median(a)), "for_wall_ms": float(np.median(b)),
            "step_us": float(np.median(a)) / steps * 1e3,
            "for_step_us": float(np.median(b)) / steps * 1e3,
            "read_us": med, "read_se_us": se, "read_mean_us": float(d.mean()),
            "read_min_us": float(a.min() - b.min()) / steps * 1e3,
            "resolved": bool(abs(med) > 3 * se)}


def read_span(fn, steps, check):
    """The condition's read from the inside: the host's time in
    ``aten::is_nonzero`` (``bool()`` of the condition: the copy to the
    host and the wait for the card) that ``torch.profiler`` traces over one
    call of ``fn``, which must read it once a step; µs a read.  ``check``
    is given the call's output."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        check(fn())
    reads = [e for e in prof.key_averages() if e.key == "aten::is_nonzero"]
    if sum(e.count for e in reads) != steps:
        raise AssertionError(f"the while-scan read its condition {[e.count for e in reads]} "
                             f"times in {steps} steps")
    return sum(e.cpu_time_total for e in reads) / steps


def say_read(r, steps):
    return (f"{r['step_us']:.2f} µs a step with the condition's read ({steps} steps, median "
            f"{r['wall_ms']:.4f} ms a call), against {r['for_step_us']:.2f} µs a step of the "
            f"eager for-scan of {steps} that computes the same test ({r['for_wall_ms']:.4f} ms); "
            f"the read {r['read_us']:.2f} ± {r['read_se_us']:.2f} µs a step, the median of "
            f"{r['pairs']} alternated pairs' differences ("
            + ("resolved: more than three standard errors from 0" if r["resolved"]
               else "not resolved: within three standard errors of 0")
            + f"), {r['read_mean_us']:.2f} their mean, "
            f"{r['read_min_us']:.2f} between the minima; the read's own span (torch.profiler, "
            f"aten::is_nonzero) {r['read_span_us']:.2f} µs")


def trajectories(fns, th_d, m_d, H0, launches, row, reset, counts, dev, smi_line):
    """Phase 21 (b): the radon trajectory at each ``TRAJ_EPS``, into
    ``launches`` and ``row``; returns its K1 nodes' largest error.  The
    while-scan (at most ``TRAJ_STEPS`` steps) and the for-scan of as many
    steps as it ran, held with torch's deterministic algorithms
    (``TRAJ_EPS``); then with torch's defaults, each call held against
    those rows (``TRAJ_DEFAULT``): the while-scan timed once, and where it
    diverges its read's span (``read_span``)."""
    import torch

    from pytensor_tpu_torch.models.radon import MAX_DH

    cuda = dev.type == "cuda"
    fw, ff = fns["radon"], fns["radon for"]
    k1_abs = 0.0

    def timed(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        if cuda:
            torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    for label, eps in TRAJ_EPS.items():
        args = [th_d, m_d, np.float64(eps)]
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            reset()
            tw, w_det = timed(fw, *args, np.int64(TRAJ_STEPS))
            launches[f"radon trajectory {label}"] = counts()
            k = int(tw[0].shape[0])
            tf, f_det = timed(ff, *args, np.int64(k))
        finally:
            torch.use_deterministic_algorithms(False)
        same = [torch.equal(a, b) for a, b in zip(tw, tf)]
        hs = tw[2].cpu().numpy()
        dh = np.abs(hs - H0)
        stops = bool(dh[-1] > MAX_DH) and bool((dh[:-1] <= MAX_DH).all())
        tested = tf[3].cpu().numpy()  # the for-scan's trace of the same test
        say(f"radon trajectory, eps {eps}: exit after step {k} of {TRAJ_STEPS}; H0 {H0:.6f}, "
            f"|H - H0| at the exit {dh[-1]:.6g}, largest before {dh[:-1].max(initial=0.0):.6g}; "
            f"rows equal to the for-scan's of {k} steps (theta, m, H): {same}; launches "
            f"{launches[f'radon trajectory {label}']}")
        if not all(same) or tested[:-1].any() or bool(tested[-1]) != (k < TRAJ_STEPS):
            raise AssertionError(f"radon trajectory {label}: rows or tests differ from the "
                                 f"for-scan's ({tested})")
        if label == "fires" and not (1 < k < TRAJ_STEPS and stops):
            raise AssertionError(f"radon trajectory {label}: exit after step {k}, |H - H0| {dh}")
        if label == "never" and not (k == TRAJ_STEPS and (dh <= MAX_DH).all()):
            raise AssertionError(f"radon trajectory {label}: exit after step {k}")
        if not (np.isfinite(hs[:-1]).all() and tw[0][:-1].isfinite().all()):
            raise AssertionError(f"radon trajectory {label}: a value before the exit is not "
                                 f"finite")
        k1_abs = max(k1_abs, k1_nodes_held(fw, [*args, np.int64(TRAJ_STEPS)], dev,
                                           f"radon trajectory {label}"))
        r = {"exit": k, "eps": eps, "dh_exit": float(dh[-1]),
             "deterministic_step_us": w_det / k * 1e3,
             "deterministic_for_step_us": f_det / k * 1e3}
        # with torch's defaults (the gradient's scatter-adds by atomics):
        # each call's exit and rows against the held ones
        worst = [0.0, 0.0]

        def held(out, label=label, tw=tw, k=k):
            rows = out[:3]
            if int(rows[0].shape[0]) != k:
                raise AssertionError(f"radon trajectory {label}: a call with torch's defaults "
                                     f"exits after step {rows[0].shape[0]}, not {k}")
            err = np.asarray([((a - b).abs() / b.abs().clamp(min=1.0)).reshape(k, -1)
                              .amax(1).cpu().numpy() for a, b in zip(rows, tw)]).max(0)
            n = min(k, TRAJ_DEFAULT["steps"])
            worst[0] = max(worst[0], float(err[:n].max()))
            worst[1] = max(worst[1], float(err.max()))
            dh_ = (out[2] - H0).abs().cpu().numpy()
            if not (err[:n].max() <= TRAJ_DEFAULT["rtol"]
                    and (dh_[:-1] <= MAX_DH).all() and (dh_[-1] > MAX_DH) == (k < TRAJ_STEPS)):
                raise AssertionError(f"radon trajectory {label}: a call with torch's defaults "
                                     f"is {err[:n].max():.3e} from the held rows in its first "
                                     f"{n} steps, or its energies fail the test")

        if cuda:
            out, w_while = timed(fw, *args, np.int64(TRAJ_STEPS))
            held(out)
            r.update(wall_ms=w_while, step_us=w_while / k * 1e3)
            span = ""
            if label == "fires":
                # the read by its span alone: alternated calls against the
                # for-scan did not resolve it in 6-10 s on an H100
                r["read_span_us"] = read_span(lambda: fw(*args, np.int64(TRAJ_STEPS)), k, held)
                span = (f"; the read's own span (torch.profiler, aten::is_nonzero) "
                        f"{r['read_span_us']:.2f} µs")
            say(f"radon trajectory, eps {eps} ({smi_line}): {r['step_us']:.2f} µs a step with "
                f"the condition's read, one call of {k} steps{span}")
        r.update(default_err=worst[0], default_err_all=worst[1])
        say(f"radon trajectory, eps {eps}: with torch's defaults, each call's rows within "
            f"{worst[0]:.3e} of the held ones in their first {min(k, TRAJ_DEFAULT['steps'])} "
            f"steps (tol {TRAJ_DEFAULT['rtol']:g}), {worst[1]:.3e} over all {k}; with torch's "
            f"deterministic algorithms {r['deterministic_step_us']:.2f} and "
            f"{r['deterministic_for_step_us']:.2f} µs a step")
        row[f"radon {label}"] = r
    return k1_abs


# --- phase 22: the compile driver -------------------------------------------------------

# the radon function under each mode against the others and the CPU, over
# max(1, |ref|): float64, and the gradient's scatter-add (index_add_) adds
# in any order on the card (on the CPU the port and the JAX package agree
# to 4e-16)
MODE_RTOL = 1e-12
COMPILE_MODES = ("FAST_COMPILE", "PY", "FAST_RUN")
# the Hessian-vector product against central differences of dlogp (step
# HVP_H along v) and against the CPU, over max|hvp| (at 40/5 on the CPU the
# differences are within 1e-7 and the JAX package's product within 4e-16)
HVP_TOL = {"differences": 1e-6, "cpu": 1e-10}
HVP_H, HVP_SEED = 1e-5, 22
COMPILE_CALLS = 20


def compile_functions(dev):
    """Phase 22's radon functions on ``dev``: ``{mode: f}`` for each of
    ``COMPILE_MODES`` and ``"hvp"``, ``pushforward(dlogp, theta, v)``
    under ``FAST_RUN``; and the Hessian-vector product's inputs."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.models.radon import make_radon_graphs

    fns = {}
    for mode in COMPILE_MODES:
        ins, outs, n = make_radon_graphs(N_OBS, N_COUNTIES, "float64")
        fns[mode] = ptt.function(ins, outs, mode=mode, name=f"radon {mode}", device=dev)
    (theta,), (_, dlogp), n = make_radon_graphs(N_OBS, N_COUNTIES, "float64")
    v = pt.dvector("v")
    fns["hvp"] = ptt.function([theta, v], ptt.pushforward(dlogp, theta, v), name="radon hvp",
                              device=dev)
    fns["dlogp"] = ptt.function([theta], dlogp, name="radon dlogp", device=dev)
    return fns, n


def compile_kernels(dev):
    """The K1 kernels of phase 22's functions, from them linked for the CPU
    (phase 2's pool), and those CPU functions (phase 22's references)."""
    cpu, _ = compile_functions("cpu")
    kerns: dict = {}
    for f in cpu.values():
        plan_kernels(f.linked, dev, kerns)
    return list(kerns.values()), cpu


def phase_compile(dev, smi_line, cpu, chain, chain_args, power, power_x, power_x0):
    """Phase 22: the compile driver.  (a) The radon logp and dlogp at
    919/85 in float64 under each of ``COMPILE_MODES`` on the card: compile
    seconds, ms a call, the counts set to 0 before a (replayed, where
    captured) call and read after; each against the others and the CPU
    (``MODE_RTOL``).  (b) ``pushforward(dlogp, theta, v)`` under
    ``FAST_RUN`` against central differences of ``dlogp`` and the CPU
    (``HVP_TOL``); the K1 nodes of (a) and (b) against their plain
    version.  (c) ``power`` (phase 10's 64-step power iteration, whose
    shared ``power_x`` is set to ``power_x0``) copied three ways, and
    saved and loaded by ``pkl_utils``: each from the same state launches K4
    64 times a call, gives the original's bits and moves only its own
    shared tensor.  (d) ``chain`` (phase 7's 8,192-step chain) pickled and
    loaded: one K2 launch a call, the original's bits on ``chain_args``.
    (e) ``profile=True`` under ``FAST_RUN`` and ``PY``.  Returns
    ({path: launches}, {path: K4 launches}, K1's largest absolute error,
    the row)."""
    import io
    import pickle

    import torch

    import pytensor_tpu_torch as ptt
    from pytensor_tpu_torch.link.cuda import scan_kernel, spmv_kernel
    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.misc import pkl_utils
    from pytensor_tpu_torch.models.radon import theta_start
    from pytensor_tpu_torch.tensor import fused_kernel

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kernels = (fused_kernel, scan_kernel, spmv_kernel)

    def reset():
        for k in kernels:
            k.LAUNCHES = 0

    def counts():
        sync()
        return {"fused_elemwise": fused_kernel.LAUNCHES, "scan_whole_loop": scan_kernel.LAUNCHES,
                "spmv_csr": spmv_kernel.LAUNCHES}

    def scaled(a, b):
        a, b = (np.asarray(x.detach().double().cpu()) for x in (a, b))
        return float((np.abs(a - b) / np.maximum(1.0, np.abs(b))).max())

    t0 = time.perf_counter()
    fns, n = compile_functions(dev)
    say(f"phase 22 functions linked in {time.perf_counter() - t0:.2f} s: "
        + "; ".join(f"{m} {f.compile_time:.3f} s (rewrites {f.rewrite_time:.3f} s, "
                    f"{len(f.fgraph.apply_nodes)} nodes, {type(f.linked).__name__})"
                    for m, f in fns.items()))
    rng = np.random.default_rng(HVP_SEED)
    th = theta_start(n, "float64") + 0.1 * rng.standard_normal(n)
    v = rng.standard_normal(n)
    th_d, v_d = as_torch(th, dev), as_torch(v, dev)
    launches, k4, row = {}, {}, {"modes": {}}
    # (a) the modes
    want = [t.numpy() for t in cpu["FAST_RUN"](th)]
    k1_abs = 0.0
    for mode in COMPILE_MODES:
        f = fns[mode]
        f(th_d)  # captures where the linker captures
        reset()
        got = f(th_d)
        launches[f"compile driver {mode}"] = c = counts()
        errs = [scaled(g, torch.from_numpy(w)) for g, w in zip(got, want)]
        others = [scaled(g, o) for g, o in zip(got, fns["FAST_RUN"](th_d))]
        if not (max(errs + others) <= MODE_RTOL and all(torch.isfinite(g).all() for g in got)):
            raise AssertionError(f"radon {mode}: {errs} from the CPU, {others} from FAST_RUN on "
                                 f"the card; tol {MODE_RTOL}")
        if cuda and (c["fused_elemwise"] == 0) != (mode == "FAST_COMPILE"):
            raise AssertionError(f"radon {mode}: K1 launched {c['fused_elemwise']} times")
        ms = wall_ms(lambda: f(th_d), COMPILE_CALLS) if cuda else float("nan")
        row["modes"][mode] = {"compile_s": f.compile_time, "rewrite_s": f.rewrite_time,
                              "nodes": len(f.fgraph.apply_nodes), "ms": ms, "launches": c,
                              "err_cpu": max(errs), "err_fast_run": max(others),
                              "linked": type(f.linked).__name__}
        say(f"radon {mode} ({smi_line}): compile {f.compile_time:.3f} s, "
            f"{len(f.fgraph.apply_nodes)} nodes, {type(f.linked).__name__}; {ms:.4f} ms/call "
            f"(wall); launches a call {c}; logp, dlogp within {max(errs):.2e} of the CPU and "
            f"{max(others):.2e} of FAST_RUN on the card (tol {MODE_RTOL:g})")
        if mode != "FAST_COMPILE":
            k1_abs = max(k1_abs, k1_nodes_held(f, [th_d], dev, f"radon {mode}"))
    # (b) the Hessian-vector product
    hvp = fns["hvp"]
    hvp(th_d, v_d)
    reset()
    got = hvp(th_d, v_d)
    launches["compile driver hvp"] = c = counts()
    d = fns["dlogp"]
    fd = (d(as_torch(th + HVP_H * v, dev)) - d(as_torch(th - HVP_H * v, dev))) / (2 * HVP_H)
    ref = cpu["hvp"](th, v)
    scale = float(ref.abs().max())
    e_fd = float((got - fd).abs().max()) / scale
    e_cpu = float((got.cpu() - ref).abs().max()) / scale
    if not (e_fd <= HVP_TOL["differences"] and e_cpu <= HVP_TOL["cpu"]
            and (c["fused_elemwise"] or not cuda)):
        raise AssertionError(f"radon hvp: {e_fd} from central differences, {e_cpu} from the "
                             f"CPU, K1 {c['fused_elemwise']} launches; tol {HVP_TOL}")
    hvp_ms = wall_ms(lambda: hvp(th_d, v_d), COMPILE_CALLS) if cuda else float("nan")
    k1_abs = max(k1_abs, k1_nodes_held(hvp, [th_d, v_d], dev, "radon hvp"))
    row["hvp"] = {"compile_s": hvp.compile_time, "nodes": len(hvp.fgraph.apply_nodes),
                  "ms": hvp_ms, "launches": c, "err_differences": e_fd, "err_cpu": e_cpu}
    say(f"radon Hessian-vector product, pushforward(dlogp, theta, v) under FAST_RUN "
        f"({smi_line}): compile {hvp.compile_time:.3f} s, {len(hvp.fgraph.apply_nodes)} nodes; "
        f"{hvp_ms:.4f} ms/call (wall); launches a call {c}; {e_fd:.2e} of max|hvp| from central "
        f"differences of dlogp (h {HVP_H:g}), {e_cpu:.2e} from the CPU (tol {HVP_TOL})")
    # (c) copies of the power iteration, and the same through pkl_utils
    power_x.set_value(power_x0)
    x2 = ptt.shared(power_x0, name="x2", device=dev)
    t0 = time.perf_counter()
    copies = {"copy()": power.copy(), "copy(swap={x: x2})": power.copy(swap={power_x: x2}),
              "copy(delete_updates=True)": power.copy(delete_updates=True)}
    buf = io.BytesIO()
    pkl_utils.dump_function(power, buf)
    buf.seek(0)
    copies["pkl_utils.load_function"] = pkl_utils.load_function(buf)
    copy_s = time.perf_counter() - t0
    owned = {tag: g.shared_vars[0] for tag, g in copies.items()}
    want = power()
    moved = power_x.get_value()
    row["copies"] = {"seconds": copy_s, "zip_bytes": len(buf.getvalue())}
    for tag, g in copies.items():
        first = g()  # captures
        owned[tag].set_value(power_x0)
        reset()
        out = g()
        launches[f"power {tag}"] = c = counts()
        k4[f"power {tag}"] = c["spmv_csr"]
        after = owned[tag].get_value()
        updates = "delete_updates" not in tag
        ok = ((c["spmv_csr"] == SPARSE_STEPS or not cuda) and c["fused_elemwise"] == 0
              and c["scan_whole_loop"] == 0 and torch.equal(out, want)
              and torch.equal(first, want)
              and torch.equal(after, moved if updates else as_torch(power_x0, dev))
              and torch.equal(power_x.get_value(), moved) and (owned[tag] is not power_x))
        if tag.startswith("copy(swap"):
            ok = ok and owned[tag] is x2
        if not ok:
            raise AssertionError(f"power iteration {tag}: launches {c}, bits equal "
                                 f"{torch.equal(out, want)}, its shared tensor "
                                 f"{torch.equal(after, moved)}, the original's moved "
                                 f"{not torch.equal(power_x.get_value(), moved)}")
        ms = wall_ms(g, 8) if cuda else float("nan")
        row["copies"][tag] = {"launches": c, "ms": ms}
        say(f"power iteration {tag} ({smi_line}): launches a replayed call {c}; output bit for "
            f"bit the original's from the same state; its own shared tensor "
            f"{'moved as the original' if updates else 'kept'}, the original's untouched; "
            f"{ms:.3f} ms/call (wall)")
    say(f"power iteration: three copies and a pkl_utils round trip ({len(buf.getvalue()):,} "
        f"bytes of zip) made in {copy_s:.2f} s")
    # (d) the chain through pickle
    want = chain(*chain_args)
    t0 = time.perf_counter()
    blob = pickle.dumps(chain)
    dump_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    again = pickle.loads(blob)
    first = again(*chain_args)
    sync()
    load_s = time.perf_counter() - t0
    reset()
    got = again(*chain_args)
    launches["reloaded chain"] = c = counts()
    same = [torch.equal(a, b) for a, b in zip(got, want)] + [
        torch.equal(a, b) for a, b in zip(first, want)]
    if not (all(same) and (c["scan_whole_loop"] == 1 or not cuda)):
        raise AssertionError(f"reloaded chain: bits equal {same}, launches {c}")
    row["chain"] = {"pickle_bytes": len(blob), "dumps_s": dump_s, "loads_to_result_s": load_s,
                    "launches": c}
    say(f"chain {CHAIN_STEPS} steps through pickle ({smi_line}): {len(blob):,} bytes, dumps "
        f"{dump_s:.2f} s, loads to the first result {load_s:.2f} s; launches a replayed call "
        f"{c}; outputs bit for bit the original's")
    # (e) profiles
    row["profile"] = {}
    for mode in ("FAST_RUN", "PY"):
        f = ptt.function(*_radon_io(), mode=mode, profile=True, name=f"radon {mode}",
                         device=dev)
        for _ in range(COMPILE_CALLS):
            f(th_d)
        st = f.profile
        top = [{"op": op, "count": k, "flops": fl, "bytes": by} for op, k, fl, by in
               st.op_table[:5]]
        later = st.call_count - 1  # the first call captures (FAST_RUN)
        host = (st.call_time - st.first_call_time) / later * 1e3
        device = (st.device_time - st.first_device_time) / later * 1e3
        row["profile"][mode] = {"calls": st.call_count, "host_ms": host, "device_ms": device,
                                "first_host_ms": st.first_call_time * 1e3,
                                "first_device_ms": st.first_device_time * 1e3,
                                "peak_bytes": st.peak_bytes, "op_table_top5": top,
                                "nodes_timed": sum(st.op_calls.values())}
        say(f"profile=True, radon {mode} ({smi_line}): {st.call_count} calls, after the first "
            f"host {host:.4f} ms/call and device {device:.4f} ms/call (CUDA events around each "
            f"call, which waits for the card), the first {st.first_call_time * 1e3:.2f} ms; "
            f"the first call's peak {st.peak_bytes} bytes; {sum(st.op_calls.values())} nodes "
            f"timed; op table: "
            + "; ".join(f"{t['op'][:40]} x{t['count']} {t['flops']:,} flops {t['bytes']:,} B"
                        for t in top))
        if mode == "PY":
            slow = sorted(st.op_time.items(), key=lambda kv: -kv[1])[:3]
            say("  PY's costliest ops by device time: " + "; ".join(
                f"{op[:50]} {t / st.call_count * 1e3:.4f} ms/call" for op, t in slow))
    return launches, k4, k1_abs, row


# --- phase 23: the graph layer -----------------------------------------------------------

# the probe graphs' size: 4,096 x 4,096 matrices and vectors of 2**24
# elements, float32 (the MFU width and K1's 2**24 rows)
GRAPH_SIDE = 4096
# values against float64 numpy on the same float32 inputs, over
# max(1, |ref|): an elementwise graph's rounding (a float32 transcendental
# within a few ulps), a product's or a sum's over 4,096 terms
GRAPH_TOL = {"elemwise": 1e-6, "shape": 1e-6, "product": 1e-4}
GRAPH_TIMED_CALLS = 5
BLAS_N = 4096
PRINT_MESSAGE = "phase 23 dlogp"


def fired_rewrites():
    """Count the port's node rewrites that change a graph while linking:
    ``(counts, undo)``, ``counts`` keyed by the rewrite's name."""
    import collections

    from pytensor_tpu_torch.graph.rewriting import basic

    counts = collections.Counter()
    orig = basic.FromFunctionNodeRewriter.transform

    def transform(self, fgraph, node):
        res = orig(self, fgraph, node)
        if res:
            counts[str(self)] += 1
        return res

    basic.FromFunctionNodeRewriter.transform = transform

    def undo():
        basic.FromFunctionNodeRewriter.transform = orig

    return counts, undo


def graph_link(case, dev, mode):
    """``case``'s probe graph at ``GRAPH_SIDE`` in float32 linked for ``dev``
    under ``mode``; inputs of unknown shape."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt

    vals = case.inputs(GRAPH_SIDE, "float32")
    ins = [pt.tensor(f"x{k}", dtype=np.asarray(v).dtype, shape=(None,) * np.ndim(v))
           for k, v in enumerate(vals)]
    return ptt.function(ins, case.build(pt, GRAPH_SIDE, *ins), mode=mode, device=dev,
                        name=f"graph {case.label}")


def graph_modes(case):
    """The case's mode (``FAST_RUN`` less its ``exclude``) and the same less
    the rewrite (``without``)."""
    from pytensor_tpu_torch.compile.mode import FAST_RUN

    mode = FAST_RUN.excluding(*case.exclude) if case.exclude else FAST_RUN
    return mode, mode.excluding(*case.without)


def print_functions(dev):
    """Phase 23's radon functions at 919/85 in float64 under ``FAST_RUN``:
    logp and dlogp, and the same with ``Print`` on dlogp."""
    import pytensor_tpu_torch as ptt
    from pytensor_tpu_torch.models.radon import make_radon_graphs
    from pytensor_tpu_torch.printing import Print

    ins, (logp, dlogp), _ = make_radon_graphs(N_OBS, N_COUNTIES, "float64")
    f = ptt.function(ins, [logp, dlogp], name="radon", device=dev)
    ins, (logp, dlogp), _ = make_radon_graphs(N_OBS, N_COUNTIES, "float64")
    g = ptt.function(ins, [logp, Print(PRINT_MESSAGE)(dlogp)], name="radon Print", device=dev)
    return f, g, logp


def graph_kernels(dev):
    """Phase 23's K1 kernels, for phase 2's pool: from its probe graphs (and
    the timed ones without their rewrite) and the Print function, linked for
    the CPU; and each probe graph's node counts there, with the rewrite and
    without it."""
    from pytensor_tpu_torch.link.cuda.rewrite_cases import CASES, TIMED

    kerns: dict = {}
    nodes = []
    for case in CASES:
        mode, without = graph_modes(case)
        f, g = graph_link(case, "cpu", mode), graph_link(case, "cpu", without)
        plan_kernels(f.linked, dev, kerns)
        if case.rewrite in TIMED:
            plan_kernels(g.linked, dev, kerns)
        nodes.append((len(f.fgraph.apply_nodes), len(g.fgraph.apply_nodes)))
    for f in print_functions("cpu")[:2]:
        plan_kernels(f.linked, dev, kerns)
    return list(kerns.values()), nodes


def graph_value_error(got, ref):
    """The largest error of ``got`` against the float64 numpy ``ref`` over
    max(1, |ref|), on ``got``'s device; non-finite values must match
    exactly (NaN to NaN), integers and bools everywhere."""
    import torch

    ref = np.asarray(ref)
    if not ref.flags.c_contiguous:
        ref = np.ascontiguousarray(ref)
    want = torch.from_numpy(ref).to(got.device)
    if tuple(got.shape) != tuple(want.shape):
        raise AssertionError(f"shape {tuple(got.shape)}, want {tuple(want.shape)}")
    if not want.is_floating_point():
        return 0.0 if torch.equal(got.to(want.dtype), want) else float("inf")
    got = got.double()
    fin = torch.isfinite(want)
    bad = ~fin & ~((got == want) | (torch.isnan(got) & torch.isnan(want)))
    if bool(bad.any()):
        return float("inf")
    err = (got - want).abs() / want.abs().clamp(min=1.0)
    return float(err[fin].max()) if bool(fin.any()) else 0.0


def phase_graph(dev, smi_line, nodes_cpu, chain, chain_args):
    """Phase 23: the graph-and-rewrite layer.  (a) Each probe graph of
    ``link/cuda/rewrite_cases.py`` (the ShapeFeature's, and one or more for
    each of the 54 rewrites item 6 ported) at ``GRAPH_SIDE`` in float32,
    linked under ``FAST_RUN`` (less the case's ``exclude``) and captured:
    the rewrite fires while linking (the ShapeFeature's graph has fewer
    nodes than without it), the graph's nodes against the CPU's and those
    without the rewrite, K1 and K2 launches in one replayed call (the counts
    set to 0 just before it), the value against float64 numpy
    (``GRAPH_TOL``), every K1 node against its plain version; the timed
    graphs' device ms a call with the rewrite and without it.  One line a
    family.  (b) ``dprint`` of the radon logp and dlogp at 919/85 in
    float64 (its FusedElemwise nodes, which K1 runs), ``pprint`` of logp, and
    ``Print`` on dlogp: the plan eager and why, the message once a call,
    logp and dlogp the captured function's bits (under torch's
    deterministic algorithms, whose index_add_ adds in one order).  (c) The
    radon function and ``chain`` (phase 7's 8,192-step chain) linked again
    under ``FAST_RUN.register(AddDestroyHandler())``: ``validate`` passes,
    the donation report, one K2 launch a chain call with the original's
    bits on ``chain_args``; ``validate`` refuses destroyers whose orderings
    form a cycle.  (d) ``misc/check_blas.py``'s GEMM at ``BLAS_N`` in
    float32 and bfloat16.  Returns ({path: launches}, K1's largest absolute
    error, the row)."""
    import contextlib
    import io

    import torch

    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.compile.executor import _rebuild_function
    from pytensor_tpu_torch.compile.mode import FAST_RUN, AddDestroyHandler, get_mode
    from pytensor_tpu_torch.graph.basic import Apply
    from pytensor_tpu_torch.graph.destroyhandler import (
        DestroyHandler,
        InconsistencyError,
        donation_report,
    )
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.graph.op import Op
    from pytensor_tpu_torch.link.cuda import scan_kernel
    from pytensor_tpu_torch.link.cuda.rewrite_cases import CASES, FAMILIES, TIMED
    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.misc.check_blas import execute
    from pytensor_tpu_torch.models.radon import theta_start
    from pytensor_tpu_torch.printing import pprint
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    def reset():
        fused_kernel.LAUNCHES = scan_kernel.LAUNCHES = 0

    def counts():
        sync()
        return {"fused_elemwise": fused_kernel.LAUNCHES, "scan_whole_loop": scan_kernel.LAUNCHES}

    def dev_ms(fn):
        return device_ms(fn, GRAPH_TIMED_CALLS)[0] if cuda else float("nan")

    launches, row, k1_abs = {}, {"families": {}, "timed": {}}, 0.0
    total = {"fused_elemwise": 0, "scan_whole_loop": 0}
    fam = {f: {"graphs": 0, "fired": 0, "nodes": 0, "nodes_without": 0, "k1": 0, "worst": 0.0,
               "s": 0.0, "link_s": 0.0} for f in FAMILIES}
    uploaded = {}

    def upload(v):
        """An input on the card, once for each of the read-only values the
        cases share (the entry holds the array, so its id stays its own)."""
        hit = uploaded.get(id(v))
        if hit is not None and hit[0] is v:
            return hit[1]
        t = as_torch(np.array(v), dev)
        if not v.flags.writeable:
            uploaded[id(v)] = (v, t)
        return t

    def reference(case):
        return case.reference(*case.inputs(GRAPH_SIDE, "float32"))

    # (a) the probe graphs, each float64 reference made on a host thread
    # while the card links and runs the graph before it
    refs = ThreadPoolExecutor(1)
    pending = refs.submit(reference, CASES[0])
    for i, (case, (n_cpu, n_without)) in enumerate(zip(CASES, nodes_cpu)):
        t0 = time.perf_counter()
        mode, without = graph_modes(case)
        fired, undo = fired_rewrites()
        try:
            f = graph_link(case, dev, mode)
        finally:
            undo()
        t_link = time.perf_counter() - t0
        n = len(f.fgraph.apply_nodes)
        took = n_without - n if case.rewrite == "shape_feature" else fired[case.rewrite]
        if n != n_cpu or took <= 0:
            raise AssertionError(f"graph {case.label}: {n} nodes on the card, {n_cpu} on the "
                                 f"CPU; {case.rewrite} took it {took} times")
        vals = case.inputs(GRAPH_SIDE, "float32")
        args = [upload(v) for v in vals]
        ref = pending
        if i + 1 < len(CASES):  # the next reference on the host beside this graph's work
            pending = refs.submit(reference, CASES[i + 1])
        f(*args)  # captures
        reset()
        out = f(*args)
        c = counts()
        for k in total:
            total[k] += c[k]
        err = graph_value_error(out, ref.result())
        if not err <= GRAPH_TOL[case.kind]:
            raise AssertionError(f"graph {case.label}: {err} from float64 numpy, tol "
                                 f"{GRAPH_TOL[case.kind]}")
        k1_abs = max(k1_abs, k1_nodes_held(f, args, dev, f"graph {case.label}", quiet=True))
        if case.rewrite in TIMED:
            g = graph_link(case, dev, without)
            g_err = graph_value_error(g(*args), ref.result())
            ms, ms_without = dev_ms(lambda: f(*args)), dev_ms(lambda: g(*args))
            row["timed"][case.label] = {"rewrite": case.rewrite, "ms": ms,
                                        "ms_without": ms_without, "nodes": n,
                                        "nodes_without": len(g.fgraph.apply_nodes),
                                        "err": err, "err_without": g_err}
            say(f"graph {case.label} ({smi_line}): {ms:.4f} ms/call (device) with "
                f"{case.rewrite}, {ms_without:.4f} without ({', '.join(case.without)} "
                f"excluded); {n} nodes against {len(g.fgraph.apply_nodes)}; "
                f"{err:.2e} and {g_err:.2e} from float64 numpy")
            del g
        r = fam[case.family]
        r["graphs"] += 1
        r["fired"] += took
        r["nodes"] += n
        r["nodes_without"] += n_without
        r["k1"] += c["fused_elemwise"]
        r["worst"] = max(r["worst"], err)
        r["s"] += time.perf_counter() - t0
        r["link_s"] += t_link
        del f, args, out, ref
    refs.shutdown()
    uploaded.clear()
    for name, r in fam.items():
        row["families"][name] = r
        fired = "saved" if name == "shape" else "fired"
        say(f"graph family {name} ({smi_line}): {r['graphs']} graphs at {GRAPH_SIDE:,}^2 "
            f"float32 elements, the rewrites {fired} {r['fired']} "
            f"{'nodes' if name == 'shape' else 'times'}, {r['nodes']} nodes in all against "
            f"{r['nodes_without']} without them; K1 {r['k1']} launches in their replayed calls; "
            f"values within "
            f"{r['worst']:.2e} of float64 numpy; each K1 node held against its plain "
            f"version; {r['s']:.1f} s, {r['link_s']:.1f} s of it linking")
    launches["graph"] = total
    # (b) printing on the radon function
    t0 = time.perf_counter()
    rng = np.random.default_rng(23)
    th = as_torch(theta_start(N_COUNTIES + 4, "float64")
                  + 0.1 * rng.standard_normal(N_COUNTIES + 4), dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        f, g, logp = print_functions(dev)
        f(th)  # captures
        reset()
        want = f(th)
        launches["graph radon"] = counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            reset()
            got = [g(th) for _ in range(3)]
            launches["graph Print"] = counts()
    finally:
        torch.use_deterministic_algorithms(False)
    printed = buf.getvalue().splitlines()
    why = [r for r in g.linked.host_reads if "Print" in r]
    same = [torch.equal(a, b) for call in got for a, b in zip(call, want)]
    n_fused = sum(isinstance(nd.op, FusedElemwise) for nd in f.fgraph.apply_nodes)
    text = f.dprint(file="str")
    ok = (isinstance(f.linked, CapturedFunction) or not cuda) and why and \
        not isinstance(g.linked, CapturedFunction) and all(same) and \
        sum(ln.startswith(PRINT_MESSAGE + " [") for ln in printed) == 3 and \
        n_fused > 0 and text.count("Inner graphs of FusedElemwise") == n_fused
    if not ok:
        raise AssertionError(f"printing: Print plan eager for {why}, bits equal {same}, "
                             f"{len(printed)} lines printed, {n_fused} fused nodes, "
                             f"{text.count('Inner graphs of FusedElemwise')} printed")
    logp_text = pprint(logp)
    row["printing"] = {"dprint_lines": len(text.splitlines()), "fused_nodes": n_fused,
                       "pprint_chars": len(logp_text), "print_reason": why[0],
                       "printed_lines": len(printed), "launches": launches["graph Print"]}
    say(f"dprint of the radon logp and dlogp (919/85, float64, FAST_RUN): "
        f"{len(text.splitlines())} lines, {n_fused} FusedElemwise nodes, each with its inner "
        f"graph, which K1 runs ({launches['graph radon']['fused_elemwise']} launches a replayed "
        f"call); its first line: {text.splitlines()[0]}")
    say(f"pprint of logp ({len(logp_text)} characters): {logp_text[:160]}...")
    say(f"Print on dlogp: the plan runs eagerly ({why[0]}); 3 calls printed the message 3 "
        f"times in {len(printed)} lines ('{printed[0][:60]}...'); K1 "
        f"{launches['graph Print']['fused_elemwise']} launches in 3 calls; logp and dlogp bit "
        f"for bit the captured function's; (b) in {time.perf_counter() - t0:.1f} s")
    # (c) the destroy handler
    t0 = time.perf_counter()
    handled = FAST_RUN.register(AddDestroyHandler())
    f_dh = _rebuild_function({**f._spec, "device": str(dev)}, mode=handled)
    spec = chain._spec
    chain_dh = _rebuild_function({**spec, "device": str(dev)},
                                 mode=get_mode(spec["mode"]).register(AddDestroyHandler()))
    for h in (f_dh, chain_dh):
        h.fgraph.destroy_handler.validate(h.fgraph)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        f_dh(th)
        same = [torch.equal(a, b) for a, b in zip(f_dh(th), want)]
    finally:
        torch.use_deterministic_algorithms(False)
    want_chain = chain(*chain_args)
    chain_dh(*chain_args)  # captures
    reset()
    got_chain = chain_dh(*chain_args)
    launches["graph destroy handler chain"] = c = counts()
    same_chain = [torch.equal(a, b) for a, b in zip(got_chain, want_chain)]
    report = donation_report(chain_dh.fgraph)

    class DestroyFirst(Op):
        """Destroys its first input and reads its second."""
        __props__ = ()
        destroy_map = {0: [0]}

        def make_node(self, x, y):
            return Apply(self, [x, y], [x.type()])

    x, y = pt.dvector("x"), pt.dvector("y")
    x.tag.destroyable = y.tag.destroyable = True
    cyc = FunctionGraph([x, y], [DestroyFirst()(x, y), DestroyFirst()(y, x)], clone=False)
    cyc.attach_feature(DestroyHandler())
    try:
        cyc.destroy_handler.validate(cyc)
        refused = None
    except InconsistencyError as e:
        refused = str(e)
    if not (all(same) and all(same_chain) and (c["scan_whole_loop"] == 1 or not cuda)
            and refused == "destroy orderings introduce a cycle"):
        raise AssertionError(f"destroy handler: radon bits {same}, chain bits {same_chain}, "
                             f"launches {c}, the cycle refused: {refused}")
    row["destroy_handler"] = {"radon_donatable": donation_report(f_dh.fgraph),
                              "chain_donatable": report, "chain_launches": c}
    say(f"AddDestroyHandler ({smi_line}): radon and the {CHAIN_STEPS}-step chain validate; "
        f"donation report: radon {sum(donation_report(f_dh.fgraph).values())} of "
        f"{len(f_dh.fgraph.inputs)} inputs donatable, chain "
        f"{sum(report.values())} of {len(report)}; the chain {c} a replayed call with the "
        f"original's bits, radon the captured function's bits; destroyers in a cycle refused "
        f"('{refused}'); (c) in {time.perf_counter() - t0:.1f} s")
    # (d) check_blas
    row["check_blas"] = {}
    for dtype in ("float32", "bfloat16"):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            gflops = execute(BLAS_N, 10, dtype, device=dev) if cuda else float("nan")
        row["check_blas"][dtype] = gflops
        say(f"check_blas.execute({BLAS_N}, {dtype}) ({smi_line}): {gflops:.1f} GFLOP/s "
            f"({' / '.join(out.getvalue().splitlines())})")
    return launches, k1_abs, row


# --- phase 24: control and debug ops -------------------------------------------------

CONTROL_DTYPES = ("float64", "float32")
CONTROL_CALLS = 20
CONTROL_SEED = 24
# the float64 guarded and unguarded functions against the same functions
# linked for the CPU (the same ops, another device's rounding of exp and
# log), over max(1, |cpu|)
CONTROL_RTOL = {"float64": 1e-12, "float32": 2e-6}
CONTROL_LIST_LEN = 4


class CountingProbe:
    """Phase 24's probe op: ``2 x``, with a lowering that counts its calls
    (made on first use, so that the module imports nothing of the port)."""

    op = None
    calls = 0

    @classmethod
    def make(cls):
        if cls.op is None:
            from pytensor_tpu_torch.graph.basic import Apply
            from pytensor_tpu_torch.graph.op import Op
            from pytensor_tpu_torch.link.torch.dispatch import torch_funcify

            class Probe(Op):
                __props__ = ()

                def make_node(self, x):
                    return Apply(self, [x], [x.type()])

                def perform(self, node, inputs, output_storage):
                    output_storage[0][0] = inputs[0] * 2.0

            class Wrong(Op):
                """A toy op whose lowering disagrees with its perform."""

                __props__ = ()

                def make_node(self, x):
                    return Apply(self, [x], [x.type()])

                def perform(self, node, inputs, output_storage):
                    output_storage[0][0] = inputs[0] * 2.0

            @torch_funcify.register(Probe)
            def _probe(op, node=None, **kw):
                def probe(x):
                    cls.calls += 1
                    return x * 2.0

                return probe

            @torch_funcify.register(Wrong)
            def _wrong(op, node=None, **kw):
                return lambda x: x * 3.0

            cls.op, cls.wrong = Probe(), Wrong()
        return cls.op


def control_functions(dev, references=False):
    """Phase 24's functions on ``dev``, by name: for each of
    ``CONTROL_DTYPES`` the guarded radon function (``models/radon.py
    guarded_graphs``: its ``IfElse`` and asserts) and the same model with
    neither (``unguarded``), and in float64 with the asserts alone
    (``asserts``); the
    float64 radon function (``make_radon_graphs``) under ``DebugMode``,
    ``NanGuardMode`` and ``MonitorMode``; the nested ``ifelse`` with the
    counting probe in its untaken branches; one function a typed-list op on
    a list of ``CONTROL_LIST_LEN`` thetas; the ``PdbBreakpoint`` function.
    With ``references``, the CPU's references only: the guarded functions
    (which hold every K1 source of the others) and neither ``DebugMode``
    nor ``MonitorMode`` nor the breakpoint.  Returns ``(fns, n_params, y,
    seen)``, ``seen`` the nodes ``MonitorMode``'s callback saw."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    import pytensor_tpu_torch.typed_list as tl
    from pytensor_tpu_torch.breakpoint import PdbBreakpoint
    from pytensor_tpu_torch.compile.debug import DebugMode, MonitorMode, NanGuardMode
    from pytensor_tpu_torch.models.radon import guarded_graphs, make_radon_graphs

    fns, seen = {}, []
    for dtype in CONTROL_DTYPES:
        variants = [("guarded", True, True)]
        if not references:
            variants.append(("unguarded", False, False))
        if not references and dtype == "float64":
            variants.append(("asserts", True, False))
        for name, asserts, cond in variants:
            ins, outs, n, y = guarded_graphs(ptt, pt, N_OBS, N_COUNTIES, dtype, asserts=asserts,
                                             conditional=cond)
            fns[name, dtype] = ptt.function(ins, outs, name=f"radon {name} {dtype}", device=dev)
    modes = {"NanGuardMode": NanGuardMode()}
    if not references:
        modes.update(DebugMode=DebugMode(),
                     MonitorMode=MonitorMode(post_func=lambda node, thunk: seen.append(node)))
    for tag, mode in modes.items():
        ins, outs, _ = make_radon_graphs(N_OBS, N_COUNTIES, "float64")
        fns[tag] = ptt.function(ins, outs, mode=mode, name=f"radon {tag}", device=dev)
    c1, c2 = pt.tensor("c1", dtype="bool", shape=()), pt.tensor("c2", dtype="bool", shape=())
    x = pt.tensor("x", dtype="float64", shape=(n,))
    inner = ptt.ifelse(c2, CountingProbe.make()(x), x - 1.0)
    fns["nested"] = ptt.function([c1, c2, x], ptt.ifelse(c1, pt.exp(x) + 1.0, inner),
                                 name="nested ifelse", device=dev)
    th = [pt.tensor(f"t{k}", dtype="float64", shape=(n,)) for k in range(CONTROL_LIST_LEN)]
    i = pt.scalar("i", dtype="int64")
    lst = tl.make_list(th)
    for tag, out in (("getitem", tl.getitem(lst, 2)), ("getitem by input", tl.getitem(lst, i)),
                     ("append", tl.append(lst, th[0] * 2.0)), ("extend", tl.extend(lst, lst)),
                     ("insert", tl.insert(lst, 1, th[3] + 1.0)), ("remove", tl.remove(lst, th[1])),
                     ("reverse", tl.reverse(lst)), ("length", tl.length(lst) * 1),
                     ("count", tl.count(lst, th[0])), ("index", tl.index_(lst, th[2]))):
        fns["list " + tag] = ptt.function(th + [i], out, name=f"list {tag}", device=dev,
                                          on_unused_input="ignore")
    if not references:
        cond = pt.gt(x.sum(), 0.0)
        fns["breakpoint"] = ptt.function(
            [x], PdbBreakpoint("phase 24")(cond, x * 2.0, pt.exp(x)), name="breakpoint",
            device=dev)
    return fns, n, y, seen


def control_kernels(dev):
    """The K1 kernels of phase 24's functions, from them linked for the CPU
    (phase 2's pool), and those CPU functions (phase 24's references; the
    debug modes' radon function is phase 22's, whose kernels are built)."""
    cpu = control_functions("cpu", references=True)
    kerns: dict = {}
    for f in cpu[0].values():
        plan_kernels(getattr(f.linked, "plan", f.linked), dev, kerns)
    return list(kerns.values()), cpu


def _guard_k1(f):
    """The K1 nodes of ``f`` that compute its ``IfElse``'s condition and its
    asserts' conditions (``isfinite`` is a fused ``invert(or(isnan,
    isinf))``): ``(for the IfElse, for the asserts)``."""
    from pytensor_tpu_torch.graph.traversal import applys_between
    from pytensor_tpu_torch.ifelse import IfElse
    from pytensor_tpu_torch.raise_op import CheckAndRaise
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    def k1(conds):
        return len([nd for nd in applys_between(f.fgraph.inputs, conds)
                    if isinstance(nd.op, FusedElemwise)])

    nodes = f.fgraph.apply_nodes
    return (k1([nd.inputs[0] for nd in nodes if isinstance(nd.op, IfElse)]),
            k1([c for nd in nodes if isinstance(nd.op, CheckAndRaise) for c in nd.inputs[1:]]))


def _count(f, cls_name):
    return sum(type(nd.op).__name__ == cls_name or any(
        c.__name__ == cls_name for c in type(nd.op).__mro__) for nd in f.fgraph.apply_nodes)


def _control_reset():
    """Phase 24's counts set to 0."""
    from pytensor_tpu_torch.link.cuda import scan_kernel
    from pytensor_tpu_torch.tensor import fused_kernel

    fused_kernel.LAUNCHES = 0
    scan_kernel.LAUNCHES = 0


def _control_counts():
    """Phase 24's counts, once the card has done what was launched."""
    import torch

    from pytensor_tpu_torch.link.cuda import scan_kernel
    from pytensor_tpu_torch.tensor import fused_kernel

    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    return {"fused_elemwise": fused_kernel.LAUNCHES, "scan_whole_loop": scan_kernel.LAUNCHES}


def _near(got, want, rtol):
    """Whether ``got`` is within ``rtol`` of ``max(1, |want|)`` everywhere,
    equal infinities and NaNs agreeing."""
    got, want = (np.asarray(v.detach().double().cpu()) for v in (got, want))
    with np.errstate(invalid="ignore"):
        diff = np.where(got == want, 0.0, np.abs(got - want))
    return float((diff / np.maximum(1.0, np.abs(want))).max(initial=0.0)) <= rtol


def _guarded_radon(fns, cpu_fns, n, y, rng, dev, smi_line, launches, row):
    """Phase 24 (a), for each of ``CONTROL_DTYPES``: ``launches`` and
    ``row["guarded"]`` gain its counts and times."""
    import torch

    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.models.radon import DATA_MESSAGE, theta_start

    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    for dtype in CONTROL_DTYPES:
        fg, fu = fns["guarded", dtype], fns["unguarded", dtype]
        fa = fns.get(("asserts", dtype))
        nodes = {c: _count(fg, c) for c in ("IfElse", "CheckAndRaise")}
        cpu_nodes = {c: _count(cpu_fns["guarded", dtype], c) for c in ("IfElse", "CheckAndRaise")}
        if nodes != cpu_nodes or nodes != {"IfElse": 1, "CheckAndRaise": 1} or (
                fa is not None and (_count(fa, "IfElse"), _count(fa, "CheckAndRaise")) != (0, 1)):
            raise AssertionError(f"guarded radon {dtype}: nodes {nodes}, on the CPU {cpu_nodes}")
        if cuda and not all(isinstance(f.linked, CapturedFunction) for f in (fu, fa) if f):
            raise AssertionError(f"the unguarded and assert-only {dtype} functions must capture")
        if fg.linked.capturable or fg.linked.lazy is None:
            raise AssertionError(f"the guarded {dtype} function must run lazily and eagerly")
        th = (theta_start(n, dtype) + 0.1 * rng.standard_normal(n)).astype(dtype)
        th_d, y_d = as_torch(th, dev), as_torch(y.astype(dtype), dev)
        for f in (fu, fa or fu, fg):
            f(th_d, y_d)  # the capturing calls
        _control_reset()
        u_out = fu(th_d, y_d)
        cu = _control_counts()
        _control_reset()
        g_out = fg(th_d, y_d)
        cg = _control_counts()
        _control_reset()
        a_out = (fa or fu)(th_d, y_d)
        ca = _control_counts()
        # the model's K1 launches, the unguarded function's, and the guards'
        # own conditions' K1 nodes (a rehearsal on the CPU launches none)
        g_cond, g_assert = _guard_k1(fg)
        a_cond, a_assert = _guard_k1(fa or fu)
        k = cuda and 1
        if not (cg["fused_elemwise"] - k * (g_cond + g_assert) == cu["fused_elemwise"]
                == ca["fused_elemwise"] - k * a_assert and (cu["fused_elemwise"] > 0 or not cuda)
                and a_cond == 0):
            raise AssertionError(f"guarded radon {dtype}: K1 launches guarded {cg}, unguarded "
                                 f"{cu}, asserts {ca}; the guards' K1 nodes "
                                 f"{(g_cond, g_assert, a_assert)}")
        if not all(torch.equal(a, b) and torch.equal(a, c)
                   for a, b, c in zip(g_out, u_out, a_out)):
            raise AssertionError(f"guarded radon {dtype}: not the unguarded function's bits")
        want = cpu_fns["guarded", dtype](th, y.astype(dtype))
        if not all(_near(a, b, CONTROL_RTOL[dtype]) for a, b in zip(u_out, want)):
            raise AssertionError(f"guarded radon {dtype}: off the CPU's values")
        launches[f"control guarded {dtype}"] = cg
        launches[f"control unguarded {dtype}"] = cu
        if fa is not None:
            launches[f"control asserts {dtype}"] = ca
        bad = th.copy()
        bad[N_COUNTIES + 2] = np.nan
        _control_reset()
        b_out = fg(as_torch(bad, dev), y_d)
        cb = _control_counts()
        launches[f"control guarded {dtype}, NaN theta"] = cb
        if cb["fused_elemwise"] != k * g_cond or not (float(b_out[0]) == -np.inf
                                                      and not bool(b_out[1].any())):
            raise AssertionError(f"guarded radon {dtype} at a NaN theta: {cb}, logp "
                                 f"{float(b_out[0])}")
        bad_y = y.astype(dtype).copy()
        bad_y[100] = np.inf
        for tag, f in (("guarded, eager", fg), ("asserts, captured", fa))[:2 if fa else 1]:
            try:
                f(th_d, as_torch(bad_y, dev))
            except AssertionError as e:
                if DATA_MESSAGE not in str(e) or "Apply node that caused the error: Assert" \
                        not in str(e):
                    raise AssertionError(f"{tag}: the data assert's message {e}") from e
            else:
                raise AssertionError(f"guarded radon {dtype} {tag}: a failing data assert "
                                     f"did not raise")
        if not all(torch.equal(a, b) for a, b in zip((fa or fg)(th_d, y_d), u_out)):
            raise AssertionError("a guarded function after a failed call differs")
        r = {"k1_launches": cg["fused_elemwise"], "k1_launches_nan_theta": cb["fused_elemwise"],
             "k1_of_the_model": cu["fused_elemwise"],
             "k1_of_the_conditions": {"ifelse": g_cond, "asserts": g_assert}}
        if cuda:
            ms = {}
            for tag, f in (("unguarded", fu), ("asserts", fa), ("guarded", fg), ("guarded", fg),
                           ("asserts", fa), ("unguarded", fu)):
                if f is not None:
                    ms.setdefault(tag, []).append(wall_ms(lambda f=f: f(th_d, y_d),
                                                          CONTROL_CALLS))
            ms["guarded, NaN theta"] = [wall_ms(lambda: fg(as_torch(bad, dev), y_d),
                                                CONTROL_CALLS)]
            from torch.profiler import ProfilerActivity, profile

            with profile(activities=[ProfilerActivity.CPU]) as prof:
                fg(th_d, y_d)
                sync()
            reads = [e for e in prof.key_averages() if e.key == "aten::is_nonzero"]
            r.update(ms={k: v for k, v in ms.items()},
                     read_us=sum(e.cpu_time_total for e in reads),
                     reads=sum(e.count for e in reads))
            say(f"guarded radon {dtype} ({smi_line}): ms a call, unguarded captured "
                f"{ms['unguarded']}, asserts alone captured (with the flags' read) "
                f"{ms.get('asserts', 'not run')}, guarded eager {ms['guarded']}, guarded at a "
                f"NaN theta "
                f"{ms['guarded, NaN theta']}; the host's reads in a guarded call "
                f"(aten::is_nonzero, the condition's and the flags') {r['reads']}, "
                f"{r['read_us']:.1f} us")
        row["guarded"][dtype] = r
        say(f"guarded radon {dtype}: IfElse {nodes['IfElse']}, CheckAndRaise "
            f"{nodes['CheckAndRaise']} (the proven assert removed; as on the CPU); "
            f"K1 launches at a finite theta {cg['fused_elemwise']}: the unguarded function's "
            f"{cu['fused_elemwise']} and its bits, and the conditions' own fused nodes (the "
            f"IfElse's {g_cond}, the data assert's {g_assert}); asserts alone "
            f"{ca['fused_elemwise'] if fa else 'not run'}; at a NaN theta "
            f"{cb['fused_elemwise']} (the IfElse's "
            f"condition only), logp -inf, dlogp 0; the data assert raised its message from the "
            f"eager function{' and the captured one' if fa else ''}")


def phase_control(dev, smi_line, cpu):
    """Phase 24: the control and debug ops at the radon model's full width
    (919/85).  (a) The guarded radon function (``IfElse`` on a finite
    theta, the proven and the data assert) in float64 and float32: its
    ``IfElse`` and ``CheckAndRaise`` nodes as on the CPU; at a finite
    theta K1 launches as the unguarded function does, with its bits, and
    the conditions' own fused nodes; at a theta holding a NaN only the
    condition's, and ``-inf`` and zeros; a failing data assert raising
    its message and node, from the eager plan and from the float64
    assert-only function captured; ms a call of each (the guarded
    eager, the others replayed) and the condition's read in
    ``torch.profiler``.  (b) The nested ``ifelse``: its probe never runs in
    an untaken branch.  (c) ``DebugMode`` on the float64 radon function:
    every node against its oracle, each K1 node against its plain version
    on the CPU; a wrong lowering of a toy op raising ``BadThunkOutput``; a
    semantics-changing rewrite named by ``BadOptimization``.  (d)
    ``NanGuardMode`` naming the CPU's first node at a NaN theta.  (e)
    ``MonitorMode``'s callback seeing every node once a call.  (f) Each
    typed-list op on four thetas against the CPU, and whether its plan
    captures.  (g) ``PdbBreakpoint`` with its debugger replaced by a
    counter.  Counts are set to 0 just before each counted call and read
    just after.  Returns ``(launches, k1_abs, row)``."""
    import torch

    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.breakpoint import PdbBreakpoint
    from pytensor_tpu_torch.compile.debug import BadThunkOutput, DebugMode
    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.models.radon import theta_start
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    cuda = dev.type == "cuda"
    cpu_fns, _, _, _ = cpu

    secs, t0 = {}, time.perf_counter()

    def section(name):
        nonlocal t0
        secs[name] = round(time.perf_counter() - t0, 2)
        t0 = time.perf_counter()

    fns, n, y, seen = control_functions(dev)
    section("link")
    rng = np.random.default_rng(CONTROL_SEED)
    launches, row, k1_abs = {}, {"guarded": {}}, 0.0
    # (a) the guarded radon function, under torch's deterministic algorithms
    # (dlogp's index_add_ otherwise adds in any order on the card), its
    # captures included -------------------------------------------------------------------
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        _guarded_radon(fns, cpu_fns, n, y, rng, dev, smi_line, launches, row)
    finally:
        torch.use_deterministic_algorithms(False)
    for dtype in CONTROL_DTYPES:
        fg = fns["guarded", dtype]
        th = as_torch((theta_start(n, dtype) + 0.1 * rng.standard_normal(n)).astype(dtype), dev)
        k1_abs = max(k1_abs, k1_nodes_held(fg, (th, as_torch(y.astype(dtype), dev)), dev,
                                           f"guarded {dtype}", quiet=True))
    section("guarded")
    # (b) the nested ifelse ---------------------------------------------------------------
    x = as_torch(rng.standard_normal(n), dev)
    probe_calls, nested_k1 = [], []
    for c1, c2, want_calls in ((True, True, 0), (False, False, 0), (False, True, 1)):
        CountingProbe.calls = 0
        _control_reset()
        out = fns["nested"](np.bool_(c1), np.bool_(c2), x)
        c = _control_counts()
        want = (x.exp() + 1.0) if c1 else (x * 2.0 if c2 else x - 1.0)
        if CountingProbe.calls != want_calls or not torch.allclose(out, want, rtol=1e-12):
            raise AssertionError(f"nested ifelse ({c1}, {c2}): probe calls "
                                 f"{CountingProbe.calls}, launches {c}")
        probe_calls.append(CountingProbe.calls)
        nested_k1.append(c["fused_elemwise"])
        launches[f"control nested ifelse {c1} {c2}"] = c
    section("nested")
    say(f"nested ifelse: probe calls {probe_calls} for (c1, c2) = (T, T), (F, F), (F, T); "
        f"K1 launches {nested_k1}")
    # (c) DebugMode ------------------------------------------------------------------------
    th64 = as_torch(theta_start(n, "float64") + 0.1 * rng.standard_normal(n), dev)
    fd = fns["DebugMode"]
    _control_reset()
    fd(th64)
    cd = _control_counts()
    holds = fd.linked.holds
    if [h[0] for h in holds] != fd.fgraph.toposort():
        raise AssertionError("DebugMode held not every node")
    k1_holds = [(h, err) for nd, h, err in holds if isinstance(nd.op, FusedElemwise)]
    if not k1_holds or any(h != "the CPU lowering" for h, _ in k1_holds) or (
            cuda and cd["fused_elemwise"] != len(k1_holds)):
        raise AssertionError(f"DebugMode's K1 holds {k1_holds}, launches {cd}")
    k1_debug = max(err for _, err in k1_holds)
    k1_abs = max(k1_abs, k1_debug)
    launches["control DebugMode"] = cd
    debug_ms = wall_ms(lambda: fd(th64), 3) if cuda else float("nan")
    w = pt.dvector("w")
    wrong = ptt.function([w], CountingProbe.wrong(w), mode=DebugMode(), device=dev)
    try:
        wrong(np.ones(3))
    except BadThunkOutput:
        pass
    else:
        raise AssertionError("DebugMode passed a wrong lowering")
    blamed = _blamed_rewrite(dev)
    if "evil_exp_scale" not in blamed:
        raise AssertionError(f"BadOptimization named {blamed!r}")
    section("DebugMode")
    row["debug_mode"] = {"nodes": len(holds), "k1_nodes": len(k1_holds),
                         "k1_max_abs_err": k1_debug, "ms": debug_ms}
    say(f"DebugMode on the float64 radon function: {len(holds)} nodes held against their oracle "
        f"({sum(h == 'perform' for _, h, _ in holds)} by perform, "
        f"{sum(h != 'perform' for _, h, _ in holds)} by the CPU lowering), {len(k1_holds)} K1 "
        f"nodes against their plain version, largest abs difference {k1_debug:.3e}; "
        f"{cd['fused_elemwise']} K1 launches a call; {debug_ms:.2f} ms a call; a wrong lowering "
        f"raised BadThunkOutput; BadOptimization named {blamed.split(': ')[-1]}")
    # (d) NanGuardMode, (e) MonitorMode -------------------------------------------------------
    fn_guard = fns["NanGuardMode"]
    nan_th = th64.clone()
    nan_th[N_COUNTIES + 1] = float("nan")
    messages = []
    for f, arg in ((fn_guard, nan_th), (cpu_fns["NanGuardMode"], nan_th.cpu())):
        try:
            f(arg)
        except AssertionError as e:
            messages.append(str(e))
        else:
            raise AssertionError("NanGuardMode passed a NaN theta")
    if messages[0] != messages[1] or "NanGuardMode: NaN detected" not in messages[0]:
        raise AssertionError(f"NanGuardMode's messages {messages}")
    want = fd(th64)
    got = fn_guard(th64)
    if not all(_near(a, b, CONTROL_RTOL["float64"]) for a, b in zip(got, want)):
        raise AssertionError("NanGuardMode's values off DebugMode's")
    guard_ms = wall_ms(lambda: fn_guard(th64), 5) if cuda else float("nan")
    seen.clear()
    fns["MonitorMode"](th64)
    order = fns["MonitorMode"].fgraph.toposort()
    if seen != order:
        raise AssertionError(f"MonitorMode saw {len(seen)} nodes of {len(order)}")
    row["nan_guard_ms"] = guard_ms
    section("NanGuardMode, MonitorMode")
    say(f"NanGuardMode: at a NaN theta it raised as on the CPU ({messages[0][:90]}...); "
        f"{guard_ms:.2f} ms a call at a finite theta; MonitorMode's callback saw each of the "
        f"{len(order)} nodes once a call")
    # (f) typed lists ------------------------------------------------------------------------
    thetas = [rng.standard_normal(n) for _ in range(CONTROL_LIST_LEN)]
    args = [as_torch(t, dev) for t in thetas] + [np.int64(3)]
    captures = {}
    for tag in [k for k in fns if isinstance(k, str) and k.startswith("list ")]:
        f = fns[tag]
        got, want = f(*args), cpu_fns[tag](*thetas, np.int64(3))
        got = got if isinstance(got, list) else [got]
        want = want if isinstance(want, list) else [want]
        if len(got) != len(want) or not all(torch.equal(a.cpu(), b) for a, b in zip(got, want)):
            raise AssertionError(f"typed {tag}: differs from the CPU")
        captures[tag[5:]] = isinstance(f.linked, CapturedFunction)
    row["typed_lists_capture"] = captures
    section("typed lists")
    say(f"typed lists of {CONTROL_LIST_LEN} thetas on the card, each op's value the CPU's; "
        f"captured: {captures}")
    # (g) PdbBreakpoint --------------------------------------------------------------------------
    fired = []
    real = PdbBreakpoint.debugger
    PdbBreakpoint.debugger = staticmethod(lambda name, monitored: fired.append(
        (name, monitored)))
    try:
        pos = as_torch(np.abs(thetas[0]) + 0.1, dev)
        fns["breakpoint"](-pos)
        if fired:
            raise AssertionError("the breakpoint fired where its condition is false")
        outs = fns["breakpoint"](pos)
    finally:
        PdbBreakpoint.debugger = real
    if len(fired) != 1 or not (np.array_equal(fired[0][1][0], (pos * 2.0).cpu().numpy())
                               and np.array_equal(fired[0][1][1], outs[1].cpu().numpy())):
        raise AssertionError(f"the breakpoint fired {len(fired)} times")
    section("PdbBreakpoint")
    row["seconds"] = secs
    say(f"PdbBreakpoint: fired once, where its condition held, with the card's values "
        f"({[m.shape for m in fired[0][1]]}); phase 24's seconds by part {secs}")
    return launches, k1_abs, row


def _blamed_rewrite(dev):
    """The rewrite ``BadOptimization`` names for ``exp(x) + 1`` under
    ``DebugMode`` with a rewrite that scales ``exp`` registered at optdb
    47.5 (``tests/test_more.py:282``), unregistered after."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.compile.debug import BadOptimization, DebugMode
    from pytensor_tpu_torch.compile.mode import optdb
    from pytensor_tpu_torch.graph.rewriting.basic import node_rewriter
    from pytensor_tpu_torch.graph.rewriting.db import EquilibriumDB
    from pytensor_tpu_torch.scalar import basic as ps
    from pytensor_tpu_torch.tensor.basic import constant
    from pytensor_tpu_torch.tensor.elemwise import Elemwise

    @node_rewriter([Elemwise])
    def evil_exp_scale(fgraph, node):
        if getattr(node.op.scalar_op, "name", None) != "exp" or getattr(node.tag, "evil", False):
            return False
        new = Elemwise(ps.exp)(*node.inputs)
        new.owner.tag.evil = True
        return [new * constant(np.float64(1.5))]

    db = EquilibriumDB(name="evil")
    db.register("evil_exp_scale", evil_exp_scale, "evil_tag_test")
    optdb.register("evil_test", db, position=47.5)
    try:
        x = pt.dvector("x")
        f = ptt.function([x], pt.exp(x) + 1.0, mode=DebugMode().including("evil_tag_test"),
                         device=dev)
        try:
            f(np.ones(3))
        except BadOptimization as e:
            return str(e)
        return ""
    finally:
        del optdb._names["evil_test"]
        del optdb._tags["evil_test"]
        del optdb.positions["evil_test"]


# --- 25. the sparse slice -------------------------------------------------------------

# the seed of the sparse slice's data (models/sparse_learning.py,
# link/cuda/sparse_cases.py make_data)
SPARSE_SEED = 25
# float32 against the same function on the CPU and against float64
# scipy/NumPy (a loss relative): (a) over max(1, max|ref|), sums ten
# products a row and 2**20 squares; (b) ``W`` and ``b`` over their own
# largest magnitude (two steps from zero leave max|W| far under 1: a limit
# over max(1, ...) would pass a W never updated), 158 a row and 11,314 rows
# a class over two steps; the rows over max(1, max|ref|), at most ten a
# row; the card adds duplicates and rows in other orders (index_add_ by
# atomics)
SPARSE_PATH_TOL = {"edge_loss": 1e-5, "edge_grad": 1e-5, "tfidf_loss": 1e-5,
                   "tfidf_params": 2e-5, "rows": 1e-5}
# (b)'s SGD steps before the hold; the calls a row's wall time is taken over
TFIDF_STEPS, SPARSE_CALLS = 2, 5
# the host's reads of the device in a call, by torch.profiler span: an
# item read, a bool read, and the ops whose output size a read gives
READ_SPANS = ("aten::_local_scalar_dense", "aten::is_nonzero", "aten::nonzero",
              "aten::unique_consecutive")


def sparse_data(seed=SPARSE_SEED, sizes=None):
    """Phase 25's data from one seed: the rows' (``sparse_cases.make_data``,
    which holds (a)'s pattern, ``w``, ``X`` and ``T``) and (b)'s tf-idf
    matrix with its one-hot targets."""
    from pytensor_tpu_torch.link.cuda import sparse_cases
    from pytensor_tpu_torch.models.sparse_learning import tfidf_matrix

    sizes = sizes or sparse_cases.FULL
    d = sparse_cases.make_data(sizes, seed)
    d["X"], d["targets"] = tfidf_matrix(sizes["docs"], sizes["terms"], sizes["per_doc"],
                                        seed=seed + 1)
    return d


def sparse_functions(dev, d):
    """(a)'s function and (b)'s step with its shared ``W`` and ``b``,
    linked for ``dev`` on ``d``'s pattern and sizes."""
    from pytensor_tpu_torch.models.sparse_learning import make_edge_weights, make_tfidf_step

    f_a = make_edge_weights(d["A"], d["Y"].shape[1], device=dev)
    f_b, W, b = make_tfidf_step(d["X"].shape[1], d["targets"].shape[1], device=dev)
    return f_a, (f_b, W, b)


def sparse_cpu_reference(seed=SPARSE_SEED, sizes=None):
    """Phase 25's references, at the phase's start (in the references'
    process beside phases 3-24 they ran with phase 12's eager calls and
    slowed them 30-fold): the data, and for (a), (b) and each row the same
    function on the CPU (the port's lowerings) and float64 scipy/NumPy,
    with the control of (b): ``W`` after the steps with its gradient's
    data term zeroed.  Returns a dict of numpy values."""
    from pytensor_tpu_torch.link.cuda import sparse_cases
    from pytensor_tpu_torch.models.sparse_learning import (
        edge_weights_reference,
        tfidf_reference,
    )

    t0 = time.perf_counter()
    d = sparse_data(seed, sizes)
    f_a, (f_b, W, b) = sparse_functions("cpu", d)
    loss, grad = f_a(d["w"], d["Y"], d["Z"])
    edge = {"cpu": (float(loss), grad.numpy()),
            "scipy": edge_weights_reference(d["A"], d["w"], d["Y"], d["Z"])}
    cpu_losses = [float(f_b(d["X"], d["targets"])) for _ in range(TFIDF_STEPS)]
    Wr, br, ref_losses = np.zeros(W.get_value().shape), np.zeros(b.get_value().shape), []
    Wc, bc = Wr, br
    for _ in range(TFIDF_STEPS):
        lo, Wr, br = tfidf_reference(d["X"], d["targets"], Wr, br)
        ref_losses.append(lo)
        _, Wc, bc = tfidf_reference(d["X"], d["targets"], Wc, bc, data_grad=False)
    tfidf = {"cpu": (cpu_losses, W.get_value().numpy(), b.get_value().numpy()),
             "numpy": (ref_losses, Wr, br), "control": Wc}
    rows = {}
    for row in sparse_cases.ROWS:
        out = sparse_cases.row_function(row, d, "cpu")(*row.args(d))
        rows[row.name] = ([sparse_cases.output(o) for o in (out if isinstance(out, list)
                                                             else [out])],
                          [sparse_cases.output(r) for r in row.reference(d)])
    return {"data": d, "edge": edge, "tfidf": tfidf, "rows": rows,
            "seconds": time.perf_counter() - t0}


def sparse_kernels(dev):
    """The K1 kernels of phase 25's functions, from (a)'s function and (b)'s
    step linked for the CPU on small data of the same graphs (phase 2's
    pool); the rows hold no fused node (``tests/test_torch_sparse_paths.py``)."""
    from pytensor_tpu_torch.link.cuda import sparse_cases

    d = sparse_data(SPARSE_SEED, sparse_cases.SMALL)
    f_a, (f_b, _, _) = sparse_functions("cpu", d)
    kerns: dict = {}
    for f in (f_a, f_b):
        plan_kernels(f.linked, dev, kerns)
    return list(kerns.values())


def _top_kernels(by, n=5):
    """The ``n`` kernels that take the most device time a call, from
    ``device_ms``'s split: ``(ms, launches, name)``."""
    return [(ms, c, name[:90]) for name, (ms, c) in sorted(by.items(),
                                                            key=lambda kv: -kv[1][0])[:n]]


def read_spans(call):
    """The spans of ``READ_SPANS`` in one call's trace of the host, by name
    (those that occur)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    found = {e.key: e.count for e in prof.key_averages() if e.key in READ_SPANS}
    return {k: found[k] for k in READ_SPANS if k in found}


def _sparse_on(dev, value):
    """A row's input on ``dev``: a scipy matrix as a torch sparse csr
    tensor, an array as a tensor."""
    import scipy.sparse as sp
    import torch

    from pytensor_tpu_torch.link.torch.convert import as_torch, canonical_csr

    if sp.issparse(value):
        indptr, indices, data = canonical_csr(value)
        return torch.sparse_csr_tensor(as_torch(indptr, dev), as_torch(indices, dev),
                                       as_torch(data, dev), value.shape)
    return as_torch(np.asarray(value), dev)


def phase_sparse(dev, smi_line, reference):
    """Phase 25: the sparse slice (ROADMAP Queue 1 item 13) through the
    public sparse API at full size.  (a) Learned edge weights on
    ``benchsuite.py:160``'s 65,536² pattern (ten a row, float32; width 16):
    the rewritten ops, whether ``local_csm_grad_same_pattern`` fired, the
    plan captured with one replay a call, K1 launches a call (counts set
    to 0 just before, read just after), ms a call (wall and device) and
    busy share, loss and gradient held against the CPU and float64 scipy.
    (b) The tf-idf softmax-regression SGD step (11,314 x 130,107, ~158 a
    row, 20 classes): captured or not with the reason, K1 launches, ms a
    step, ``W`` and ``b`` after ``TFIDF_STEPS`` steps against the CPU and
    float64 NumPy.  Each K1 node of (a) and (b) against its plain version.
    (c) One function a row of ``link/cuda/sparse_cases.py``: ms a call,
    captured or eager with the op that reads back, the host's reads of a
    call in ``torch.profiler`` (``READ_SPANS``), the result against the CPU
    and scipy (dense values; the structure where scipy's is canonical).
    On the CPU (a rehearsal) the times and traces are left out.  Returns
    ``(launches, k1_abs, row)``."""
    import torch

    from pytensor_tpu_torch.link.cuda import sparse_cases
    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.link.torch.linker import CapturedFunction
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    cuda = dev.type == "cuda"
    t_phase = time.perf_counter()
    ref = reference
    d = ref["data"]
    launches, out_row, k1_abs = {}, {"rows": {}}, 0.0

    def plan_of(f):
        return f.linked.plan if isinstance(f.linked, CapturedFunction) else f.linked

    def err(got, want, floor=1.0):
        got, want = np.asarray(got, "float64"), np.asarray(want, "float64")
        return float(np.abs(got - want).max(initial=0.0)
                     / max(floor, float(np.abs(want).max(initial=0.0))))

    # (a) learned edge weights ---------------------------------------------------------------
    counts, undo = fired_rewrites()
    try:
        f_a, (f_b, W, b) = sparse_functions(dev, d)
    finally:
        undo()
    fired = counts["local_csm_grad_same_pattern"]
    ops_a = sorted(type(nd.op).__name__ for nd in f_a.fgraph.apply_nodes)
    plan = plan_of(f_a)
    if cuda and not (isinstance(f_a.linked, CapturedFunction) and plan.capturable):
        raise AssertionError(f"edge weights: not captured: {plan.host_reads}")
    args = [as_torch(d["w"], dev), as_torch(d["Y"], dev), as_torch(d["Z"], dev)]
    f_a(*args)  # the capturing call
    _control_reset()
    loss, grad = f_a(*args)
    c = _control_counts()
    launches["sparse edge weights"] = c
    graphs = len(getattr(f_a.linked, "graphs", {}))
    if cuda and graphs != 1:
        raise AssertionError(f"edge weights: {graphs} captures, one expected")
    (cpu_loss, cpu_grad), (ref_loss, ref_grad) = ref["edge"]["cpu"], ref["edge"]["scipy"]
    checks = {"loss_cpu": abs(float(loss) - cpu_loss) / abs(cpu_loss),
              "loss_scipy": abs(float(loss) - ref_loss) / abs(ref_loss),
              "grad_cpu": err(grad.cpu(), cpu_grad), "grad_scipy": err(grad.cpu(), ref_grad)}
    if not (max(checks["loss_cpu"], checks["loss_scipy"]) <= SPARSE_PATH_TOL["edge_loss"]
            and max(checks["grad_cpu"], checks["grad_scipy"]) <= SPARSE_PATH_TOL["edge_grad"]):
        raise AssertionError(f"edge weights: {checks} over {SPARSE_PATH_TOL}")
    k1_abs = max(k1_abs, k1_nodes_held(f_a, args, dev, "edge weights", quiet=True))
    edge = {"ops": ops_a, "same_pattern_fired": fired, "captured": plan.capturable,
            "k1_launches": c["fused_elemwise"], "errors": checks}
    if cuda:
        wall = wall_ms(lambda: f_a(*args), 10)
        dev_ms, by = device_ms(lambda: f_a(*args), 3)
        edge.update(wall_ms=wall, device_ms=dev_ms, busy=dev_ms / wall,
                    kernels=sum(n for _, n in by.values()), top=_top_kernels(by))
    out_row["edge_weights"] = edge
    say(f"sparse (a) edge weights {d['A'].shape[0]:,}^2, {d['A'].nnz:,} stored, width "
        f"{d['Y'].shape[1]} ({smi_line}): ops {ops_a}; local_csm_grad_same_pattern fired "
        f"{fired} times; captured {plan.capturable} ({graphs} capture, replays after); K1 "
        f"{c['fused_elemwise']} launches a call; "
        + (f"wall {edge['wall_ms']:.4f} ms/call, device {edge['device_ms']:.4f} ms, busy "
           f"{edge['busy']:.3f}, {edge['kernels']:.0f} kernels a call; " if cuda else "")
        + f"loss {float(loss):.6e} vs CPU {cpu_loss:.6e}, scipy {ref_loss:.6e}; errors "
        f"{_fmt(checks)} (tol {SPARSE_PATH_TOL['edge_loss']:g}, {SPARSE_PATH_TOL['edge_grad']:g})")
    # (b) the tf-idf softmax-regression step -------------------------------------------------
    X, Y = _sparse_on(dev, d["X"]), as_torch(d["targets"], dev)
    plan = plan_of(f_b)
    losses = [float(f_b(X, Y)) for _ in range(TFIDF_STEPS)]
    (cpu_losses, cpu_W, cpu_b), (ref_losses, ref_W, ref_b) = (ref["tfidf"]["cpu"],
                                                              ref["tfidf"]["numpy"])
    Wv, bv = W.get_value().cpu(), b.get_value().cpu()
    # W and b over their own largest magnitude
    checks = {"loss_cpu": max(abs(a - e) / abs(e) for a, e in zip(losses, cpu_losses)),
              "loss_numpy": max(abs(a - e) / abs(e) for a, e in zip(losses, ref_losses)),
              "W_cpu": err(Wv, cpu_W, 0.0), "W_numpy": err(Wv, ref_W, 0.0),
              "b_cpu": err(bv, cpu_b, 0.0), "b_numpy": err(bv, ref_b, 0.0)}
    # the control: W after the same steps with its gradient's data term
    # zeroed (the sparse products and Transpose), which the hold must refuse
    control = err(ref["tfidf"]["control"], ref_W, 0.0)
    if not (max(checks["loss_cpu"], checks["loss_numpy"]) <= SPARSE_PATH_TOL["tfidf_loss"]
            and max(v for k, v in checks.items() if not k.startswith("loss"))
            <= SPARSE_PATH_TOL["tfidf_params"] < control):
        raise AssertionError(f"tf-idf step: {checks}, control {control} over "
                             f"{SPARSE_PATH_TOL}")
    k1_abs = max(k1_abs, k1_nodes_held(f_b, [X, Y] + [v.get_value() for v in f_b.shared_vars],
                                       dev, "tf-idf step", quiet=True))
    _control_reset()
    f_b(X, Y)
    c = _control_counts()
    launches["sparse tf-idf step"] = c
    fused = sum(isinstance(nd.op, FusedElemwise) for nd in f_b.fgraph.apply_nodes)
    if cuda and c["fused_elemwise"] != fused:
        raise AssertionError(f"tf-idf step: {c} launches, K1 once a fused node ({fused})")
    tfidf = {"captured": isinstance(f_b.linked, CapturedFunction), "host_reads": plan.host_reads,
             "k1_launches": c["fused_elemwise"], "losses": losses, "errors": checks,
             "max_W": float(np.abs(ref_W).max()), "max_b": float(np.abs(ref_b).max()),
             "control": control}
    if cuda:
        tfidf["wall_ms"] = wall_ms(lambda: f_b(X, Y), SPARSE_CALLS)
        tfidf["device_ms"], by = device_ms(lambda: f_b(X, Y), 2)
        tfidf["top"] = _top_kernels(by)
    out_row["tfidf_step"] = tfidf
    for tag, r in (("(a)", edge), ("(b)", tfidf)):
        for ms, n, name in r.get("top", []):
            say(f"  sparse {tag}: {ms:.4f} ms/call  {n:.0f} launches/call  {name}")
    say(f"sparse (b) tf-idf step {d['X'].shape[0]:,} x {d['X'].shape[1]:,}, {d['X'].nnz:,} "
        f"stored, {d['targets'].shape[1]} classes ({smi_line}): captured {tfidf['captured']}"
        + (f" (reads: {plan.host_reads})" if plan.host_reads else " (no host read)")
        + f"; K1 {c['fused_elemwise']} launches a step ({fused} fused nodes); "
        + (f"{tfidf['wall_ms']:.4f} ms a step wall, {tfidf['device_ms']:.4f} device; "
           if cuda else "")
        + f"losses {[f'{v:.7f}' for v in losses]} vs NumPy {[f'{v:.7f}' for v in ref_losses]}; "
        f"errors {_fmt(checks)}, W and b over max|W| {tfidf['max_W']:.4e} and max|b| "
        f"{tfidf['max_b']:.4e} (tol {SPARSE_PATH_TOL['tfidf_params']:g}); the control (W "
        f"without its gradient's data term) reads {control:.3e}")
    # (c) one function a row ------------------------------------------------------------------
    for row in sparse_cases.ROWS:
        f = sparse_cases.row_function(row, d, dev)
        plan = plan_of(f)
        captured = isinstance(f.linked, CapturedFunction)
        reads_by = sorted({r.split("(")[0] for r in plan.host_reads})
        if reads_by != ([row.reads] if row.reads else []) or (cuda and captured
                                                              != (row.reads is None)):
            raise AssertionError(f"{row.name}: captured {captured}, reads {plan.host_reads}")
        a = [_sparse_on(dev, v) for v in row.args(d)]
        f(*a)  # a capturing call where the plan captures
        out = f(*a)
        out = out if isinstance(out, list) else [out]
        cpu_out, ref_out = ref["rows"][row.name]
        got = [sparse_cases.output(o) for o in out]
        errs = [max(sparse_cases.held(g, c_), sparse_cases.held(g, r_))
                for g, c_, r_ in zip(got, cpu_out, ref_out)]
        if not max(errs) <= SPARSE_PATH_TOL["rows"]:
            raise AssertionError(f"{row.name}: errors {errs} (inf: the structure differs)")
        r = {"op": row.op, "captured": captured, "reads_back": row.reads, "max_err": max(errs)}
        if cuda:
            r["ms"] = wall_ms(lambda: f(*a), SPARSE_CALLS)
            r["host_reads"] = read_spans(lambda: f(*a))
        out_row["rows"][row.name] = r
        say(f"sparse (c) {row.name}: "
            + (f"{r['ms']:.4f} ms a call; " if cuda else "")
            + ("captured" if captured else f"eager: {row.reads} reads back" if row.reads
               else "eager")
            + (f"; host reads a call {r['host_reads'] or 'none'}" if cuda else "")
            + f"; against the CPU and scipy {max(errs):.2e} (tol {SPARSE_PATH_TOL['rows']:g}), "
            f"the structure equal")
    out_row["seconds"] = round(time.perf_counter() - t_phase, 2)
    say(f"sparse phase done in {out_row['seconds']:.1f} s ({smi_line}), after its CPU "
        f"references' {ref['seconds']:.1f} s")
    return launches, k1_abs, out_row


def _radon_io():
    from pytensor_tpu_torch.models.radon import make_radon_graphs

    ins, outs, _ = make_radon_graphs(N_OBS, N_COUNTIES, "float64")
    return ins, outs


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
    from pytensor_tpu_torch.sparse import as_sparse_variable, structured_dot
    from pytensor_tpu_torch.sparse.spmv import RoutedSpMV
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

    lap = Laps()
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

    lap(1)
    # 2. build --------------------------------------------------------------
    # each build starts as soon as its source exists, beside the emission of
    # the later slices' graphs (nvcc runs in processes of its own)
    def timed(fn):
        t = time.perf_counter()
        fn()
        return time.perf_counter() - t

    pool = ThreadPoolExecutor(32)
    k1_jobs: list = []

    def build_k1(*libraries):
        k1_jobs.extend(pool.submit(fused_kernel.build, kerns, verbose=True)
                       for kerns in libraries)

    jobs = {"K3": pool.submit(timed, lambda: radon_kernel.build(verbose=True)),
            "K3, rows in shared memory": pool.submit(timed, lambda: radon_kernel.build(
                verbose=True, flags=K3_SHARED_WALK)),
            "K4": pool.submit(timed, lambda: spmv_kernel.build(verbose=True)),
            **loop_builds(pool, timed)}
    # K2 for the leapfrog chain at full width: the Scan node of the linked
    # 64-step chain (the 8,192-step chain has the same body, so the same
    # source and library)
    t0 = time.perf_counter()
    chain64 = make_leapfrog_chain("float32", None, K2_STEPS, N_OBS, N_COUNTIES, device=dev)
    scan_node = next(nd for nd in chain64.fgraph.apply_nodes if isinstance(nd.op, Scan))
    k2 = scan_kernel.ScanKernel(scan_node.op, scan_node, dev)
    jobs["K2"] = pool.submit(timed, lambda: k2.build(verbose=True))
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
    build_k1(*k1_kernels.values())

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
    build_k1(list(op_kerns.values()), model_kerns)
    jobs.update({f"K2 case: {tag}": pool.submit(timed, lambda k=k: k.build(verbose=True))
                 for tag, _, _, k, _ in k2_cases})
    say(f"the slice's graphs: {len(op_kerns)} K1 op groups, {len(k2_cases)} K2 cases, "
        f"{len(model_kerns)} K1 kernels of the logreg and MFU steps; graph, rewrite and emit in "
        f"{time.perf_counter() - t0:.2f} s")
    # the Elman slice's: the step's K1 kernels and K2 of the static BPTT's
    # forward scan (phase 12 finds them built)
    t0 = time.perf_counter()
    elman_k1, elman_k2 = elman_kernels(dev)
    build_k1(elman_k1)
    jobs.update({"K2 static BPTT": pool.submit(timed, lambda k=k: k.build(verbose=True))
                 for k in elman_k2})
    say(f"the Elman slice's graphs: {len(elman_k1)} K1 kernels of the step, {len(elman_k2)} K2 "
        f"kernel of the static BPTT; graph, rewrite and emit in {time.perf_counter() - t0:.2f} s")
    # the linalg slice's: the K1 kernels of paths (a)-(c) (phase 13)
    t0 = time.perf_counter()
    linalg_k1 = linalg_kernels(dev)
    build_k1(linalg_k1)
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
    build_k1(*special_libs, list(special_group_kerns.values()))
    jobs.update({"K2 bessel loop": pool.submit(timed, lambda k=k: k.build(verbose=True))
                 for k in special_k2})
    say(f"the special slice's graphs: {len(special_one_node)} one-node K1 kernels in "
        f"{len(special_libs) - 1} libraries, {sum(map(len, special_libs[-1:]))} K1 kernels of the "
        f"bessel paths, {len(special_group_kerns)} K1 op groups, {len(special_k2)} K2 kernel; "
        f"graph, rewrite and emit in {time.perf_counter() - t0:.2f} s")

    # the bfloat16 phase's (15): K1 on every op of its table in bfloat16, one
    # node a kernel, the MFU class node, the bfloat16 MFU step's K1 kernels
    # and K2 of the EWMA in bfloat16 and float32
    t0 = time.perf_counter()
    bf16_one_node, bf16_cls, bf16_model_k1, bf16_k2 = bf16_kernels(dev)
    build_k1([k for k, _ in bf16_one_node.values()] + [bf16_cls], bf16_model_k1)
    jobs.update({f"K2 ewma {dt}": pool.submit(timed, lambda k=k: k.build(verbose=True))
                 for dt, k in bf16_k2.items()})
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
    build_k1(tail_k1 + list(tail_signs.values()))
    jobs.update({f"K2 scan {kind}": pool.submit(timed, lambda k=k: k.build(verbose=True))
                 for kind, k in tail_k2.items()})
    say(f"the tail slice's graphs: {len(tail_k1)} K1 kernels, {len(tail_signs)} floor-division "
        f"nodes, {len(tail_k2)} K2 kernel(s) of the scan rows not built for another phase; "
        f"graph, rewrite and emit in {time.perf_counter() - t0:.2f} s")

    # phase 17's: the K1 kernels of the MAP's and the periodogram's
    # functions (their plans' and the plans inside BFGS and Newton) and
    # every complex op K1 emits, one node a kernel, a library a dtype
    t0 = time.perf_counter()
    opt_k1, complex_one_node = optimize_kernels(dev)
    build_k1(opt_k1, *[[k for (_, d), k in complex_one_node.items() if d == dt]
                       for dt in ("complex64", "complex128")])
    say(f"the optimize slice's graphs: {len(opt_k1)} K1 kernels of the MAP's and the "
        f"periodogram's functions, {len(complex_one_node)} one-node complex K1 kernels; graph, "
        f"rewrite and emit in {time.perf_counter() - t0:.2f} s")

    # phase 18's: the K1 kernels of the three HMC functions, from the same
    # functions linked for the CPU (phase 18's reference); threefry is
    # built in the pool below
    t0 = time.perf_counter()
    random_k1, _ = random_kernels(dev)
    build_k1(random_k1)
    say(f"the random slice's graphs: {len(random_k1)} K1 kernels of the HMC functions; graph, "
        f"rewrite and link for the CPU in {time.perf_counter() - t0:.2f} s")
    # phase 20's: the censored function's K1 kernels, from it linked for the CPU
    t0 = time.perf_counter()
    censored_k1, _ = censored_kernels(dev)
    build_k1(censored_k1)
    say(f"the censored slice's graph: {len(censored_k1)} K1 kernels; graph, rewrite and link for "
        f"the CPU in {time.perf_counter() - t0:.2f} s")
    # phase 21's: the while-scan functions' K1 kernels, from them linked for
    # the CPU, and the power iteration's tolerance from the float64 loop
    t0 = time.perf_counter()
    while_set = while_setup()
    while_k1 = while_kernels(dev, while_set)
    build_k1(while_k1)
    say(f"the while-scan slice's graphs: {len(while_k1)} K1 kernels; the float64 power loop, "
        f"graph, rewrite and link for the CPU in {time.perf_counter() - t0:.2f} s")
    # phase 22's: the K1 kernels of the compile driver's radon functions (the
    # Hessian-vector product's are new), from them linked for the CPU
    t0 = time.perf_counter()
    compile_k1, compile_cpu = compile_kernels(dev)
    build_k1(compile_k1)
    say(f"the compile driver's graphs: {len(compile_k1)} K1 kernels; graph, rewrite and link for "
        f"the CPU in {time.perf_counter() - t0:.2f} s")
    # phase 23's: the K1 kernels of the probe graphs and the Print function,
    # from them linked for the CPU, with the probe graphs' node counts
    t0 = time.perf_counter()
    graph_k1, graph_nodes = graph_kernels(dev)
    build_k1(graph_k1)
    say(f"the graph layer's probe graphs: {len(graph_k1)} K1 kernels of {len(graph_nodes)} "
        f"graphs; graph, rewrite and link for the CPU in {time.perf_counter() - t0:.2f} s")
    # phase 24's: the K1 kernels of the guarded radon functions and the
    # debug modes', from them linked for the CPU (phase 24's references)
    t0 = time.perf_counter()
    control_k1, control_cpu = control_kernels(dev)
    build_k1(control_k1)
    say(f"the control and debug functions: {len(control_k1)} K1 kernels; graph, rewrite and link "
        f"for the CPU in {time.perf_counter() - t0:.2f} s")
    # phase 25's: the K1 kernels of the sparse paths' functions, linked for
    # the CPU on small data of the same graphs
    t0 = time.perf_counter()
    sparse_k1 = sparse_kernels(dev)
    build_k1(sparse_k1)
    say(f"the sparse slice's functions: {len(sparse_k1)} K1 kernels; graph, rewrite and link for "
        f"the CPU in {time.perf_counter() - t0:.2f} s")

    build_s = {tag: job.result() for tag, job in jobs.items()}
    for job in k1_jobs:
        job.result()
    pool.shutdown()
    logs = {"K3": radon_kernel.BUILD_LOGS[()],
            "K3, rows in shared memory": radon_kernel.BUILD_LOGS[K3_SHARED_WALK],
            "K2": k2.build_log, "K4": spmv_kernel.BUILD_LOG,
            **loop_build_logs(build_s),
            **{f"K2 case: {tag}": k.build_log for tag, _, _, k, _ in k2_cases},
            **{"K2 static BPTT": k.build_log for k in elman_k2},
            **{"K2 bessel loop": k.build_log for k in special_k2},
            **{f"K2 ewma {dt}": k.build_log for dt, k in bf16_k2.items()},
            **{f"K2 scan {kind}": k.build_log for kind, k in tail_k2.items()}}
    say_builds(logs, build_s)
    # the references of phases 18 and 20 on the host's CPU, beside phases 3-19
    _, hmc_reference, censored_reference = start_references()
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

    lap(2)
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

    lap(3)
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
    say(f"K3 threads a block {radon_kernel.build().radon_leapfrog_threads(N_COUNTIES)}, largest "
        f"county {fn3.data.max_rows} rows; the same kernel walking every county from shared "
        f"memory: bit-identical")

    lap(4)
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

    lap(5)
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

    lap(6)
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

    lap(7)
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
    long_chain = make_leapfrog_chain("float64", None, LONG_CAPTURE_STEPS, N_OBS, N_COUNTIES,
                                     device=dev)
    th64, m64 = th0_d.double(), m0_d.double()
    long_first = long_chain(th64, m64)
    long_wall = wall_ms(lambda: long_chain(th64, m64), 2, warmup=1)
    long_again = long_chain(th64, m64)
    torch.cuda.synchronize()
    g_long = next(iter(long_chain.linked.graphs.values()))
    long_err = {k: rel_err(a.cpu(), b.cpu()) for k, a, b in zip(keys, long_again, long_first)}
    if not all(bool(torch.isfinite(v).all()) for v in long_again):
        raise AssertionError("the replayed float64 chain is not finite")
    say(f"longest capture: float64 chain of {LONG_CAPTURE_STEPS} steps through the step loop: "
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

    lap(8)
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

    lap(9)
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

    lap(10)
    # 11. models ----------------------------------------------------------
    model_launches, k1_model_abs = phase_models(dev, smi)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_model_abs)

    lap(11)
    # 12. the Elman RNN BPTT step ------------------------------------------
    elman_launches, k1_elman_abs, k2_elman_abs = phase_elman(dev, smi)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_elman_abs)
    k2_abs = max(k2_abs, k2_elman_abs)
    model_launches.update(elman_launches)

    lap(12)
    # 13. the linalg slice: GP, Kalman, batched Cholesky ---------------------
    linalg_launches, k1_linalg_abs = phase_linalg(dev, smi)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_linalg_abs)
    model_launches.update(linalg_launches)

    lap(13)
    # 14. the special functions and the bessel loop ------------------------
    special_launches, k1_special_abs, k2_special_abs, _, _ = phase_special(dev, smi,
                                                                          special_one_node)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_special_abs)
    k2_abs = max(k2_abs, k2_special_abs)
    model_launches["special"] = {
        kind: sum(v[kind] for v in special_launches.values())
        for kind in ("fused_elemwise", "scan_whole_loop")}

    lap(14)
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

    lap(15)
    # 16. the tensor library's tail: the einsum loop, the scan rows --------
    tail_launches, k1_tail_abs, k2_tail_abs, tail_rows = phase_tail(dev, smi, tail_signs)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_tail_abs)
    k2_abs = max(k2_abs, k2_tail_abs)
    model_launches.update(tail_launches)

    lap(16)
    # 17. tensor/optimize.py and the complex ops -------------------------------
    opt_launches, k1_opt_abs, opt_rows = phase_optimize(dev, smi, complex_one_node)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_opt_abs)
    model_launches.update(opt_launches)

    lap(17)
    # 18. random and HMC ----------------------------------------------------------
    random_launches, k1_random_abs, random_rows = phase_random(dev, smi, hmc_reference,
                                                               opts.parent)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_random_abs)
    model_launches.update(random_launches)
    main_draw = random_rows["threefry"]["folded normal 256x89"]

    lap(18)
    # 19. jax's loop samplers and the RBM Gibbs chain ----------------------------
    loop_launches, loop_rows = phase_loops(dev, smi, opts.parent)
    lap(19)

    # 20. a censored-likelihood gradient: the shape-parameter gradients ----------
    censored_launches, k1_censored_abs, censored_row = phase_censored(dev, smi,
                                                                     censored_reference)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_censored_abs)
    model_launches.update(censored_launches)
    lap(20)
    # 21. while-scans: the converged power iteration, the radon trajectory ----------
    while_launches, k4_while, k1_while_abs, while_row = phase_while(dev, smi, while_set)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_while_abs)
    model_launches.update(while_launches)
    lap(21)
    # 22. the compile driver: modes, pushforward, copies, pickling, profiles ----------
    compile_launches, k4_compile, k1_compile_abs, compile_row = phase_compile(
        dev, smi, compile_cpu, chain, (th0_d, m0_d), power, xsh, x0)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_compile_abs)
    model_launches.update(compile_launches)
    k4_while.update(k4_compile)
    lap(22)
    # 23. the graph layer: the ShapeFeature, item 6's rewrites, printing, the
    # destroy handler, check_blas ------------------------------------------------------
    graph_launches, k1_graph_abs, graph_row = phase_graph(dev, smi, graph_nodes, chain,
                                                          (th0_d, m0_d))
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_graph_abs)
    model_launches.update(graph_launches)
    lap(23)
    # 24. control and debug ops: IfElse, CheckAndRaise, the debug modes, typed
    # lists, PdbBreakpoint ------------------------------------------------------------------
    control_launches, k1_control_abs, control_row = phase_control(dev, smi, control_cpu)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_control_abs)
    model_launches.update(control_launches)
    lap(24)
    # 25. the sparse slice: learned edge weights, a tf-idf SGD step, a row an op -------------
    sparse_launches, k1_sparse_abs, sparse_row = phase_sparse(dev, smi, sparse_cpu_reference())
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_sparse_abs)
    model_launches.update(sparse_launches)
    lap(25)
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
         "launches": power_launches["spmv_csr"] + sum(k4_while.values()),
         "launches_by_path": {"power iteration": power_launches["spmv_csr"], **k4_while},
         "while_scans": while_row, "compile_driver": compile_row, **k4},
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
    # each op's line in the JAX package (its lowering is jax.grad of the
    # fraction or series, _betainc_grad_jax, _gammainc_grad_k_jax,
    # _hyp2f1_grad_jax, which K1's pallas_call holds)
    grad_lines = {"betainc_dda": 422, "betainc_ddb": 424, "gammainc_ddk": 529,
                  "gammaincc_ddk": 531, "hyp2f1_dda": 631, "hyp2f1_ddb": 633, "hyp2f1_ddc": 635}
    for name, line in grad_lines.items():
        r = GRAD_ROWS[name]
        kernels.append({
            "name": f"{name} (K1 device function)", "route": "cuda",
            "source": "pytensor_tpu_torch/link/cuda/special.py",
            "replaces": f"pytensor_tpu/tensor/fused.py:88 (K1's pallas_call, holding "
                        f"pytensor_tpu/scalar/math.py:{line}'s jax.grad)",
            "launches": censored_row["by_grad"].get(name, 0) + GRAD_PATH_LAUNCHES.get(name, 0),
            "launches_by_path": {"censored": censored_row["by_grad"].get(name, 0),
                                 "special gradients": GRAD_PATH_LAUNCHES.get(name, 0)},
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            "timed_at": f"one-node K1 launch, {GRAD_N:,} float64 elements",
            "fp64_instructions_an_iteration": GRAD_FP64[name]})
    kernels[0]["censored"] = censored_row
    kernels[0]["graph_layer"] = graph_row
    kernels[0]["control"] = control_row
    kernels[0]["sparse"] = sparse_row
    for entry in kernels:
        within_bound(entry["name"], entry)
    say("phase seconds: " + json.dumps({k: round(v, 1) for k, v in lap.seconds.items()}))
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

"""Drive the torch port's radon logp+dlogp path on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line or more each, and any failure raises:

1. device: require CUDA; print the card's name and power limit.
2. build: build the radon leapfrog kernel (K3) with nvcc.
3. K1: every FusedElemwise of the single-chain graph and of the batched
   graph at 1,024 chains, in float32 and float64, launched on the inputs
   the graph gives it and held against its plain torch version.
4. K3: the leapfrog chain at full width (919 observations, 85 counties),
   1,024 steps, held against its plain torch version.
5. slice: ``entry("cuda")`` logp and dlogp against a float64 NumPy
   evaluation of the closed form; the batched graph at 1,024 chains; 64
   leapfrog steps through ``leapfrog()``; then one trajectory through K3's
   entry point, ``make_radon_leapfrog_kernel``.  Kernel launch counts are
   set to 0 before this phase and must be positive after it.
6. profile: wall time per call of each linked function, its time on the
   card from ``torch.profiler``, the card's busy share, and the kernels
   that take the card's time.

Two clocks are kept apart.  ``wall_ms`` is CUDA events around
back-to-back calls: with kernels of a few microseconds it measures the
host's launch path, not the card.  ``device_ms`` sums the durations of
the CUDA kernels that ``torch.profiler`` traces.  The kernel line's
``ms`` and ``plain_ms`` are device times; ``wall_ms`` and
``plain_wall_ms`` beside them are wall times.

The second-to-last line is a JSON object with one entry per kernel, the
last ``{"ok": true, "device": {...}}``.  It imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np

N_OBS, N_COUNTIES, N_CHAINS = 919, 85, 1024
K3_STEPS, LEAPFROG_STEPS, EPS = 1024, 64, 1e-3
# K1 vs its plain version, relative to the output's magnitude: the kernel
# and torch round the same IEEE operations, but Triton may contract a*b+c
# into one FMA and libdevice's exp/log differ from torch's by an ulp or two
K1_RTOL = {"float32": 1e-5, "float64": 1e-12}
# K3 vs its plain version after 1,024 float32 steps, over max(1, max|ref|):
# the two sum in different orders and the trajectory carries the rounding
# forward (on an H100 80GB HBM3 at 700 W the kernel ended 4.3e-5 / 3.6e-4 /
# 9.5e-5 from the float32 plain chain in theta / m / logp, and 7.1e-5 /
# 6.0e-4 / 1.6e-4 from the float64 one); the kernel is held to both at
# 3-5x those readings
K3_RTOL = {"theta": 3e-4, "m": 3e-3, "logp": 5e-4}
# the linked float32 graph vs the float64 closed form: sums of 919 float32
# terms; atol scaled to max|dlogp| because some entries are near zero
SLICE_RTOL, SLICE_ATOL = 1e-4, 1e-4


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

    The summed durations of the CUDA kernels, copies and fills that
    ``torch.profiler`` traces over ``n_iter`` calls, divided by ``n_iter``.
    Returns ``(ms, {name: (ms, launches)})``, both per call.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_iter):
            fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    if not by_name:
        raise AssertionError("torch.profiler traced no CUDA kernel")
    by_name = {k: (ms / n_iter, c / n_iter) for k, (ms, c) in by_name.items()}
    return sum(ms for ms, _ in by_name.values()), by_name


def errors(a, b):
    """(max |a - b|, the same over max(1, max |b|))."""
    a = np.asarray(a, dtype="float64")
    b = np.asarray(b, dtype="float64")
    abs_err = float(np.max(np.abs(a - b)))
    return abs_err, abs_err / max(1.0, float(np.max(np.abs(b))))


def rel_err(a, b):
    return errors(a, b)[1]


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    import pytensor_tpu_torch  # noqa: F401  (fails outside a checkout)
    from pytensor_tpu_torch.compile.mode import FAST_RUN
    from pytensor_tpu_torch.entry import entry
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch
    from pytensor_tpu_torch.models import radon_kernel
    from pytensor_tpu_torch.models.radon import (
        leapfrog,
        make_radon_graphs,
        make_radon_logp_batched,
        radon_logp_dlogp_reference,
        theta_start,
    )
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    dev = torch.device("cuda")

    # 1. device -------------------------------------------------------------
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    say(f"device: {name}, {torch.cuda.device_count()} visible, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, capability {torch.cuda.get_device_capability(0)}")
    say(smi)

    # 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    radon_kernel.build(verbose=True)
    build_s = time.perf_counter() - t0
    say(f"build: K3 nvcc sm_90a in {build_s:.2f} s")
    for line in radon_kernel.BUILD_LOG.splitlines():
        if "registers" in line or "smem" in line or "spill" in line:
            say("  ptxas:", line.strip())

    # the graphs of the slice, linked for the card
    def linked(dtype, batched):
        if batched:
            theta, logp, dlogp, n = make_radon_logp_batched(N_OBS, N_COUNTIES, dtype)
            inputs, outputs = [theta], [logp, dlogp]
        else:
            inputs, outputs, n = make_radon_graphs(N_OBS, N_COUNTIES, dtype)
        fg = FunctionGraph(inputs, outputs, clone=True)
        FAST_RUN.optimizer.rewrite(fg)
        return fg, fgraph_to_torch(fg, dev), n

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
            jobs = []
            for nd in nodes:
                args = [next(values) for _ in nd.inputs]
                kern = fused_kernel.FusedElemwiseKernel(nd.op.fgraph, dev)
                got = kern.launch(*args)
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
                    f"err {err:.2e} wall: kernel {node_ms:.4f} ms plain {node_plain:.4f} ms")
                worst = max(worst, err)
                ms += node_ms
                plain_ms += node_plain
                jobs.append((kern, args))
            dev_ms, _ = device_ms(lambda: [k.launch(*a) for k, a in jobs], 20)
            dev_plain, _ = device_ms(lambda: [k.plain(*a) for k, a in jobs], 20)
            say(f"K1 {tag}: {len(nodes)} fused nodes, max rel err {worst:.3e} "
                f"(tol {K1_RTOL[dtype]:g}); per graph call, device: kernels {dev_ms:.4f} ms, "
                f"plain {dev_plain:.4f} ms; wall: kernels {ms:.4f} ms, plain {plain_ms:.4f} ms")
            if dtype == "float32" and not batched:
                k1.update(ms=dev_ms, plain_ms=dev_plain, wall_ms=ms, plain_wall_ms=plain_ms)
            k1["max_abs_err"] = max(k1["max_abs_err"], worst_abs)
    say(f"K1 phase done in {time.perf_counter() - t0:.1f} s (Triton builds included)")

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
    say(f"K3 {K3_STEPS} steps, 919/85: logp {float(got[2]):.6f} vs plain {float(want[2]):.6f}; "
        f"rel err theta {errs['theta']:.2e} m {errs['m']:.2e} logp {errs['logp']:.2e} "
        f"(tol {K3_RTOL}); vs the float64 plain chain: kernel "
        f"{ {k: float(f'{v:.2e}') for k, v in errs64.items()} }, float32 plain "
        f"{ {k: float(f'{v:.2e}') for k, v in plain64.items()} }; "
        f"device: kernel {k3_ms:.4f} ms ({k3_ms / K3_STEPS * 1e3:.3f} us/step), "
        f"plain {k3_plain_ms:.2f} ms, {N_CHAINS} chains in one launch {k3_chains_ms:.4f} ms; "
        f"wall: kernel {k3_wall:.4f} ms, plain {k3_plain_wall:.2f} ms")

    # 5. slice --------------------------------------------------------------
    fn, (theta0,) = entry("cuda")
    _, fn_b, n = linked("float32", batched=True)
    theta = start_point(n, "float32")
    theta_b = start_point(n, "float32", N_CHAINS)
    rng = np.random.default_rng(2)
    m_start = rng.standard_normal(n).astype("float32")
    fused_kernel.LAUNCHES = 0
    radon_kernel.LAUNCHES = 0
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

    # 6. profile -------------------------------------------------------------
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

    kernels = [
        {"name": "fused_elemwise (K1)", "route": "triton",
         "source": "pytensor_tpu_torch/tensor/fused_kernel.py",
         "replaces": "pytensor_tpu/tensor/fused.py:33",
         "launches": launches["fused_elemwise"], "max_abs_err": k1["max_abs_err"],
         "ms": k1["ms"], "plain_ms": k1["plain_ms"],
         "wall_ms": k1["wall_ms"], "plain_wall_ms": k1["plain_wall_ms"]},
        {"name": "radon_leapfrog (K3)", "route": "cuda",
         "source": "pytensor_tpu_torch/csrc/radon_leapfrog.cu",
         "replaces": "pytensor_tpu/models/radon_pallas.py:28",
         "launches": launches["radon_leapfrog"], "max_abs_err": k3_abs,
         "ms": k3_ms, "plain_ms": k3_plain_ms,
         "wall_ms": k3_wall, "plain_wall_ms": k3_plain_wall},
    ]
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

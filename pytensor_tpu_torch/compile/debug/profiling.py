"""ProfileStats: compile, rewrite and run-time accounting of a function.

Counterpart of ``pytensor_tpu/compile/debug/profiling.py`` (PyTensor's
compile/debug/profiling.py ProfileStats:126).  A function made with
``profile=True`` (or under ``config.profile``) keeps one in
``fn.profile``: its compile and rewrite seconds, each rewrite pass's
seconds, the calls with their host seconds and, on a CUDA device, their
device milliseconds by CUDA events around the linked call, and a static
table of each op's estimated flops and bytes (``estimate_node_cost``, the
JAX package's table).  The JAX package's XLA analyses have one
counterpart each: for its memory analysis, the peak of device memory the
first call allocated (``torch.cuda.max_memory_allocated`` around it);
for its cost analysis, none, so ``xla_cost`` stays None and the static
table gives the flops and bytes.  Under the ``"py"`` linker each node is
timed, as the JAX package times each thunk of its oracle: by CUDA events
on a card (``NodeTimer``), by the host's clock on the CPU.  The summaries
print at exit under ``config.profile``.
"""

from __future__ import annotations

import atexit
import time
from collections import defaultdict
from io import StringIO

import numpy as np
import torch

_all_stats: list = []


def _prod(xs):
    r = 1
    for x in xs:
        if x is None:
            return None
        r *= int(x)
    return r


def _dtype_size(dtype) -> int:
    try:
        return np.dtype(dtype).itemsize
    except TypeError:
        return 2 if str(dtype) == "bfloat16" else 8


def estimate_node_cost(node):
    """(flops, bytes) of one node from its static shapes; either is None
    where a shape is not static."""
    op = node.op
    opname = type(op).__name__

    def size(v):
        return _prod(getattr(v.type, "shape", ()) or ())

    out_n = size(node.outputs[0])
    in_bytes = 0
    for i in node.inputs:
        s = size(i)
        if s is None:
            in_bytes = None
            break
        in_bytes += s * _dtype_size(getattr(i.type, "dtype", "float64"))
    out_bytes = None
    if out_n is not None:
        out_bytes = sum((size(o) or 0) * _dtype_size(getattr(o.type, "dtype", "float64"))
                        for o in node.outputs)
    bytes_ = in_bytes + out_bytes if in_bytes is not None and out_bytes is not None else None

    # the products: 2 m k n
    if opname in ("Dot", "Dot22", "Gemm", "Dot22Scalar", "BatchedDot") or (
            opname == "Blockwise" and type(getattr(op, "core_op", None)).__name__ == "Dot"):
        a, b = node.inputs[:2] if opname != "Gemm" else (node.inputs[1], node.inputs[2])
        ash = getattr(a.type, "shape", None)
        bsh = getattr(b.type, "shape", None)
        if ash and bsh and all(s is not None for s in ash) and all(s is not None for s in bsh):
            k = ash[-1]
            m = _prod(ash[:-1]) or 1
            n = bsh[-1] if len(bsh) > 1 else 1
            batch = 1
            if opname == "BatchedDot":
                batch = ash[0]
                m = _prod(ash[1:-1]) or 1
            return 2 * batch * m * k * n, bytes_
        return None, bytes_
    if opname in ("Gemv", "Ger"):
        n = size(node.inputs[1])
        if out_n is not None and n is not None:
            return 2 * out_n * max(1, n // max(1, out_n)), bytes_
        return None, bytes_
    # elementwise ops and reductions: one operation an input element
    if opname in ("Elemwise", "CAReduce", "DimShuffle", "Alloc", "Join", "Split", "Subtensor",
                  "IncSubtensor"):
        flops = None
        if all(size(i) is not None for i in node.inputs if hasattr(i.type, "shape")):
            flops = sum(size(i) or 0 for i in node.inputs)
        return flops, bytes_
    return None, bytes_


class NodeTimer:
    """Times each node of an eager plan (a ``Plan.hook``): CUDA events
    around each node on a card, read after the call; the host's clock on
    the CPU."""

    def __init__(self, stats, device):
        self.stats = stats
        self.cuda = device.type == "cuda"
        self.pending: list = []

    def before(self, node, inputs):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            return ev
        return time.perf_counter()

    def after(self, node, mark, inputs, outputs):
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self.pending.append((node.op, mark, ev))
        else:
            self.stats.record_node(node.op, time.perf_counter() - mark)

    def resolve(self):
        """Add the nodes' device times of the call just made (seconds)."""
        if self.pending:
            torch.cuda.synchronize()
            for op, a, b in self.pending:
                self.stats.record_node(op, a.elapsed_time(b) / 1e3)
            self.pending.clear()


class ProfileStats:
    def __init__(self, name=None, atexit_print=False, device=None):
        self.name = name
        self.device = device
        self.compile_time = 0.0
        self.rewrite_time = 0.0
        self.call_count = 0
        self.call_time = 0.0  # host seconds
        self.device_time = 0.0  # seconds by CUDA events, on a card
        # the first call's, in the totals too: on a card it captures
        self.first_call_time = self.first_device_time = 0.0
        self.peak_bytes = None  # device memory the first call allocated
        self.op_time: dict = defaultdict(float)
        self.op_calls: dict = defaultdict(int)
        self.rewrite_pass_times: list = []  # (pass name, seconds)
        self.op_table: list = []  # (op, count, estimated flops, estimated bytes)
        self.xla_cost = None  # no counterpart: the static table gives flops and bytes
        self.node_timer = None
        if atexit_print:
            _all_stats.append(self)

    def record_call(self, dt, device_dt=0.0):
        if self.call_count == 0:
            self.first_call_time, self.first_device_time = dt, device_dt
        self.call_count += 1
        self.call_time += dt
        self.device_time += device_dt

    def record_node(self, op, dt):
        self.op_time[str(op)] += dt
        self.op_calls[str(op)] += 1

    def record_rewrite_profile(self, profs):
        """The (name, sub-profile, seconds) entries of a
        ``SequentialGraphRewriter``'s profile."""
        if not isinstance(profs, (list, tuple)):
            return
        for entry in profs:
            if (isinstance(entry, tuple) and len(entry) == 3
                    and isinstance(entry[2], (int, float))):
                self.rewrite_pass_times.append((str(entry[0]), float(entry[2])))

    def build_op_table(self, fgraph):
        """Each op of the rewritten graph with its count and estimated
        flops and bytes."""
        agg: dict = {}
        for node in fgraph.toposort():
            key = str(node.op)
            cnt, fl, by = agg.get(key, (0, 0, 0))
            f, b = estimate_node_cost(node)
            agg[key] = (cnt + 1, fl + (f or 0), by + (b or 0))
        self.op_table = sorted(((op, c, f, b) for op, (c, f, b) in agg.items()),
                               key=lambda t: (-t[2], -t[3], -t[1]))

    def timed_call(self, linked, args, shared):
        """Call ``linked`` and record the call: host seconds, device seconds
        by CUDA events on a card (the call waits for the card), the first
        call's peak of device memory."""
        cuda = self.device is not None and self.device.type == "cuda"
        first = self.call_count == 0
        if cuda:
            torch.cuda.synchronize(self.device)
            if first:
                base = torch.cuda.memory_allocated(self.device)
                torch.cuda.reset_peak_memory_stats(self.device)
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
        t0 = time.perf_counter()
        res = linked(*args, *shared)
        if cuda:
            end.record()
            end.synchronize()
        dt = time.perf_counter() - t0
        self.record_call(dt, start.elapsed_time(end) / 1e3 if cuda else 0.0)
        if cuda and first:
            self.peak_bytes = torch.cuda.max_memory_allocated(self.device) - base
        if self.node_timer is not None:
            self.node_timer.resolve()
        return res

    def summary(self, file=None):
        buf = StringIO()
        print(f"ProfileStats({self.name or 'function'})", file=buf)
        print(f"  compile_time: {self.compile_time:.4f}s (rewrites: {self.rewrite_time:.4f}s)",
              file=buf)
        if self.rewrite_pass_times:
            total = sum(t for _, t in self.rewrite_pass_times) or 1.0
            print("  rewrite passes (top 10 by time):", file=buf)
            for name, t in sorted(self.rewrite_pass_times, key=lambda kv: -kv[1])[:10]:
                print(f"    {100 * t / total:5.1f}%  {t:.5f}s  {name}", file=buf)
        if self.call_count:
            print(f"  calls: {self.call_count}, total call time {self.call_time:.4f}s "
                  f"({1e6 * self.call_time / self.call_count:.1f} us/call)", file=buf)
            if self.call_count > 1:
                later = (self.call_time - self.first_call_time) / (self.call_count - 1)
                print(f"  after the first call ({1e3 * self.first_call_time:.3f} ms): "
                      f"{1e6 * later:.1f} us/call", file=buf)
            if self.device is not None and self.device.type == "cuda":
                print(f"  device time {1e3 * self.device_time / self.call_count:.4f} ms/call "
                      f"(CUDA events), {1e3 * self.first_device_time:.4f} ms the first; first "
                      f"call's peak {self.peak_bytes} bytes", file=buf)
        if self.op_time:
            total = sum(self.op_time.values()) or 1.0
            print("  per-op time (py linker, each node):", file=buf)
            for op, t in sorted(self.op_time.items(), key=lambda kv: -kv[1])[:20]:
                print(f"    {100 * t / total:5.1f}%  {t:.5f}s  {self.op_calls[op]:6d}x  {op}",
                      file=buf)
        if self.op_table:
            print("  per-op static cost (final graph; est. flops / bytes):", file=buf)
            for op, c, f, b in self.op_table[:20]:
                print(f"    {c:5d}x  {f:>12,} flops  {b:>12,} B  {op}", file=buf)
        out = buf.getvalue()
        if file is None:
            print(out)
        else:
            file.write(out)
        return out


def profile_function(fn, stats: ProfileStats | None = None):
    """Attach a ``ProfileStats`` to a compiled Function as ``fn.profile``.
    Its summary prints at exit only under ``config.profile``, as in the
    JAX package; ``function(profile=True)`` keeps it for inspection."""
    from pytensor_tpu_torch.compile.mode import _linker_class
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.torch.linker import PyLinker

    if stats is None:
        stats = ProfileStats(name=fn.name, atexit_print=bool(config.profile), device=fn.device)
    fn.profile = stats
    stats.compile_time = fn.compile_time
    stats.rewrite_time = fn.rewrite_time
    stats.record_rewrite_profile(getattr(fn, "rewrite_profile", None))
    stats.build_op_table(fn.fgraph)
    if fn.mode is not None and _linker_class(fn.mode.linker) is PyLinker:
        stats.node_timer = fn.linked.hook = NodeTimer(stats, fn.device)
    return fn


@atexit.register
def _print_atexit():
    for s in _all_stats:
        s.summary()

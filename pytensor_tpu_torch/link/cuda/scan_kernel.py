"""K2: a whole for-scan as one CUDA kernel, generated per Scan node.

Replaces ``pytensor_tpu/link/pallas/scan_pallas.py:101
make_pallas_scan_fn``, which traced the inner graph into one Pallas
kernel with an in-kernel ``fori_loop`` so that states, sequences and
constants stayed in VMEM and a step cost no kernel launch.  The TPU
layout of that kernel (the vmap to a size-1 leading dim, the rank-2
padding, ``mosaic_safe``, the VMEM budget) is not carried over.

On Hopper the loop runs in one thread block of 1,024 threads:
``for (t = 0; t < T; ++t) { every inner node in topological order }``.
A step of the radon leapfrog body is ~160 small ops, so what bounds it is
latency: barriers and the round trips of each op through the memory
hierarchy, not bytes or flops.  The design:

- **Source.** Emitted at link time from the inner graph, one loop per op
  over its output elements (strided by the thread index), with static
  shapes folded into the index arithmetic.  Built with nvcc for sm_90a
  (``link/cuda/build.py``), cached by a hash of the source, called
  through ``ctypes`` on torch's current stream.
- **Memory.** Every inner variable has its own slot in a scratch arena
  that torch allocates per launch; no op updates a slot in place.  Views
  that keep the row-major order (``Reshape``, ``SpecifyShape``, a
  ``DimShuffle`` that only adds or drops length-1 dims, a contiguous
  ``Subtensor``) alias their input's slot instead of copying.  Graph
  constants sit in one device buffer uploaded when the scan is linked;
  scalar constants are exact literals of their dtype (hex floats).
  States are double-buffered: step ``t`` reads parity ``t & 1`` and the
  end of the step writes parity ``(t + 1) & 1``, and row ``t`` of each
  trace and nit-sot.  Untraced states are written once, at the end.
- **Barriers.** A ``__syncthreads()`` goes before an op only when it
  reads a value written since the last barrier by another thread.  An op
  writes element ``i`` from thread ``i % 1024``, or all of a scalar from
  thread 0; so a chain of scalar ops, or of same-shape elementwise ops,
  needs no barrier between its links.
- **Ops.** ``Elemwise`` is one C++ expression per scalar op (the table
  beside K1's ``_EMIT``), broadcast by strides, ``expf``/``exp`` by dtype
  and IEEE division.  ``CAReduce`` (sum, product, max) and ``Dot`` take
  one thread per output element, or one warp per output element with a
  fixed shuffle tree when the reduced length is long against the number
  of outputs; a full reduction is a block reduction, warp shuffles then
  one warp over the 32 partials.  Every order is fixed, so K2 is
  deterministic.  Static ``Subtensor``/``IncSubtensor``, ``DimShuffle``,
  ``Alloc`` and ``MakeVector`` are index-mapped copies;
  ``Shape``/``Shape_i`` are literals written before the loop.  Values
  that only feed static shape inputs (of ``Reshape``, ``SpecifyShape``,
  ``Alloc``) are not computed.

Eligibility keeps the structure of ``scan_pallas.py:54
pallas_scan_eligible``: every tap ``(-1,)`` (the port has no while-scans),
static shapes for every inner variable and sequence, dtypes in
``_OK_DTYPES``, and only ops this emitter covers.  The 4 MB VMEM budget
is replaced by the kernel's own limit: 32-bit element offsets.  A
``Subtensor`` or ``IncSubtensor``
with a dynamic index is not emitted (its bounds check needs the host),
so such a scan takes the loop here where the JAX package would take its
kernel.  The plain version is the step loop of ``link/torch/dispatch.py
scan_loop``; the wrapper runs it on CPU tensors only, and on CUDA
tensors launches the kernel or raises.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.tensor.basic import Alloc, MakeVector
from pytensor_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise
from pytensor_tpu_torch.tensor.fused import FusedElemwise
from pytensor_tpu_torch.tensor.math import Dot
from pytensor_tpu_torch.tensor.shape import Reshape, Shape, Shape_i, SpecifyShape
from pytensor_tpu_torch.tensor.subtensor import DYN, IncSubtensor, Subtensor

THREADS = 1024
WARPS = THREADS // 32

# launches of the kernel since the count was last set to 0
LAUNCHES = 0

# the JAX package's _OK_DTYPES (scan_pallas.py:49) less bfloat16, which
# the port has no tensors of
_OK_DTYPES = ("float32", "bool", "int8", "int16", "int32", "int64",
              "uint8", "uint16", "uint32")

_CTYPES = {
    "float32": "float", "float64": "double", "bool": "bool",
    "int8": "signed char", "int16": "short", "int32": "int", "int64": "long long",
    "uint8": "unsigned char", "uint16": "unsigned short", "uint32": "unsigned int",
}


def _fn(f32, f64):
    return lambda a, t: f"{f32 if t == 'float32' else f64}({a[0]})"


# scalar op name -> C++ expression over operands already cast to the
# compute dtype ``t`` (beside K1's ``_EMIT`` in tensor/fused_kernel.py)
_CEXPR = {
    "add": lambda a, t: "(" + " + ".join(a) + ")",
    "mul": lambda a, t: "(" + " * ".join(a) + ")",
    "sub": lambda a, t: f"({a[0]} - {a[1]})",
    "neg": lambda a, t: f"(-{a[0]})",
    # fabs clears the sign of -0.0, as numpy's abs does
    "abs": lambda a, t: (f"{'fabsf' if t == 'float32' else 'fabs'}({a[0]})"
                         if t in ("float32", "float64") else f"({a[0]} < 0 ? -{a[0]} : {a[0]})"),
    "sqr": lambda a, t: f"({a[0]} * {a[0]})",
    "true_div": lambda a, t: f"({a[0]} / {a[1]})",
    "reciprocal": lambda a, t: f"(({_CTYPES[t]})1 / {a[0]})",
    "pow": lambda a, t: (f"k2_ipow({a[0]}, {a[1]})" if t not in ("float32", "float64")
                         else f"{'powf' if t == 'float32' else 'pow'}({a[0]}, {a[1]})"),
    "exp": _fn("expf", "exp"),
    "log": _fn("logf", "log"),
    "sqrt": _fn("sqrtf", "sqrt"),
    "sin": _fn("sinf", "sin"),
    "cos": _fn("cosf", "cos"),
    "tanh": _fn("tanhf", "tanh"),
    "sigmoid": lambda a, t: (f"(({_CTYPES[t]})1 / (({_CTYPES[t]})1 + "
                             f"{'expf' if t == 'float32' else 'exp'}(-{a[0]})))"),
    "maximum": lambda a, t: f"k2_max({a[0]}, {a[1]})",
    "lt": lambda a, t: f"({a[0]} < {a[1]})",
    "ge": lambda a, t: f"({a[0]} >= {a[1]})",
    "second": lambda a, t: a[1],
}
_FLOAT_ONLY = frozenset({"true_div", "reciprocal", "exp", "log", "sqrt", "sin", "cos",
                         "tanh", "sigmoid"})


def _lowest(dtype):
    if dtype == "bool":
        return False
    return -np.inf if dtype.startswith("float") else np.iinfo(dtype).min


# CAReduce scalar op name -> (identity of the accumulator dtype, C++
# combine of two accumulators, warp reduction)
_REDUCE = {
    "add": (lambda dt: 0, lambda a, b: f"{a} + {b}", "k2_warp_add"),
    "mul": (lambda dt: 1, lambda a, b: f"{a} * {b}", "k2_warp_mul"),
    "maximum": (_lowest, lambda a, b: f"k2_max({a}, {b})", "k2_warp_max"),
}

_PRELUDE = r"""#include <cuda_runtime.h>
#include <math.h>

#define K2_THREADS 1024

template <typename T> __device__ __forceinline__ T k2_warp_add(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
template <typename T> __device__ __forceinline__ T k2_warp_mul(T v) {
  for (int o = 16; o > 0; o >>= 1) v *= __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
// numpy's maximum: NaN in either operand gives NaN
template <typename T> __device__ __forceinline__ T k2_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}
template <typename T> __device__ __forceinline__ T k2_warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = k2_max(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}
template <typename T> __device__ __forceinline__ T k2_ipow(T a, T b) {
  T r = 1;
  for (T i = 0; i < b; ++i) r *= a;
  return r;
}
"""


def _ctype(dtype):
    return _CTYPES[str(dtype)]


def _acc_ctype(dtype):
    """The accumulator's C type: warp shuffles take 32 and 64-bit values."""
    if dtype in ("bool", "int8", "int16"):
        return "int"
    if dtype in ("uint8", "uint16"):
        return "unsigned int"
    return _ctype(dtype)


def _literal(value, dtype) -> str:
    """An exact C++ literal of ``value`` in ``dtype``."""
    v = np.asarray(value).astype(dtype).item()
    if dtype == "bool":
        return "true" if v else "false"
    if dtype in ("float32", "float64"):
        ct = _ctype(dtype)
        if math.isnan(v):
            return f"(({ct})NAN)"
        if math.isinf(v):
            return f"(({ct})INFINITY)" if v > 0 else f"(-({ct})INFINITY)"
        return float.hex(float(v)) + ("f" if dtype == "float32" else "")
    if v == -(2 ** 63):
        return "(-9223372036854775807LL - 1)"
    return f"(({_ctype(dtype)}){int(v)}LL)"


def _size(shape):
    return int(np.prod(shape, dtype=np.int64)) if shape else 1


def _row_major(shape):
    strides, acc = [], 1
    for d in reversed(shape):
        strides.append(acc)
        acc *= d
    return list(reversed(strides))


def _bcast_strides(in_shape, out_shape):
    """Strides of a row-major ``in_shape`` broadcast to ``out_shape``."""
    pad = len(out_shape) - len(in_shape)
    st = _row_major(in_shape)
    return [0 if d < pad or in_shape[d - pad] == 1 else st[d - pad]
            for d in range(len(out_shape))]


def _unravel(shape, flat, prefix):
    """C++ lines defining ``{prefix}0..`` as the row-major indices of ``flat``."""
    if not shape:
        return []
    if len(shape) == 1:
        return [f"const int {prefix}0 = {flat};"]
    rem = f"{prefix}_rem"
    lines = [f"int {rem} = {flat};"]
    for d in range(len(shape) - 1, 0, -1):
        lines.append(f"const int {prefix}{d} = {rem} % {shape[d]}; {rem} /= {shape[d]};")
    lines.append(f"const int {prefix}0 = {rem};")
    return lines


def _offset(strides, prefix):
    terms = [f"{prefix}{d} * {s}" if s != 1 else f"{prefix}{d}"
             for d, s in enumerate(strides) if s != 0]
    return " + ".join(terms) if terms else "0"


# --- eligibility ---------------------------------------------------------------

def _dynamic_index(op):
    return any(e == DYN or (isinstance(e, tuple) and DYN in e) for e in op.idx_list)


def emittable(node) -> bool:
    """True when K2 can emit this inner node."""
    op = node.op
    if isinstance(op, FusedElemwise):
        return all(emittable(n) for n in op.fgraph.apply_nodes)
    if isinstance(op, Elemwise):
        name = op.scalar_op.name
        if name.startswith("cast{"):
            return True
        if name not in _CEXPR:
            return False
        return name not in _FLOAT_ONLY or node.outputs[0].type.dtype.startswith("float")
    if isinstance(op, CAReduce):
        return op.scalar_op.name in _REDUCE
    if isinstance(op, Dot):
        return node.outputs[0].type.dtype != "bool"
    if isinstance(op, (Subtensor, IncSubtensor)):
        return not _dynamic_index(op)
    return isinstance(op, (DimShuffle, Reshape, SpecifyShape, Alloc, MakeVector,
                           Shape, Shape_i))


def scan_kernel_eligible(op, node=None) -> bool:
    """Can this Scan run as one K2 launch?  Same structure as the JAX
    package's ``pallas_scan_eligible``."""
    info = op.info
    if any(t != (-1,) for t in info.taps):
        return False
    if info.n_seqs:
        if node is None:
            return False
        for s in node.inputs[1: 1 + info.n_seqs]:
            if any(d is None for d in s.type.shape):
                return False
    for v in op.fgraph.inputs + op.fgraph.outputs:
        if getattr(v.type, "dtype", None) not in _OK_DTYPES:
            return False
        if any(d is None for d in v.type.shape):
            return False
    total = 0
    for inner_node in op.fgraph.apply_nodes:
        if not emittable(inner_node):
            return False
        for o in inner_node.outputs:
            if any(s is None for s in o.type.shape):
                return False
            if o.type.dtype not in _OK_DTYPES and not o.type.dtype.startswith("int"):
                return False
            total += _size(o.type.shape)
    # the kernel's own limit: element offsets are 32-bit ints
    if node is not None:
        total += sum(_size(s.type.shape) for s in node.inputs[1:])
    return total < 2 ** 31


# --- the emitter ------------------------------------------------------------------

class _Loc:
    """Where a variable's elements live: ``root[off + i]``."""

    __slots__ = ("root", "off", "dtype", "shape", "const")

    def __init__(self, root, off, dtype, shape, const=None):
        self.root, self.off, self.dtype, self.shape = root, off, dtype, tuple(shape)
        self.const = const  # the value, for a 0-d constant

    @property
    def size(self):
        return _size(self.shape)

    def at(self, idx):
        return f"{self.root}[{self.off} + {idx}]" if self.off else f"{self.root}[{idx}]"


class _ENode:
    """An inner node to emit (a FusedElemwise is flattened into these)."""

    __slots__ = ("op", "inputs", "outputs")

    def __init__(self, op, inputs, outputs):
        self.op, self.inputs, self.outputs = op, list(inputs), list(outputs)


def _flatten(order):
    """Inner nodes with every FusedElemwise replaced by its inner nodes,
    plus {outer var: inner var} for fused outputs that are not computed."""
    enodes, alias = [], {}
    for node in order:
        if not isinstance(node.op, FusedElemwise):
            enodes.append(_ENode(node.op, node.inputs, node.outputs))
            continue
        fg = node.op.fgraph
        sub = dict(zip(fg.inputs, node.inputs))
        for inner in fg.toposort():
            enodes.append(_ENode(inner.op, [sub.get(i, i) for i in inner.inputs],
                                 inner.outputs))
        for inner_out, outer_out in zip(fg.outputs, node.outputs):
            alias[outer_out] = sub.get(inner_out, inner_out)
    return enodes, alias


# static shape ports, whose values the kernel does not need
_SHAPE_ONLY = {Reshape: lambda i: i >= 1, SpecifyShape: lambda i: i >= 1,
               Alloc: lambda i: i >= 1, Shape: lambda i: True, Shape_i: lambda i: True}


class _Writer:
    """Which thread wrote each element of a slot since the last barrier."""

    STD, T0, OTHER = "std", "t0", "other"


class ScanKernelSource:
    """The CUDA source of K2 for one Scan node, and its argument layout."""

    def __init__(self, op, node):
        self.op, self.node = op, node
        info = op.info
        self.info = info
        self.loc: dict = {}
        self.arena = 0
        self.const_chunks: list[bytes] = []
        self.const_bytes_len = 0
        self.n_barriers = 0
        self.n_ops = 0
        self.dirty: dict = {}
        self.red_buf = 0
        inner_in = op.fgraph.inputs
        ns, nst, nu = info.n_seqs, info.n_states, info.n_untraced
        self.seq_vars = inner_in[:ns]
        self.state_vars = inner_in[ns: ns + nst]
        self.unt_vars = inner_in[ns + nst: ns + nst + nu]
        self.nonseq_vars = inner_in[ns + nst + nu:]
        outs = op.fgraph.outputs
        self.state_outs = outs[:nst]
        self.unt_outs = outs[nst: nst + nu]
        self.nit_outs = outs[nst + nu:]
        self.source = self._emit()

    # --- slots -------------------------------------------------------------
    def _arena_slot(self, name, dtype, n):
        off = self.arena
        self.arena += ((max(n, 1) * np.dtype(dtype).itemsize + 15) // 16) * 16
        self.decl.append(f"{_ctype(dtype)}* {name} = ({_ctype(dtype)}*)(a.scratch + {off});")
        return name

    def _const_slot(self, c):
        data = np.array(c.data, dtype=c.type.dtype, order="C")
        name = f"c{len(self.const_chunks)}"
        off = self.const_bytes_len
        raw = data.tobytes()
        self.const_chunks.append(raw + b"\0" * ((-len(raw)) % 16))
        self.const_bytes_len += len(self.const_chunks[-1])
        ct = _ctype(c.type.dtype)
        self.decl.append(f"const {ct}* {name} = (const {ct}*)(a.consts + {off});")
        return _Loc(name, 0, c.type.dtype, c.type.shape,
                    const=data.reshape(()) if data.ndim == 0 else None)

    def get(self, v):
        v = self.alias.get(v, v)
        if v not in self.loc:
            if not isinstance(v, Constant):
                raise KeyError(f"K2: no slot for {v}")
            self.loc[v] = self._const_slot(v)
        return self.loc[v]

    def operand(self, v, idx, dtype):
        """C++ value of element ``idx`` of ``v`` cast to ``dtype``."""
        loc = self.get(v)
        if loc.const is not None:
            return f"(({_ctype(dtype)}){_literal(loc.const, loc.dtype)})"
        expr = loc.at(idx)
        return expr if loc.dtype == dtype else f"(({_ctype(dtype)}){expr})"

    # --- barriers --------------------------------------------------------------
    def _safe(self, v, pattern):
        loc = self.get(v)
        w = self.dirty.get(loc.root)
        if w is None:
            return True
        if w == _Writer.T0:
            return pattern == "t0" or (pattern == "ident" and loc.size <= 1)
        if w == _Writer.STD:
            if loc.off % THREADS:
                return False
            return pattern == "ident" or (pattern == "t0" and loc.size <= 1)
        return False

    def reads(self, pairs):
        """Emit a barrier unless every (var, pattern) read is safe."""
        if not all(self._safe(v, p) for v, p in pairs):
            self.body.append("__syncthreads();")
            self.n_barriers += 1
            self.dirty.clear()

    def wrote(self, v, writer):
        self.dirty[self.get(v).root] = writer

    # --- emission ----------------------------------------------------------------
    def _emit(self):
        op, info = self.op, self.info
        self.decl: list[str] = []
        self.body: list[str] = []
        self.alias: dict = {}
        enodes, self.alias = _flatten(op.fgraph.toposort())
        needed = set(self.alias.get(o, o) for o in op.fgraph.outputs)
        live = []
        for en in reversed(enodes):
            if not any(o in needed for o in en.outputs):
                continue
            live.append(en)
            port = _SHAPE_ONLY.get(type(en.op))
            for k, i in enumerate(en.inputs):
                if port is None or not port(k):
                    needed.add(self.alias.get(i, i))
        live.reverse()

        self.args = []  # (field, ctype, const) in launch order

        def arg(field, dtype, const):
            self.args.append((field, _ctype(dtype), const))
            return f"a.{field}"

        seq_args = [arg(f"seq{k}", v.type.dtype, True) for k, v in enumerate(self.seq_vars)]
        init_args = [arg(f"init{k}", v.type.dtype, True)
                     for k, v in enumerate(self.state_vars + self.unt_vars)]
        ns_args = [arg(f"ns{j}", v.type.dtype, True) for j, v in enumerate(self.nonseq_vars)]
        trace_args = [arg(f"trace{k}", v.type.dtype, False) for k, v in enumerate(self.state_outs)]
        final_args = [arg(f"final{u}", v.type.dtype, False) for u, v in enumerate(self.unt_outs)]
        nit_args = [arg(f"nit{j}", v.type.dtype, False) for j, v in enumerate(self.nit_outs)]

        carried = self.state_vars + self.unt_vars
        bufs = [self._arena_slot(f"st{k}_buf", v.type.dtype, 2 * _size(v.type.shape))
                for k, v in enumerate(carried)]
        for j, v in enumerate(self.nonseq_vars):
            self.loc[v] = _Loc(f"ns{j}", 0, v.type.dtype, v.type.shape)
            self.decl.append(f"const {_ctype(v.type.dtype)}* ns{j} = {ns_args[j]};")
        for k, v in enumerate(self.seq_vars):
            self.loc[v] = _Loc(f"q{k}", 0, v.type.dtype, v.type.shape)
        for k, v in enumerate(carried):
            self.loc[v] = _Loc(f"st{k}", 0, v.type.dtype, v.type.shape)

        pre = []
        for k, v in enumerate(carried):
            n = _size(v.type.shape)
            pre.append(f"for (int i = tid; i < {n}; i += K2_THREADS) "
                       f"{bufs[k]}[i] = {init_args[k]}[i];")
        self.pre = pre
        for en in live:
            self._emit_node(en)
        step_body = self.body

        # end of step: the new carried values and the trace rows
        self.body = []
        carried_outs = self.state_outs + self.unt_outs
        self.reads([(out, "ident" if _size(out.type.shape) > 1 else "t0")
                    for out in carried_outs + self.nit_outs])
        for k, out in enumerate(carried_outs):
            n = _size(out.type.shape)
            dt = carried[k].type.dtype
            val = self.operand(out, "i", dt)
            line = f"for (int i = tid; i < {n}; i += K2_THREADS) {{ const {_ctype(dt)} x = {val}; st{k}_nx[i] = x;"
            if k < info.n_states:
                line += f" {trace_args[k]}[t * {n} + i] = x;"
            self.body.append(line + " }")
        for j, out in enumerate(self.nit_outs):
            n = _size(out.type.shape)
            val = self.operand(out, "i", out.type.dtype)
            self.body.append(f"for (int i = tid; i < {n}; i += K2_THREADS) "
                             f"{nit_args[j]}[t * {n} + i] = {val};")
        self.body.append("__syncthreads();")
        self.n_barriers += 1
        end_body = self.body

        lines = [_PRELUDE, "namespace {", "", "struct K2Args {"]
        for field, ct, const in self.args:
            lines.append(f"  {'const ' if const else ''}{ct}* {field};")
        lines += ["  unsigned char* scratch;", "  const unsigned char* consts;",
                  "  long long T;", "};", "",
                  "__global__ void __launch_bounds__(K2_THREADS) k2_kernel(K2Args a) {",
                  "  __shared__ unsigned long long k2_red[2][32];",
                  "  const int tid = threadIdx.x;"]
        lines += ["  " + d for d in self.decl]
        lines += ["  " + p for p in self.pre]
        lines += ["  __syncthreads();", "  for (long long t = 0; t < a.T; ++t) {"]
        for k, v in enumerate(carried):
            n = _size(v.type.shape)
            ct = _ctype(v.type.dtype)
            lines.append(f"    {ct}* st{k} = {bufs[k]} + (t & 1) * {n};")
            lines.append(f"    {ct}* st{k}_nx = {bufs[k]} + ((t + 1) & 1) * {n};")
        for k, v in enumerate(self.seq_vars):
            n = _size(v.type.shape)
            lines.append(f"    const {_ctype(v.type.dtype)}* q{k} = {seq_args[k]} + t * {n};")
        lines += ["    " + b for b in step_body + end_body]
        lines.append("  }")
        for u, v in enumerate(self.unt_vars):
            k = info.n_states + u
            n = _size(v.type.shape)
            lines.append(f"  for (int i = tid; i < {n}; i += K2_THREADS) "
                         f"{final_args[u]}[i] = {bufs[k]}[(a.T & 1) * {n} + i];")
        lines += ["}", "", "}  // namespace", "",
                  "// Launches one block on `stream`; returns cudaGetLastError().",
                  'extern "C" int k2_launch(const unsigned long long* p, long long T, '
                  "void* stream) {",
                  "  K2Args a;"]
        for pos, (field, ct, const) in enumerate(self.args):
            lines.append(f"  a.{field} = ({'const ' if const else ''}{ct}*)p[{pos}];")
        n = len(self.args)
        lines += [f"  a.scratch = (unsigned char*)p[{n}];",
                  f"  a.consts = (const unsigned char*)p[{n + 1}];",
                  "  a.T = T;",
                  "  k2_kernel<<<1, K2_THREADS, 0, (cudaStream_t)stream>>>(a);",
                  "  return (int)cudaGetLastError();", "}", ""]
        self.const_bytes = b"".join(self.const_chunks) or b"\0" * 16
        return "\n".join(lines)

    # --- one node -------------------------------------------------------------------
    def _new_slot(self, v):
        name = self._arena_slot(f"v{len(self.loc)}", v.type.dtype, _size(v.type.shape))
        self.loc[v] = _Loc(name, 0, v.type.dtype, v.type.shape)
        return self.loc[v]

    def _alias(self, out, src, off=0):
        """``out`` is a view of ``src``'s elements from ``off`` on."""
        s = self.get(src)
        self.loc[out] = _Loc(s.root, s.off + off, s.dtype, out.type.shape)

    def _std_loop(self, out_loc, body_lines, reads):
        """A loop with element i on thread i % K2_THREADS (all on thread 0
        for a single element); ``reads`` are (var, ident?) pairs."""
        n = out_loc.size
        if n == 1:
            self.reads([(v, "t0") for v, _ in reads])
            self.body.append("if (tid == 0) { const int i = 0;")
        else:
            self.reads([(v, "ident" if ident else "gen") for v, ident in reads])
            self.body.append(f"for (int i = tid; i < {n}; i += K2_THREADS) {{")
        self.body += ["  " + b for b in body_lines]
        self.body.append("}")

    def _emit_node(self, en):
        """Emit one node: views alias their input, Shape values are written
        before the loop, every other op is a loop of the step."""
        op = en.op
        out = en.outputs[0]
        if isinstance(op, (Reshape, SpecifyShape)) or (
                isinstance(op, DimShuffle) and list(op.shuffle) == sorted(op.shuffle)):
            return self._alias(out, en.inputs[0])
        if isinstance(op, Subtensor) and self._subtensor_view(en):
            return None
        if isinstance(op, (Shape, Shape_i)):
            shp = en.inputs[0].type.shape
            loc = self._new_slot(out)
            for j, s in enumerate(shp if isinstance(op, Shape) else [shp[op.i]]):
                self.pre.append(f"if (tid == 0) {loc.at(j)} = {int(s)}LL;")
            return None
        emit = {Elemwise: self._elemwise, CAReduce: self._careduce, Dot: self._dot,
                Subtensor: self._strided_copy, DimShuffle: self._strided_copy,
                IncSubtensor: self._inc_subtensor, Alloc: self._alloc,
                MakeVector: self._make_vector}[type(op)]
        self.n_ops += 1
        return emit(en)

    def _elemwise(self, en):
        out_v = en.outputs[0]
        out = self._new_slot(out_v)
        shape = out.shape
        name = en.op.scalar_op.name
        out_dt = out_v.type.dtype
        if name.startswith("cast{") or name == "second":
            comp = [i.type.dtype for i in en.inputs]
        elif out_dt == "bool":
            from pytensor_tpu_torch.scalar.basic import upcast

            comp = [upcast(*(i.type.dtype for i in en.inputs))] * len(en.inputs)
        else:
            comp = [out_dt] * len(en.inputs)
        lines = _unravel(shape, "i", "o") if out.size > 1 else []
        args, reads = [], []
        for i, dt in zip(en.inputs, comp):
            loc = self.get(i)
            ident = loc.shape == shape
            if loc.const is not None:
                args.append(self.operand(i, "0", dt))
                continue
            idx = "i" if ident or out.size == 1 else _offset(_bcast_strides(loc.shape, shape), "o")
            if loc.size == 1:
                idx = "0"
            args.append(self.operand(i, idx, dt))
            reads.append((i, ident))
        if name.startswith("cast{"):
            expr = f"({args[0]} != 0)" if out_dt == "bool" else args[0]
        else:
            expr = _CEXPR[name](args, comp[0])
        lines.append(f"{out.at('i')} = ({_ctype(out_dt)})({expr});")
        self._std_loop(out, lines, reads)
        self.wrote(out_v, _Writer.STD if out.size > 1 else _Writer.T0)

    def _careduce(self, en):
        op = en.op
        x, out_v = en.inputs[0], en.outputs[0]
        out = self._new_slot(out_v)
        xl = self.get(x)
        shape = xl.shape
        axes = tuple(range(len(shape))) if op.axis is None else tuple(op.axis)
        kept = [d for d in range(len(shape)) if d not in axes]
        red = [d for d in axes]
        R = _size([shape[d] for d in red])
        O = out.size
        acc_dt = op.acc_dtype or out_v.type.dtype
        acc = _acc_ctype(acc_dt)
        ident_of, combine, warp_fn = _REDUCE[op.scalar_op.name]
        ident = _literal(ident_of(acc_dt), acc_dt)
        st = _row_major(shape)
        out_ct = _ctype(out_v.type.dtype)
        if O == 1 and R > 1:
            # block reduction: element j on thread j % K2_THREADS
            self.reads([(x, "ident")])
            buf = self.red_buf
            self.red_buf ^= 1
            self.body += [
                "{",
                f"  {acc} p = {ident};",
                f"  for (int j = tid; j < {R}; j += K2_THREADS) "
                f"p = {combine('p', f'({acc})' + xl.at('j'))};",
                f"  p = {warp_fn}(p);",
                f"  {acc}* red = ({acc}*)k2_red[{buf}];",
                "  if ((tid & 31) == 0) red[tid >> 5] = p;",
                "  __syncthreads();",
                f"  if (tid < 32) {{ {acc} q = red[tid]; q = {warp_fn}(q); "
                f"if (tid == 0) {out.at(0)} = ({out_ct})q; }}",
                "}",
            ]
            self.n_barriers += 1
            self.dirty.clear()
            self.wrote(out_v, _Writer.T0)
            return
        kept_shape = [shape[d] for d in kept]
        red_shape = [shape[d] for d in red]
        base = _offset([st[d] for d in kept], "k")
        roff = _offset([st[d] for d in red], "j")
        by_thread = math.ceil(O / THREADS) * R
        by_warp = math.ceil(O / WARPS) * math.ceil(R / 32) + 5
        if O == 1 or by_thread <= by_warp:
            lines = _unravel(kept_shape, "i", "k")
            lines.append(f"const int base = {base};")
            lines.append(f"{acc} acc = {ident};")
            loops = "".join(f"for (int j{k} = 0; j{k} < {n}; ++j{k}) "
                            for k, n in enumerate(red_shape))
            lines.append(f"{loops}acc = {combine('acc', f'({acc})' + xl.at('base + ' + roff))};")
            lines.append(f"{out.at('i')} = ({out_ct})acc;")
            self._std_loop(out, lines, [(x, False)])
            self.wrote(out_v, _Writer.STD if O > 1 else _Writer.T0)
            return
        self.reads([(x, "gen")])
        body = ["{", "  const int lane = tid & 31;",
                f"  for (int i = tid >> 5; i < {O}; i += {WARPS}) {{"]
        body += ["    " + s for s in _unravel(kept_shape, "i", "k")]
        body += [f"    const int base = {base};", f"    {acc} acc = {ident};",
                 f"    for (int jj = lane; jj < {R}; jj += 32) {{"]
        body += ["      " + s for s in _unravel(red_shape, "jj", "j")]
        body += [f"      acc = {combine('acc', f'({acc})' + xl.at('base + ' + roff))};", "    }",
                 f"    acc = {warp_fn}(acc);",
                 f"    if (lane == 0) {out.at('i')} = ({out_ct})acc;", "  }", "}"]
        self.body += body
        self.wrote(out_v, _Writer.OTHER)

    def _dot(self, en):
        x, y = en.inputs
        out_v = en.outputs[0]
        out = self._new_slot(out_v)
        xl, yl = self.get(x), self.get(y)
        K = xl.shape[-1]
        O = out.size
        ct = _ctype(out_v.type.dtype)
        if len(xl.shape) == 2 and len(yl.shape) == 1:
            xb, yb, ys = f"o * {K}", "0", 1
        elif len(xl.shape) == 1 and len(yl.shape) == 2:
            xb, yb, ys = "0", "o", yl.shape[1]
        elif len(xl.shape) == 2:
            N = yl.shape[1]
            xb, yb, ys = f"(o / {N}) * {K}", f"(o % {N})", N
        else:
            xb, yb, ys = "0", "0", 1
        term = (f"({ct}){xl.at(f'xb + k')} * ({ct}){yl.at(f'yb + k * {ys}' if ys != 1 else 'yb + k')}")
        self.reads([(x, "gen"), (y, "gen")])
        by_thread = math.ceil(O / THREADS) * K
        by_warp = math.ceil(O / WARPS) * math.ceil(K / 32) + 5
        if O == 1 or by_thread <= by_warp:
            self.body += [
                f"for (int o = tid; o < {O}; o += K2_THREADS) {{",
                f"  const int xb = {xb}; const int yb = {yb};",
                f"  {ct} acc = 0;",
                f"  for (int k = 0; k < {K}; ++k) acc += {term};",
                f"  {out.at('o')} = acc;",
                "}",
            ]
            self.wrote(out_v, _Writer.STD if O > 1 else _Writer.T0)
            return
        self.body += [
            "{",
            "  const int lane = tid & 31;",
            f"  for (int o = tid >> 5; o < {O}; o += {WARPS}) {{",
            f"    const int xb = {xb}; const int yb = {yb};",
            f"    {ct} acc = 0;",
            f"    for (int k = lane; k < {K}; k += 32) acc += {term};",
            "    acc = k2_warp_add(acc);",
            f"    if (lane == 0) {out.at('o')} = acc;",
            "  }",
            "}",
        ]
        self.wrote(out_v, _Writer.OTHER)

    def _index_map(self, idx_list, in_shape):
        """(base offset, [(out dim length, input stride)]) of a static
        basic index into a row-major ``in_shape``."""
        st = _row_major(in_shape)
        base, dims, d = 0, [], 0
        for e in idx_list:
            if isinstance(e, (int, np.integer)):
                base += (int(e) % in_shape[d]) * st[d]
            else:
                _, a, b, c = e
                start, stop, step = slice(a, b, c).indices(in_shape[d])
                dims.append((len(range(start, stop, step)), step * st[d]))
                base += start * st[d]
            d += 1
        dims += [(in_shape[k], st[k]) for k in range(d, len(in_shape))]
        return base, dims

    def _subtensor_view(self, en):
        x, out_v = en.inputs[0], en.outputs[0]
        base, dims = self._index_map(en.op.idx_list, self.get(x).shape)
        shape = [n for n, _ in dims]
        if [s for n, s in dims if n > 1] != [s for n, s in zip(shape, _row_major(shape)) if n > 1]:
            return False
        self._alias(out_v, x, base)
        return True

    def _strided_copy(self, en):
        x, out_v = en.inputs[0], en.outputs[0]
        xl = self.get(x)
        if isinstance(en.op, Subtensor):
            base, dims = self._index_map(en.op.idx_list, xl.shape)
            strides = [s for _, s in dims]
        else:
            st = _row_major(xl.shape)
            base = 0
            strides = [0 if o == "x" else st[o] for o in en.op.new_order]
        out = self._new_slot(out_v)
        lines = _unravel(out.shape, "i", "o")
        lines.append(f"{out.at('i')} = {xl.at(str(base) + ' + ' + _offset(strides, 'o'))};")
        self._std_loop(out, lines, [(x, False)])
        self.wrote(out_v, _Writer.STD if out.size > 1 else _Writer.T0)

    def _inc_subtensor(self, en):
        x, y = en.inputs[:2]
        out_v = en.outputs[0]
        out = self._new_slot(out_v)
        shape = out.shape
        yl = self.get(y)
        conds, region = [], []  # region: (length, C++ index) per non-int entry
        d = 0
        for e in en.op.idx_list:
            if isinstance(e, (int, np.integer)):
                conds.append(f"o{d} == {int(e) % shape[d]}")
            else:
                _, a, b, c = e
                start, stop, step = slice(a, b, c).indices(shape[d])
                n = len(range(start, stop, step))
                if step > 0:
                    conds.append(f"o{d} >= {start} && o{d} < {stop}")
                else:
                    conds.append(f"o{d} <= {start} && o{d} > {stop}")
                if step not in (1, -1):
                    conds.append(f"(o{d} - {start}) % {step} == 0")
                region.append((n, f"(o{d} - {start}) / {step}" if step != 1 else f"(o{d} - {start})"))
            d += 1
        region += [(shape[k], f"o{k}") for k in range(d, len(shape))]
        ystr = _bcast_strides(yl.shape, [n for n, _ in region])
        yidx = " + ".join(f"({r}) * {s}" for (_, r), s in zip(region, ystr) if s) or "0"
        ct = _ctype(out_v.type.dtype)
        lines = _unravel(shape, "i", "o")
        lines.append(f"{ct} v = {self.operand(x, 'i', out_v.type.dtype)};")
        yv = self.operand(y, yidx, out_v.type.dtype)
        upd = f"v = {yv};" if en.op.set_instead_of_inc else f"v = v + {yv};"
        lines.append(f"if ({' && '.join(conds) or 'true'}) {upd}")
        lines.append(f"{out.at('i')} = v;")
        self._std_loop(out, lines, [(x, True), (y, False)])
        self.wrote(out_v, _Writer.STD if out.size > 1 else _Writer.T0)

    def _alloc(self, en):
        value, out_v = en.inputs[0], en.outputs[0]
        out = self._new_slot(out_v)
        vl = self.get(value)
        lines = _unravel(out.shape, "i", "o")
        idx = _offset(_bcast_strides(vl.shape, out.shape), "o") if vl.size > 1 else "0"
        lines.append(f"{out.at('i')} = {self.operand(value, idx, out_v.type.dtype)};")
        self._std_loop(out, lines, [(value, vl.shape == out.shape)])
        self.wrote(out_v, _Writer.STD if out.size > 1 else _Writer.T0)

    def _make_vector(self, en):
        out_v = en.outputs[0]
        out = self._new_slot(out_v)
        self.reads([(i, "t0") for i in en.inputs])
        vals = [f"{out.at(j)} = {self.operand(i, '0', out_v.type.dtype)};"
                for j, i in enumerate(en.inputs)]
        self.body.append("if (tid == 0) { " + " ".join(vals) + " }")
        self.wrote(out_v, _Writer.T0)


# --- the wrapper ----------------------------------------------------------------------

class ScanKernel:
    """K2 for one Scan node on one device.

    ``__call__(n_steps, *outer)`` takes the Scan node's outer inputs after
    ``n_steps`` and returns its outputs.  On CPU tensors it runs the plain
    step loop; on CUDA tensors it launches the kernel, or raises.
    """

    def __init__(self, op, node, device):
        from pytensor_tpu_torch.link.torch.convert import resolve_device
        from pytensor_tpu_torch.link.torch.dispatch import scan_loop

        self.op, self.node = op, node
        self.device = resolve_device(device)
        self.src = ScanKernelSource(op, node)
        self.source = self.src.source
        self.loop = scan_loop(op, self.device)
        self._lib = None
        self.build_log = ""
        # graph constants reach the card once, when the scan is linked
        self.consts = (torch.frombuffer(bytearray(self.src.const_bytes), dtype=torch.uint8)
                       .to(self.device))

    def build(self, verbose=False):
        """Build and load the kernel (cached by a hash of the source)."""
        from pytensor_tpu_torch.link.cuda.build import build_library

        if self._lib is None:
            lib, self.build_log = build_library(self.source, "scan_k2", verbose=verbose)
            lib.k2_launch.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]
            lib.k2_launch.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def __call__(self, n_steps, *outer):
        on_cpu = (all(t.device.type == "cpu" for t in outer) if outer
                  else self.device.type == "cpu")
        if on_cpu:
            return self.plain(n_steps, *outer)
        return self.launch(n_steps, *outer)

    def plain(self, n_steps, *outer):
        """The same scan as a torch step loop, on any device."""
        return self.loop(n_steps, *outer)

    def launch(self, n_steps, *outer):
        """Run the whole scan as one kernel launch on CUDA tensors."""
        global LAUNCHES
        from pytensor_tpu_torch.link.torch.convert import torch_dtype

        T = int(n_steps)
        if T < 0:
            raise ValueError(f"scan of {T} steps")
        node, info = self.node, self.op.info
        if self.device.type != "cuda":
            raise RuntimeError(f"K2 runs on CUDA tensors; the scan is linked for {self.device}")
        ins = []
        for k, (var, t) in enumerate(zip(node.inputs[1:], outer)):
            if t.device != self.device:
                raise RuntimeError(f"K2 input {var} is on {t.device}, the kernel on {self.device}")
            if t.dtype != torch_dtype(var.type.dtype):
                raise TypeError(f"K2 input {var} has dtype {t.dtype}, expected {var.type.dtype}")
            want = tuple(var.type.shape)
            if k < info.n_seqs:
                if t.ndim != len(want) or tuple(t.shape[1:]) != want[1:] or t.shape[0] < T:
                    raise ValueError(f"K2 sequence {var} has shape {tuple(t.shape)}, "
                                     f"expected at least ({T}, *{want[1:]})")
            elif tuple(t.shape) != want:
                raise ValueError(f"K2 input {var} has shape {tuple(t.shape)}, expected {want}")
            ins.append(t.contiguous())
        src = self.src

        def empty(v, lead=()):
            return torch.empty((*lead, *v.type.shape), dtype=torch_dtype(v.type.dtype),
                               device=self.device)

        outs = ([empty(v, (T,)) for v in src.state_outs] + [empty(v) for v in src.unt_outs]
                + [empty(v, (T,)) for v in src.nit_outs])
        scratch = torch.empty(max(src.arena, 16), dtype=torch.uint8, device=self.device)
        ptrs = [t.data_ptr() for t in ins + outs] + [scratch.data_ptr(), self.consts.data_ptr()]
        lib = self.build()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = lib.k2_launch((ctypes.c_ulonglong * len(ptrs))(*ptrs), T, stream)
        if err != 0:
            raise RuntimeError(f"K2 launch failed: CUDA error {err}")
        LAUNCHES += 1
        return outs

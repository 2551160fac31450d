"""K1: a CUDA kernel generated from the inner graph of a FusedElemwise.

Replaces ``pytensor_tpu/tensor/fused.py:33 pallas_elemwise_call``, which
broadcast and flattened every input, padded it to (rows, 128) lane tiles
and ran the inner jnp expression on VMEM blocks of 256 rows.

On Hopper the pass is bound by bytes, not operations: a fused node reads
each input once and writes each output once, with no reuse for shared
memory or tensor cores to serve.  At the radon graphs' sizes (919
elements, or 1,024 x 919) the card takes about a microsecond a launch, so
what a call costs is the host's launch path, and the design is mostly
about that:

- **Source.** One ``__global__`` function per FusedElemwise structure,
  emitted from the inner graph: one C++ expression per scalar op in
  topological order (the table of ``link/cuda/cexpr.py``, shared with
  K2), every intermediate in a register.  Scalar constants are exact
  literals of their dtype (hex floats), so a float64 graph keeps its
  constants; array constants of the inner graph (the radon observations)
  are extra inputs, moved to the device once.  Built with ``-fmad=false``
  so that each op rounds on its own, as torch's eager ops do.
- **Build.** Each structure is a namespace with a plain C entry
  ``k1_<key>(pointers, layout, stream)``; the kernels of a linked function
  are built together, in one nvcc call (``build``, which
  ``link/torch/linker.py`` calls for a CUDA device), into the gitignored
  ``build/kernels/``, cached by a hash of the source.  A kernel made alone
  builds its own library at its first launch.
- **Launch.** Everything that depends only on the inputs' shapes and
  strides (the iteration size, each operand's layout class and strides,
  the output shapes, the packed layout integers) is computed once per
  layout and kept.  A launch then checks devices and dtypes, allocates the
  outputs and makes one foreign call with an array of pointers and the
  layout array; the C entry sizes the grid, picks the 16-byte vector path
  where every operand allows it and launches on torch's current stream.
- **Host values.** A one-element input computed on the host from shapes
  (the length of a batch, cast, that a ``mean`` divides by) is passed in
  its pointer's place: its bytes in the pointer array, a host flag in the
  layout (``k1_bits``), so the call copies nothing to the device and a
  capture records the value its signature fixes.
- **Device.** 32-bit index arithmetic below 2**31 elements (and offsets).
  Each input is read by its layout class: contiguous with the iteration
  (``x[i]``), 0-d or broadcast everywhere (one load a thread, before the
  loop), or strided (the iteration index unravelled by its strides: a
  broadcast dim has stride 0).  Where every input is contiguous or 0-d and
  every output contiguous, and the pointers are 16-byte aligned, a thread
  loads and stores one ``float4``/``double2``, and the elements of the
  tail go to the threads after the last vector.  A thread takes one
  vector or one element, so every load of a launch is in flight at once:
  a 919-element float32 node (229 vectors and a tail of 3) is one block
  of 256 threads, a 1,024 x 919 node 3,676 blocks.

- **bfloat16.** An operand is ``__nv_bfloat16`` in memory and a float in
  registers; each op's result is rounded to bfloat16 before the next op
  reads it (``link/cuda/cexpr.py expression``), as XLA and torch round each
  bfloat16 op (rounding once at the end of a chain gives other values),
  and a special function computes in double and rounds once.  A vector is eight values.  The pass stays
  bound by bytes: at 2**24 elements the MFU step's class of node (three
  inputs, two outputs) moves 168 MB.

- **complex64 and complex128.** An operand is a ``float2`` or ``double2``
  (cuComplex's layout) in memory and in registers, and the ops of
  ``_COMPLEX_OPS`` are numpy's definitions (``link/cuda/cexpr.py
  COMPLEX_SOURCE``): Smith's division, the modulus by ``hypot``, ``clog``
  by ``log1p`` near the unit circle, C99's ``csqrt``.  A complex value
  inside a group stays in registers, and a kernel whose operands are all
  complex64 loads and stores two of them a 16-byte vector.  The pass
  stays bound by bytes: a complex op over 2**24 complex128 elements moves
  256 MB or more.

``emittable`` (and so ``tensor/fused.py fusable``) admits every op of the
expression table but ``second`` (``_OPS``, as the JAX package's fusion
groups every Elemwise but casts and ``second``) at the dtypes of
``_DTYPES`` (but ``_NO_BF16`` in bfloat16), the ops of ``_FLOAT_ONLY`` at
float dtypes only, the ops of ``_BOOL_OPS`` with a bool result and the
ops of ``_COMPLEX_OPS`` where an operand is complex (``real``, ``imag``,
``conj`` and ``angle`` of a complex operand only), so the rewritten graphs
hold the same FusedElemwise nodes as the JAX package's but where a complex
op is not among them.  Each operand is cast to its
compute dtype first (``ScalarOp.compute_dtypes``, the plain version's
rule).  The plain version evaluates the inner graph with torch
ops; the wrapper takes it for CPU tensors only, and on CUDA tensors
launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import time

import numpy as np
import torch

from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.link.cuda.cexpr import (
    CCEXPR,
    CEXPR,
    COMPLEX,
    ctype,
    expression,
    helpers,
    literal,
    load,
    operand,
    rtype,
    store,
)
from pytensor_tpu_torch.link.cuda.special import GRAD_STEPS
from pytensor_tpu_torch.utils import dtype_kind

THREADS = 256
# a grid of more blocks than this strides over the elements
MAX_BLOCKS = 4224
# each op rounds on its own, as torch's eager ops and the plain version do
K1_NVCC_FLAGS = ("-fmad=false",)
# an operand's layout class: contiguous with the iteration space, the same
# element everywhere (0-d or broadcast in every dim), or strided
CONTIG, SCALAR, STRIDED = 0, 1, 2

# launches of the kernel since the count was last set to 0
LAUNCHES = 0
# launches, since the counts were last set to 0, of the kernels that compute
# each of these device functions (the special functions' shape-parameter
# gradients, link/cuda/special.py): a launch counts once for each it holds
COUNTED_OPS = frozenset(GRAD_STEPS)
OP_LAUNCHES: collections.Counter = collections.Counter()
# (kernels, seconds, compiler log) of every nvcc build of K1 in this process
BUILDS: list = []

_DTYPES = ("float32", "float64", "bfloat16", "bool", "int8", "int16", "int32", "int64",
           "complex64", "complex128")
# every op of the expression table but ``second``: the JAX package's fusion
# groups every Elemwise but casts and ``second`` (its tensor/fused.py:147)
_OPS = (frozenset(CEXPR) | frozenset(CCEXPR)) - {"second"}
# ops K1 emits for floats only (an integer pow has no libdevice form)
_FLOAT_ONLY = frozenset({"true_div", "reciprocal", "exp", "log", "sqrt", "pow",
                         "sin", "cos", "tanh", "sigmoid"})
# ops K1 emits with a bool result: the comparisons and the ops whose value
# on bools is a bool (numpy's sub and negative refuse bools; its
# floor_divide, mod and shifts of bools give int8)
_BOOL_OPS = frozenset({"add", "mul", "abs", "sqr", "maximum", "minimum", "lt", "gt", "le",
                       "ge", "eq", "neq", "isnan", "isinf", "and_", "or_", "xor", "invert",
                       "switch", "clip", "identity"})
# ops K1 leaves to the plain version in bfloat16: numpy's floor division
# of floats is a chain of ops, which torch's floor_divide rounds to
# bfloat16 where K1 would keep float
_NO_BF16 = frozenset({"int_div"})
# the ops K1 emits where an operand or the result is complex (the table of
# ``cexpr.CCEXPR``); the first four take a complex operand only
_COMPLEX_OPS = frozenset(CCEXPR)
_COMPLEX_ONLY = frozenset({"real", "imag", "conj", "angle"})
# elements of one 16-byte vector, by C type in memory (a double2 is one)
_VECTOR = {"float": 4, "double": 2, "__nv_bfloat16": 8, "float2": 2}


def emittable(node) -> bool:
    """True when K1 can emit this Elemwise node's scalar op at its dtypes."""
    name = node.op.scalar_op.name
    if name not in _OPS:
        return False
    dtypes = [v.type.dtype for v in node.inputs + node.outputs]
    if any(d not in _DTYPES for d in dtypes):
        return False
    if name in _NO_BF16 and "bfloat16" in dtypes:
        return False
    complex_in = any(i.type.dtype in COMPLEX for i in node.inputs)
    if complex_in or any(d in COMPLEX for d in dtypes):
        return name in _COMPLEX_OPS and ("bfloat16" not in dtypes) and (
            complex_in or name not in _COMPLEX_ONLY)
    if name in _COMPLEX_ONLY:
        return False
    out = node.outputs[0].type.dtype
    if out == "bool":
        return name in _BOOL_OPS
    return name not in _FLOAT_ONLY or dtype_kind(out) == "f"


PRELUDE = f"""#include <cuda_runtime.h>
#include <math.h>

#define K1_THREADS {THREADS}
#define K1_MAX_BLOCKS {MAX_BLOCKS}
#define K1_CONTIG {CONTIG}
#define K1_SCALAR {SCALAR}
#define K1_STRIDED {STRIDED}
""" + r"""#ifndef K1_LAUNCH
#define K1_LAUNCH(kernel, blocks, stream, ...) \
  kernel<<<blocks, K1_THREADS, 0, stream>>>(__VA_ARGS__)
#endif

// a value from the host, passed in its pointer's place (its bytes, low first)
template <typename T> __device__ __forceinline__ T k1_bits(const void* q) {
  union { const void* p; T v; } u;
  u.p = q;
  return u.v;
}

template <int N> struct K1Ptrs { const void* q[N]; };

// The iteration size and each operand's class and strides, in elements
// (0 on a broadcast dim); xh: the input is a one-element value from the
// host, passed in its pointer's place; vec: the 16-byte vector path; strided:
// some operand is strided, so the index is unravelled.
template <int ND, int NIN, int NOUT> struct K1Layout {
  long long n;
  long long d[ND];
  long long xs[NIN > 0 ? NIN : 1][ND];
  long long ys[NOUT][ND];
  int xc[NIN > 0 ? NIN : 1];
  int xh[NIN > 0 ? NIN : 1];
  int yc[NOUT];
  int vec;
  int strided;
};

template <typename I, int ND>
__device__ __forceinline__ void k1_unravel(I i, const long long* d, I* idx) {
#pragma unroll
  for (int k = ND - 1; k > 0; --k) {
    const I q = i / (I)d[k];
    idx[k] = i - q * (I)d[k];
    i = q;
  }
  idx[0] = i;
}

template <typename I, int ND>
__device__ __forceinline__ I k1_offset(const I* idx, const long long* s) {
  I off = 0;
#pragma unroll
  for (int k = 0; k < ND; ++k) off += idx[k] * (I)s[k];
  return off;
}

template <typename I> __device__ __forceinline__ void k1_load(const float* p, I j, float* v) {
  const float4 q = reinterpret_cast<const float4*>(p)[j];
  v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
}
template <typename I> __device__ __forceinline__ void k1_load(const double* p, I j, double* v) {
  const double2 q = reinterpret_cast<const double2*>(p)[j];
  v[0] = q.x; v[1] = q.y;
}
template <typename I> __device__ __forceinline__ void k1_store(float* p, I j, const float* v) {
  float4 q; q.x = v[0]; q.y = v[1]; q.z = v[2]; q.w = v[3];
  reinterpret_cast<float4*>(p)[j] = q;
}
template <typename I> __device__ __forceinline__ void k1_store(double* p, I j, const double* v) {
  double2 q; q.x = v[0]; q.y = v[1];
  reinterpret_cast<double2*>(p)[j] = q;
}
// two complex64 values a 16-byte vector
template <typename I> __device__ __forceinline__ void k1_load(const float2* p, I j, float2* v) {
  const float4 q = reinterpret_cast<const float4*>(p)[j];
  v[0].x = q.x; v[0].y = q.y; v[1].x = q.z; v[1].y = q.w;
}
template <typename I> __device__ __forceinline__ void k1_store(float2* p, I j, const float2* v) {
  float4 q; q.x = v[0].x; q.y = v[0].y; q.z = v[1].x; q.w = v[1].y;
  reinterpret_cast<float4*>(p)[j] = q;
}

// Fills the kernel's arguments from the wrapper's arrays (the pointers of
// the inputs then the outputs; n, the sizes, the input then output
// strides and classes, the host flags, vec, strided, wide), keeps the vector path (of V
// elements a vector, 0 for none) only where every operand it reads or
// writes as vectors is 16-byte aligned, and launches on `stream`, with
// 32-bit indices unless `wide`, one thread for each vector and each
// element of the tail, or each element.
template <int ND, int NIN, int NOUT, int V, typename K32, typename K64>
int k1_launch(K32 k32, K64 k64, const unsigned long long* ptr, const long long* lay,
              void* stream) {
  K1Ptrs<NIN + NOUT> p;
  for (int k = 0; k < NIN + NOUT; ++k) p.q[k] = (const void*)ptr[k];
  K1Layout<ND, NIN, NOUT> L;
  const long long* c = lay;
  L.n = *c++;
  for (int d = 0; d < ND; ++d) L.d[d] = *c++;
  for (int k = 0; k < NIN; ++k)
    for (int d = 0; d < ND; ++d) L.xs[k][d] = *c++;
  for (int j = 0; j < NOUT; ++j)
    for (int d = 0; d < ND; ++d) L.ys[j][d] = *c++;
  for (int k = 0; k < NIN; ++k) L.xc[k] = (int)*c++;
  for (int k = 0; k < NIN; ++k) L.xh[k] = (int)*c++;
  for (int j = 0; j < NOUT; ++j) L.yc[j] = (int)*c++;
  L.vec = (int)*c++;
  L.strided = (int)*c++;
  const int wide = (int)*c++;
  for (int k = 0; k < NIN; ++k)
    if (L.xc[k] == K1_CONTIG && (ptr[k] & 15)) L.vec = 0;
  for (int j = 0; j < NOUT; ++j)
    if (ptr[NIN + j] & 15) L.vec = 0;
  if (V == 0) L.vec = 0;
  const long long units = L.n - (L.vec ? L.n / V : 0) * (V - 1);
  long long blocks = (units + K1_THREADS - 1) / K1_THREADS;
  if (blocks > K1_MAX_BLOCKS) blocks = K1_MAX_BLOCKS;
  if (wide)
    K1_LAUNCH(k64, (unsigned)blocks, (cudaStream_t)stream, p, L);
  else
    K1_LAUNCH(k32, (unsigned)blocks, (cudaStream_t)stream, p, L);
  return (int)cudaGetLastError();
}
"""


class _Layout:
    """What a launch needs for one layout of the inputs: the element count,
    the (shape, dtype) of each output, the layout integers of the C entry
    and the classes of the inputs and of the outputs."""

    __slots__ = ("n", "outs", "ints", "classes")

    def __init__(self, n, outs, ints, classes):
        self.n, self.outs, self.classes = n, outs, classes
        self.ints = (ctypes.c_longlong * len(ints))(*ints)


class FusedElemwiseKernel:
    """K1 for one FusedElemwise node on one device.

    ``__call__`` takes the node's input tensors.  On CPU tensors it runs
    the plain version; on CUDA tensors it launches the kernel, or raises.
    ``unit`` is the kernel's own source (a namespace and its C entry),
    ``key`` a hash of it, ``source`` the library source of this kernel
    alone.
    """

    def __init__(self, fgraph, device):
        self.fgraph = fgraph
        self.order = fgraph.toposort()
        self.inputs = list(fgraph.inputs)
        self.outputs = list(fgraph.outputs)
        from pytensor_tpu_torch.link.torch.convert import as_torch, resolve_device, torch_dtype

        self.device = resolve_device(device)
        for node in self.order:
            node.op.scalar_op.check_inputs(*(i.type.dtype for i in node.inputs))
            if not emittable(node):
                raise TypeError(f"K1 cannot emit {node}")
        self.counted = sorted({n.op.scalar_op.name for n in self.order} & COUNTED_OPS)
        # scalar constants are literals; every other constant is an input
        self.array_consts = []
        for node in self.order:
            for i in node.inputs:
                if isinstance(i, Constant) and np.ndim(i.data) and i not in self.array_consts:
                    self.array_consts.append(i)
        self.tensor_vars = self.inputs + self.array_consts
        self.const_tensors = [as_torch(c.data, self.device) for c in self.array_consts]
        self._const_ptrs = [t.data_ptr() for t in self.const_tensors]
        self.in_dtypes = [torch_dtype(v.type.dtype) for v in self.inputs]
        self.out_dtypes = [torch_dtype(o.type.dtype) for o in self.outputs]
        self._plain_consts: dict = {}
        self.ndim = max([1] + [v.type.ndim for v in self.tensor_vars + self.outputs])
        # elements of a 16-byte vector where every operand has one C type
        # that has them, else 0: no vector path
        ctypes_ = {ctype(v.type.dtype) for v in self.tensor_vars + self.outputs}
        self.vector = _VECTOR.get(ctypes_.pop(), 0) if len(ctypes_) == 1 else 0
        body = self._emit()
        self.key = hashlib.sha256(body.encode()).hexdigest()[:16]
        self.unit = self._unit(body)
        self.source = library_source([self.unit])
        self._layouts: dict = {}
        self._ptrs_t = ctypes.c_ulonglong * (len(self.tensor_vars) + len(self.outputs))
        self._fn = None

    # --- code generation -------------------------------------------------
    def _emit(self) -> str:
        """The kernel's namespace body: the scalar body ``op`` and the
        ``__global__`` function over the iteration space."""
        nd, nin, nout = self.ndim, len(self.tensor_vars), len(self.outputs)
        # C types in memory (the pointers) and in registers (the operands)
        dts = [v.type.dtype for v in self.tensor_vars]
        odts = [o.type.dtype for o in self.outputs]
        cts, octs = [ctype(d) for d in dts], [ctype(d) for d in odts]
        rts, orts = [rtype(d) for d in dts], [rtype(d) for d in odts]
        names = {v: (f"a{k}", v.type.dtype) for k, v in enumerate(self.tensor_vars)}
        op = []
        for n, node in enumerate(self.order):
            so = node.op.scalar_op
            out_dt = node.outputs[0].type.dtype
            comp = so.compute_dtypes([i.type.dtype for i in node.inputs], out_dt)
            args = []
            for i, cdt in zip(node.inputs, comp):
                if isinstance(i, Constant) and not np.ndim(i.data):
                    args.append(literal(i.data, cdt))
                    continue
                expr, dt = names[i]
                args.append(operand(expr, dt, cdt))
            op.append(f"  const {rtype(out_dt)} v{n} = {expression(so.name, args, comp, out_dt)};")
            names[node.outputs[0]] = (f"v{n}", out_dt)
        for j, o in enumerate(self.outputs):
            op.append(f"  r{j} = {names[o][0]};")
        params = ([f"const {rt} a{k}" for k, rt in enumerate(rts)]
                  + [f"{rt}& r{j}" for j, rt in enumerate(orts)])
        V = self.vector

        def call(a, r):
            return f"op({', '.join([*a, *r])});"

        lines = [
            f"constexpr int ND = {nd}, NIN = {nin}, NOUT = {nout};",
            "",
            f"__device__ __forceinline__ void op({', '.join(params)}) {{",
            *op,
            "}",
            "",
            "template <typename I>",
            "__global__ void __launch_bounds__(K1_THREADS) kernel(K1Ptrs<NIN + NOUT> p, "
            "K1Layout<ND, NIN, NOUT> L) {",
            *[f"  const {ct}* __restrict__ x{k} = (const {ct}*)p.q[{k}];"
              for k, ct in enumerate(cts)],
            *[f"  {ct}* __restrict__ y{j} = ({ct}*)p.q[NIN + {j}];" for j, ct in enumerate(octs)],
            "  const I n = (I)L.n;",
            "  const I first = (I)blockIdx.x * K1_THREADS + (I)threadIdx.x;",
            "  const I step = (I)gridDim.x * K1_THREADS;",
            "  // an input that is one element everywhere: one load a thread",
            *[f"  const {rt} s{k} = L.xc[{k}] != K1_SCALAR ? {_zero(rt)} : L.xh[{k}] ? "
              f"{_host_value(ct, k)} : {load(f'x{k}[0]', dt)};"
              for k, (ct, rt, dt) in enumerate(zip(cts, rts, dts))],
            # unit j is vector j below nv, else element j + nv * (V - 1): each
            # thread a vector or an element of the tail, side by side
            f"  const I nv = L.vec ? n / {max(V, 1)} : 0;",
            f"  for (I j = first; j < n - nv * {max(V, 1) - 1}; j += step) {{",
        ]
        if V:
            lines += [
                "    if (j < nv) {",
                *[f"      {rt} a{k}[{V}];" for k, rt in enumerate(rts)],
                *[f"      if (L.xc[{k}] == K1_SCALAR) {{ for (int v = 0; v < {V}; ++v) "
                  f"a{k}[v] = s{k}; }} else k1_load(x{k}, j, a{k});" for k in range(nin)],
                *[f"      {rt} r{j}[{V}];" for j, rt in enumerate(orts)],
                "#pragma unroll",
                f"      for (int v = 0; v < {V}; ++v) "
                + call([f"a{k}[v]" for k in range(nin)], [f"r{j}[v]" for j in range(nout)]),
                *[f"      k1_store(y{j}, j, r{j});" for j in range(nout)],
                "      continue;",
                "    }",
            ]
        lines += [
            f"    const I i = j + nv * {max(V, 1) - 1};",
            "    I idx[ND];",
            "    if (L.strided) k1_unravel<I, ND>(i, L.d, idx);",
            *[f"    const {rt} a{k} = L.xc[{k}] == K1_CONTIG ? {load(f'x{k}[i]', dt)} : "
              f"L.xc[{k}] == K1_SCALAR ? s{k} : "
              f"{load(f'x{k}[k1_offset<I, ND>(idx, L.xs[{k}])]', dt)};"
              for k, (rt, dt) in enumerate(zip(rts, dts))],
            *[f"    {rt} r{j};" for j, rt in enumerate(orts)],
            "    " + call([f"a{k}" for k in range(nin)], [f"r{j}" for j in range(nout)]),
            *[f"    if (L.yc[{j}] == K1_CONTIG) y{j}[i] = {store(f'r{j}', dt)}; "
              f"else y{j}[k1_offset<I, ND>(idx, L.ys[{j}])] = {store(f'r{j}', dt)};"
              for j, dt in enumerate(odts)],
            "  }",
            "}",
        ]
        return "\n".join(lines) + "\n"

    def _unit(self, body) -> str:
        ns = f"k1_{self.key}_kernel"
        return (f"\nnamespace {ns} {{\n\n{body}\n}}  // namespace {ns}\n\n"
                f"// Launches {ns}::kernel on `stream`; returns the first CUDA error.\n"
                f'extern "C" int k1_{self.key}(const unsigned long long* ptr, const long long* layout, '
                "void* stream) {\n"
                f"  return k1_launch<{ns}::ND, {ns}::NIN, {ns}::NOUT, {self.vector}>(\n"
                f"      {ns}::kernel<int>, {ns}::kernel<long long>, ptr, layout, stream);\n"
                "}\n")

    # --- runtime layout ----------------------------------------------------
    def _layout(self, args):
        """The iteration size, output shapes, layout classes and the packed
        layout integers for inputs of these shapes and strides."""
        nd = self.ndim
        shapes = {v: tuple(a.shape) for v, a in zip(self.tensor_vars, args)}
        for node in self.order:
            shapes[node.outputs[0]] = tuple(torch.broadcast_shapes(
                *[shapes.get(i, ()) for i in node.inputs]))
        it = tuple(torch.broadcast_shapes(*shapes.values()))
        it = (1,) * (nd - len(it)) + it
        n = int(np.prod(it))
        row = [int(np.prod(it[d + 1:])) for d in range(nd)]

        def strides(shape, stride):
            pad = nd - len(shape)
            st = [0] * pad + [0 if s == 1 else t for s, t in zip(shape, stride)]
            return [0 if it[d] == 1 else st[d] for d in range(nd)]

        def cls(st):
            if all(st[d] == row[d] for d in range(nd) if it[d] > 1):
                return CONTIG
            return SCALAR if not any(st) else STRIDED

        out_shapes = [shapes[o] for o in self.outputs]
        if not n and any(np.prod(s) for s in out_shapes):
            raise ValueError(f"K1: an output of shape {out_shapes} over an empty iteration "
                             f"space {it}")
        xst = [strides(tuple(a.shape), a.stride()) for a in args]
        xh = [int(a.device.type == "cpu" and self.device.type != "cpu") for a in args]
        yst = [strides(s, torch.empty(s, device="meta").stride()) for s in out_shapes]
        # a host value is read from its pointer's place only as a 0-d input
        # (a 0-d iteration space would call every input contiguous)
        xc = [SCALAR if h else cls(s) for s, h in zip(xst, xh)]
        yc = [cls(s) for s in yst]
        strided = STRIDED in xc + yc
        reach = max([n] + [sum((it[d] - 1) * s[d] for d in range(nd)) + 1 for s in xst + yst])
        ints = [n, *it, *[s for st in xst + yst for s in st], *xc, *xh, *yc,
                int(not strided and all(c == CONTIG for c in yc)), int(strided),
                int(reach >= 2 ** 31)]
        return _Layout(n, list(zip(out_shapes, self.out_dtypes)), ints, (xc, yc))

    def _args(self, inputs):
        if len(inputs) != len(self.inputs):
            raise TypeError(f"FusedElemwise expected {len(self.inputs)} inputs, got {len(inputs)}")
        return list(inputs) + self.const_tensors

    # --- the two versions ----------------------------------------------------
    def __call__(self, *inputs):
        if all(t.device.type == "cpu" for t in inputs):
            return self.plain(*inputs)
        return self.launch(*inputs)

    def launch(self, *inputs):
        """Run the kernel on CUDA tensors: one foreign call."""
        global LAUNCHES
        if len(inputs) != len(self.in_dtypes):
            raise TypeError(f"FusedElemwise expected {len(self.inputs)} inputs, got {len(inputs)}")
        dev = self.device
        key = []
        host = False
        for a, dt in zip(inputs, self.in_dtypes):
            if dev.type != "cuda" or (a.device != dev
                                      and (a.device.type != "cpu" or a.numel() != 1)):
                raise RuntimeError(f"K1 runs on {dev} CUDA tensors and one-element host values; "
                                   f"got a tensor of shape {tuple(a.shape)} on {a.device}")
            if a.dtype != dt:
                raise TypeError(f"K1 input dtype {a.dtype} != {dt}")
            if a.device.type == "cpu" and a.element_size() > 8:
                raise TypeError(f"K1 takes a host value of at most 8 bytes in its pointer's "
                                f"place; got {a.dtype}")
            host = host or a.device.type == "cpu"
            # a contiguous tensor's layout is its shape (and, from the host, its device)
            key.append((a.shape, a.device.type) if a.device.type == "cpu" else
                       a.shape if a.is_contiguous() else (a.shape, a.stride()))
        lay = self._layouts.get(tuple(key))
        if lay is None:
            lay = self._layouts[tuple(key)] = self._layout(self._args(inputs))
        outs = [torch.empty(s, dtype=dt, device=dev) for s, dt in lay.outs]
        if lay.n:
            fn = self._fn or self._load()
            ptrs = self._ptrs_t(*[_host_bits(a) if host and a.device.type == "cpu"
                                  else a.data_ptr() for a in inputs], *self._const_ptrs,
                                *[o.data_ptr() for o in outs])
            err = fn(ptrs, lay.ints, _raw_stream(dev.index))
            if err != 0:
                raise RuntimeError(f"K1 launch failed: CUDA error {err}")
            LAUNCHES += 1
            OP_LAUNCHES.update(self.counted)
        return outs

    def _load(self):
        build([self])
        return self._fn

    def plain(self, *inputs):
        """The same inner graph evaluated with torch ops, on any device."""
        from pytensor_tpu_torch.link.torch.dispatch import elemwise_fn
        from pytensor_tpu_torch.link.torch.convert import as_torch

        args = self._args(inputs)
        dev = args[0].device if args else self.device
        consts = self._plain_consts.get(dev)
        if consts is None:
            consts = self._plain_consts[dev] = {
                i: as_torch(i.data, dev)
                for node in self.order for i in node.inputs
                if isinstance(i, Constant)}
        storage = {**consts, **dict(zip(self.tensor_vars, (a.to(dev) for a in args)))}
        for node in self.order:
            storage[node.outputs[0]] = elemwise_fn(node)(*[storage[i] for i in node.inputs])
        return [storage[o].contiguous() for o in self.outputs]


def _zero(rt):
    """A zero of register type ``rt`` (a complex one has no C cast)."""
    return f"{rt}{{}}" if rt in ("float2", "double2") else f"({rt})0"


def _host_value(ct, k):
    """The C++ of input ``k``'s value from the host, of C type ``ct``,
    passed in its pointer's place."""
    if ct == "__nv_bfloat16":
        return f"k2_bfbits(p.q[{k}])"
    return f"k1_bits<{ct}>(p.q[{k}])"


def _host_bits(a):
    """A one-element host value's bytes as the integer that takes its pointer's
    place (``k1_bits``)."""
    from pytensor_tpu_torch.link.torch.convert import to_numpy

    return int.from_bytes(to_numpy(a).tobytes().ljust(8, b"\0"), "little")


def _raw_stream(index):
    """torch's current stream on the card ``index``, as an integer (the
    call Triton's and Inductor's launchers make; ``torch.cuda.current_stream``
    wraps it in a Python object first)."""
    return torch._C._cuda_getCurrentRawStream(index)


def library_source(units) -> str:
    """The source of a library of K1 units: the prelude, the expression
    table's helpers that the units call (``cexpr.helpers``) and the units."""
    body = "".join(units)
    return PRELUDE + helpers(body, have=()) + body


# key -> the C entry of every K1 kernel loaded in this process
_ENTRIES: dict = {}


def build(kernels, verbose=False) -> str:
    """Build the kernels not loaded yet in one library (one nvcc call),
    their units in the order of their keys, and bind every kernel to its
    entry.  Returns the compiler's log (``-Xptxas -v`` with ``verbose``),
    empty when nothing was compiled."""
    from pytensor_tpu_torch.link.cuda.build import build_library

    units = {k.key: k.unit for k in kernels if k.key not in _ENTRIES}
    log = ""
    if units:
        t0 = time.perf_counter()
        lib, log = build_library(library_source([units[k] for k in sorted(units)]), "k1",
                                 verbose=verbose, flags=K1_NVCC_FLAGS)
        for key in units:
            fn = getattr(lib, f"k1_{key}")
            fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_longlong),
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
            _ENTRIES[key] = fn
        BUILDS.append((len(units), time.perf_counter() - t0, log))
    for k in kernels:
        k._fn = _ENTRIES[k.key]
    return log

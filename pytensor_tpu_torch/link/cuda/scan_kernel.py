"""K2: a whole for-scan as one CUDA kernel, generated per Scan node.

Replaces ``pytensor_tpu/link/pallas/scan_pallas.py:101
make_pallas_scan_fn``, which traced the inner graph into one Pallas
kernel with an in-kernel ``fori_loop`` so that states, sequences and
constants stayed in VMEM and a step cost no kernel launch.  The TPU
layout of that kernel (the vmap to a size-1 leading dim, the rank-2
padding, ``mosaic_safe``, the VMEM budget) is not carried over.

On Hopper the loop runs in one thread block of 1,024 threads:
``for (t = 0; t < T; ++t) { the inner graph }``.  A step of the radon
leapfrog body is ~160 small ops on vectors of at most 919 elements, so
bytes and flops bound nothing; latency does: each round trip of a value
through memory, each barrier of 32 warps, each chain of scalar ops that
thread 0 runs while the others wait, and each product that streams a
matrix through L2.  Stamps of ``clock64()`` (the ``stamps`` source, read
by ``chip_smoke.py``) split a step by op on the card.  The design does
what it can about each:

- **Source.** Emitted at link time from the inner graph, with static
  shapes folded into the index arithmetic.  Built with nvcc for sm_90a
  (``link/cuda/build.py``) with ``-fmad=false``, cached by a hash of the
  source, called through ``ctypes`` on torch's current stream.
- **Order.** The nodes are scheduled so that element-wise ops of one size
  follow each other, ready reductions come together and a one-hot
  product opens a run (``_schedule``); the order only moves ops whose
  inputs are ready, so every value is what the graph's order computes.
- **Runs in registers.** Consecutive element-wise ops of one size
  (``Elemwise``, the copies of ``Subtensor``/``DimShuffle``/``Alloc``,
  ``IncSubtensor``, a one-hot product) are one loop: element ``i`` on
  thread ``i % 1024`` (thread 0 for a scalar), each op's value in a
  register.  A value gets a slot only when something outside its run reads
  it: another index, another run, a reduction or the end of the step.
  Without FMA contraction each op still rounds on its own, as the step
  loop's ops do; the plain ``Dot`` keeps its multiply-adds as explicit
  FMAs.
- **Memory.** Slots are given by liveness: a slot is taken where it is
  first written and given back after its last reader, to be reused only
  past the next barrier.  The arena (the slots, the carried double
  buffers) sits in dynamic shared memory when it fits beside the
  reduction buffers (``SMEM_LIMIT``), else in a torch scratch tensor; the
  graph constants and index tables go to shared memory, copied there
  before the loop, while they fit.  ``placement`` says which, decided at
  emit time.  Views that keep the row-major order (``Reshape``,
  ``SpecifyShape``, a ``DimShuffle`` that only adds or drops length-1
  dims, a contiguous ``Subtensor``) alias their input.  Scalar constants
  are exact literals of their dtype (hex floats).  States are
  double-buffered: step ``t`` reads parity ``t & 1`` and the end of the
  step writes parity ``(t + 1) & 1`` and row ``t`` of each trace and
  nit-sot.  Untraced states are written once, at the end.
- **One-hot products as index loads.** A ``Dot`` against a 2-D constant
  whose rows (or columns) each hold one 1 and zeros, as the
  ``onehot_gather`` rewrites make of a gather and a segment sum for the
  TPU's matrix unit, reads its operand through indices computed here:
  ``out[i] = 0 + v[col[i]]``, or a segment sum over a CSR of the rows of
  each column in ascending order, summed in the order the plain ``Dot``
  would sum the whole product, so the value is the product's bit for bit.
  A ``__syncthreads_or`` over the operand's non-finite elements is the
  barrier the product needs anyway and keeps its NaN where a 0 meets an
  inf.  The matrix leaves the constants.
- **Barriers.** A ``__syncthreads()`` goes before a loop only when it
  reads a value written since the last barrier by another thread; ready
  block reductions share one.
- **Ops.** ``Elemwise`` is one C++ expression per scalar op (the table
  of ``link/cuda/cexpr.py``, shared with K1), broadcast by strides,
  ``expf``/``exp`` by dtype and IEEE division.  ``CAReduce`` (sum, product, max) and the plain
  ``Dot`` take one thread per output element, or one warp per output
  element with a fixed shuffle tree when the reduced length is long
  against the number of outputs; a full reduction is a block reduction,
  warp shuffles then one warp over the 32 partials.  ``Dot22`` is that
  ``Dot``; ``Gemm`` and ``Dot22Scalar`` are too, with their scaling and
  add after the sum, each multiply and add rounded on its own.  ``Join``
  is a unit of a run whose element reads the input that holds it,
  ``ARange`` a unit computing numpy's ``first + i * delta``; each part of
  a ``Split`` is a basic slice (a view where it keeps the row-major
  order), and ``DeepCopyOp`` and ``ViewOp`` alias their input (slots are
  never written in place).  Every order is fixed,
  so K2 is deterministic.  ``MakeVector`` runs on thread 0;
  ``Shape``/``Shape_i`` are literals written before the loop.  Values
  that only feed static shape inputs (of ``Reshape``, ``SpecifyShape``,
  ``Alloc``) are not computed.

A bfloat16 value is 2 bytes in the arguments, the slots and the arena (16-
byte aligned as every slot) and a float in registers: each op rounds its
result to bfloat16 as K1's do, and a product, a reduction or a one-hot
segment sum accumulates in float and rounds once.

Eligibility keeps the structure of ``scan_pallas.py:54
pallas_scan_eligible``: every tap ``(-1,)`` (the port has no while-scans),
static shapes for every inner variable and sequence, dtypes in
``_OK_DTYPES``, only ops this emitter covers, and the JAX package's 4 MiB
budget, computed as it computes it (``_budget_bytes``: 4 bytes an element,
bfloat16 too), so that the same
scans take the kernel in both packages: a scan over a full-width weight
takes the step loop rather than one block.  The kernel's own limit,
32-bit element offsets, holds too.  A
``Subtensor`` or ``IncSubtensor``
with a dynamic index is not emitted (its bounds check needs the host),
so such a scan takes the loop here where the JAX package would take its
kernel.  The plain version is the step loop of ``link/torch/dispatch.py
scan_loop``; the wrapper runs it on CPU tensors only, and on CUDA
tensors launches the kernel or raises.
"""

from __future__ import annotations

import collections
import ctypes
import math

import numpy as np
import torch

from pytensor_tpu_torch.compile.ops import DeepCopyOp, ViewOp
from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.link.cuda import cexpr
from pytensor_tpu_torch.link.cuda.cexpr import (
    CEXPR,
    MAX_SOURCE,
    ctype,
    expression,
    helpers,
    literal,
    load,
    rtype,
    store,
)
from pytensor_tpu_torch.tensor.basic import ARange, Alloc, Join, MakeVector, Split
from pytensor_tpu_torch.tensor.blas import Dot22, Dot22Scalar, Gemm
from pytensor_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise
from pytensor_tpu_torch.tensor.fused import FusedElemwise
from pytensor_tpu_torch.tensor.math import Dot, _dot
from pytensor_tpu_torch.tensor.shape import Reshape, Shape, Shape_i, SpecifyShape
from pytensor_tpu_torch.tensor.subtensor import DYN, IncSubtensor, Subtensor
from pytensor_tpu_torch.utils import dtype_kind, np_dtype

THREADS = 1024
WARPS = THREADS // 32
# no contraction of a multiply and an add into an FMA: an op that a run
# keeps in a register rounds as it does alone, and as the step loop does
K2_NVCC_FLAGS = ("-fmad=false",)
# the steps whose clock64() stamps a stamped source records
STAMP_FROM, STAMP_STEPS = 16, 16

# launches of the kernel since the count was last set to 0
LAUNCHES = 0

# the JAX package's _OK_DTYPES (scan_pallas.py:49) less uint16 and uint32,
# which the port holds in int64 (link/torch/convert.py UNSIGNED): a scan of
# them is refused at rewrite time and takes the step loop.  A bfloat16
# value is 2 bytes in the slots, the arena and the arguments and a float in
# registers; each op rounds its result to bfloat16 as K1's do
# (``cexpr.expression``), and a product or a reduction accumulates in
# float and rounds once
_OK_DTYPES = ("float32", "bfloat16", "bool", "int8", "int16", "int32", "int64", "uint8")

_FLOAT_ONLY = frozenset({"true_div", "reciprocal", "exp", "log", "sqrt", "sin", "cos",
                         "tanh", "sigmoid"})
# ops left to the step loop in bfloat16, as K1 leaves them to the plain
# version (``tensor/fused_kernel.py _NO_BF16``)
_NO_BF16 = frozenset({"int_div"})


def _lowest(dtype):
    if dtype == "bool":
        return False
    return -np.inf if dtype_kind(dtype) == "f" else np.iinfo(dtype).min


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
// the dynamic shared memory: reduction buffers, arena, constants
#ifndef K2_SHARED_ARENA
#define K2_SHARED_ARENA extern __shared__ __align__(16) unsigned char k2_smem[]
#endif

template <typename T> __device__ __forceinline__ T k2_warp_add(T v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
template <typename T> __device__ __forceinline__ T k2_warp_mul(T v) {
  for (int o = 16; o > 0; o >>= 1) v *= __shfl_down_sync(0xffffffffu, v, o);
  return v;
}
""" + MAX_SOURCE + r"""template <typename T> __device__ __forceinline__ T k2_warp_max(T v) {
  for (int o = 16; o > 0; o >>= 1) v = k2_max(v, __shfl_down_sync(0xffffffffu, v, o));
  return v;
}
template <typename T> __device__ __forceinline__ T k2_ipow(T a, T b) {
  T r = 1;
  for (T i = 0; i < b; ++i) r *= a;
  return r;
}
"""


def _acc_ctype(dtype):
    """The accumulator's C type: warp shuffles take 32 and 64-bit values
    (bfloat16 accumulates in float)."""
    if dtype in ("bool", "int8", "int16"):
        return "int"
    if dtype in ("uint8", "uint16"):
        return "unsigned int"
    return rtype(dtype)


def _from_acc(acc, dtype):
    """An accumulator's value as it is stored in ``dtype`` (a bfloat16
    rounded once)."""
    return store(acc, dtype) if dtype == "bfloat16" else f"({ctype(dtype)}){acc}"


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
        if name not in CEXPR:
            return False
        if name in _NO_BF16 and any(v.type.dtype == "bfloat16"
                                    for v in node.inputs + node.outputs):
            return False
        return name not in _FLOAT_ONLY or dtype_kind(node.outputs[0].type.dtype) == "f"
    if isinstance(op, CAReduce):
        return op.scalar_op.name in _REDUCE
    if isinstance(op, (Dot, Dot22, Gemm, Dot22Scalar)):
        return node.outputs[0].type.dtype != "bool"
    if isinstance(op, (Subtensor, IncSubtensor)):
        return not _dynamic_index(op)
    if isinstance(op, ARange) and node.outputs[0].type.dtype == "bfloat16":
        return False
    if isinstance(op, (Join, Split, ARange)):
        # static axes, sizes and bounds (the static output shapes the
        # eligibility asks for imply them)
        return all(isinstance(i, Constant) for i in _static_inputs(node))
    return isinstance(op, (DimShuffle, Reshape, SpecifyShape, Alloc, MakeVector,
                           Shape, Shape_i, DeepCopyOp, ViewOp))


def _static_inputs(node):
    """The inputs of a Join, Split or ARange that fix its shape."""
    op = node.op
    if isinstance(op, Join):
        return node.inputs[:1]
    if isinstance(op, Split):
        return node.inputs[1:]
    return node.inputs


# the JAX package's VMEM budget (scan_pallas.py:86-98), computed as it
# computes it: 4 bytes an element of the inner inputs, the outer
# sequences and the inner graph's constants of one dim or more
BUDGET_BYTES = 4 << 20


def _budget_bytes(op, node) -> int:
    from pytensor_tpu_torch.graph.traversal import ancestors

    total = 0
    for v in op.fgraph.inputs:
        total += int(np.prod(v.type.shape or (1,), initial=1)) * 4
    if node is not None:
        for s in node.inputs[1: 1 + op.info.n_seqs]:
            total += int(np.prod(s.type.shape, initial=1)) * 4
    for v in ancestors(op.fgraph.outputs):
        if isinstance(v, Constant) and getattr(v.type, "ndim", 0) >= 1:
            total += int(np.asarray(v.data).size) * 4
    return total


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
    # and the JAX package's budget, so that the same scans take the kernel
    # in both packages: a scan whose step holds a large product (a full-width
    # GEMM chain) takes the step loop, not one block
    return total < 2 ** 31 and _budget_bytes(op, node) <= BUDGET_BYTES


# --- the emitter ------------------------------------------------------------------

# dynamic shared memory one block may use on sm_90
# (cudaDevAttrMaxSharedMemoryPerBlockOptin of the H100)
SMEM_LIMIT = 232448
# the block reductions' partials open the shared memory: two sets of
# _RED_BATCH buffers of 32, a batch of reductions to a set, in turn
_RED_BATCH = 4
_RED_BYTES = 2 * _RED_BATCH * 32 * 8


def _align(n):
    return (n + 15) // 16 * 16


class _Loc:
    """Where a variable's elements live: ``root[off + i]``."""

    __slots__ = ("root", "off", "dtype", "shape", "const")

    def __init__(self, root, off, dtype, shape, const=None):
        self.root, self.off, self.dtype, self.shape = root, off, dtype, tuple(shape)
        self.const = const  # the value of every element, for a constant of one value

    @property
    def size(self):
        return _size(self.shape)

    def at(self, idx):
        if self.const is not None:
            return literal(self.const, self.dtype)
        return f"{self.root}[{self.off} + {idx}]" if self.off else f"{self.root}[{idx}]"

    def value(self, idx):
        """Element ``idx`` read into a register (a bfloat16 widened)."""
        return self.at(idx) if self.const is not None else load(self.at(idx), self.dtype)


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
        if isinstance(node.op, Dot22):
            enodes.append(_ENode(_dot, node.inputs, node.outputs))
            continue
        if isinstance(node.op, Split):
            # each part is a basic slice along the axis: a view where it
            # keeps the row-major order, else a strided copy
            x, axis, sizes = node.inputs
            a = int(np.asarray(axis.data)) % x.type.ndim
            start = 0
            for size, out in zip(np.asarray(sizes.data).tolist(), node.outputs):
                idx = [("slice", None, None, None)] * a + [("slice", start, start + size, None)]
                enodes.append(_ENode(Subtensor(idx), [x], [out]))
                start += size
            continue
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
               Alloc: lambda i: i >= 1, Shape: lambda i: True, Shape_i: lambda i: True,
               Join: lambda i: i == 0, ARange: lambda i: True}


class _Writer:
    """Which thread wrote each element of a slot since the last barrier."""

    STD, T0, OTHER = "std", "t0", "other"


class _Unit:
    """An op computed element by element: element ``i`` of ``out`` on the
    thread that runs ``i`` (thread 0 for a single element).  ``reads`` are
    ``(var, mode)`` pairs: ``"reg"`` when the op reads element ``i`` of an
    input of its own size (a register, if the run made it), ``"ident"``
    when it reads element ``i`` of a smaller input, ``"gen"`` for any other
    element.  ``code(r, u, flag)`` gives the C++ lines
    that leave element ``i`` in the register ``r`` (``u`` keeps names
    apart; ``flag`` is the run's non-finite flag).  ``guard`` is the
    operand of a one-hot product whose non-finite elements the run's
    leading ``__syncthreads_or`` flags."""

    __slots__ = ("pos", "out", "n", "reads", "code", "cls", "guard")

    def __init__(self, pos, out, reads, code, cls, guard=None):
        self.pos, self.out, self.reads, self.code = pos, out, reads, code
        self.n = _size(out.type.shape)
        self.cls, self.guard = cls, guard


class _Run:
    """Consecutive units of one size, emitted as one loop."""

    __slots__ = ("n", "units", "outs")

    def __init__(self, n):
        self.n, self.units, self.outs = n, [], set()


# how a one-hot product is emitted (ScanKernelSource._onehot)
_OneHot = collections.namedtuple("_OneHot", "kind side m v idx P C B by_warp")


def _small_index(values):
    """``values`` as the smallest unsigned type that holds them."""
    values = np.asarray(values, dtype=np.int64)
    return values.astype("uint16" if values.max(initial=0) < 2 ** 16 else "int32")


class ScanKernelSource:
    """The CUDA source of K2 for one Scan node, and its argument layout.

    Besides ``source``: ``const_bytes``, the graph constants and one-hot
    index tables, uploaded once; ``arena``, the bytes of the slots after
    reuse; ``placement``, ``"shared"`` when the arena fits in shared
    memory beside the reduction buffers, else ``"device"`` (a torch
    scratch tensor), decided here; ``smem_bytes``, the dynamic shared
    memory of a launch (the reduction buffers, the arena when shared, and
    the constants that fit, ``smem_const_bytes`` of them); ``n_ops``, the
    loops of a step (a merged run is one), ``n_units``, the ops emitted,
    and ``n_barriers``, the barriers of a step.
    """

    def __init__(self, op, node, stamps=False):
        self.op, self.node = op, node
        # with stamps, thread 0 records clock64() after each loop and barrier
        # of steps STAMP_FROM.. into one more argument; stamp_labels gives
        # each stamp's (op class, description), stamp 0 being the step's start
        self.stamps = stamps
        self.stamp_labels = [("start", "step start")]
        info = op.info
        self.info = info
        self.loc: dict = {}
        self.slots: dict = {}       # arena slot name -> (C type, bytes)
        self.pinned: list = []      # slots live for the whole launch
        self.events: list = []      # per emitted loop (slots read, slots written); None: a barrier
        self.consts: list = []      # (name, C type, bytes) of the constants and index tables
        self.root_of: dict = {}     # view -> (the variable that owns its elements, offset)
        self.consumers: dict = {}   # owner -> [(position of the reader or "end", var read)]
        self.regs: dict = {}        # slot name -> (register, size), inside a run
        self.run = None
        self.n_barriers = self.n_ops = self.n_units = 0
        self.dirty: dict = {}
        self.red_set = 0
        self.reds: list = []        # block reductions waiting for one barrier
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

    # --- slots and constants --------------------------------------------------
    def _slot(self, name, dtype, n, pinned=False):
        self.slots[name] = (ctype(dtype), _align(max(n, 1) * np_dtype(dtype).itemsize))
        if pinned:
            self.pinned.append(name)
        return name

    def _table(self, data):
        """A constant array in the constants buffer (once for equal
        contents); returns its name."""
        data = np.ascontiguousarray(data)
        ct = ctype(str(data.dtype))
        raw = data.tobytes()
        raw += b"\0" * ((-len(raw)) % 16)
        for name, ct2, raw2 in self.consts:
            if ct2 == ct and raw2 == raw:
                return name
        name = f"c{len(self.consts)}"
        self.consts.append((name, ct, raw))
        return name

    def _const_slot(self, c):
        """A graph constant: a literal when all its elements have one value
        (bit for bit), else a table."""
        data = np.array(c.data, dtype=np_dtype(c.type.dtype), order="C")
        raw, item = data.tobytes(), data.dtype.itemsize
        if data.size and raw == raw[:item] * data.size:
            return _Loc("", 0, c.type.dtype, c.type.shape, const=data.reshape(-1)[0])
        return _Loc(self._table(data), 0, c.type.dtype, c.type.shape)

    def get(self, v):
        v = self.alias.get(v, v)
        if v not in self.loc:
            if not isinstance(v, Constant):
                raise KeyError(f"K2: no slot for {v}")
            self.loc[v] = self._const_slot(v)
        return self.loc[v]

    def _root(self, v):
        v = self.alias.get(v, v)
        return self.root_of.get(v, (v, 0))

    def operand(self, v, idx, dtype, ident=False):
        """C++ value of element ``idx`` of ``v`` cast to ``dtype``; inside a
        run, a register where ``ident`` and ``v`` is the run's own."""
        loc = self.get(v)
        bf16 = "bfloat16" in (loc.dtype, dtype)
        if loc.const is not None:
            lit = literal(loc.const, loc.dtype)
            return cexpr.operand(lit, loc.dtype, dtype) if bf16 else f"(({ctype(dtype)}){lit})"
        reg = self.regs.get(loc.root) if ident and loc.off == 0 else None
        expr = reg[0] if reg is not None and reg[1] == loc.size else loc.value(idx)
        if bf16:
            return cexpr.operand(expr, loc.dtype, dtype)
        return expr if loc.dtype == dtype else f"(({ctype(dtype)}){expr})"

    def _commit(self, reads=(), writes=()):
        """Record the arena slots one emitted loop reads and writes."""
        def slots(vs):
            return {self.get(v).root for v in vs} & self.slots.keys()

        self.events.append((slots(reads), slots(writes)))

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

    def _barrier(self, line="__syncthreads();", label="barrier"):
        self.body.append(line)
        self.n_barriers += 1
        self.dirty.clear()
        self.events.append(None)
        self._stamp("barrier", label)

    def reads(self, pairs):
        """Emit a barrier unless every (var, pattern) read is safe."""
        if not all(self._safe(v, p) for v, p in pairs):
            self._barrier()

    def wrote(self, v, writer):
        self.dirty[self.get(v).root] = writer

    def _stamp(self, cls, desc):
        if self.stamps:
            self.body.append(f"K2_STAMP({len(self.stamp_labels)});")
            self.stamp_labels.append((cls, desc))

    # --- emission ----------------------------------------------------------------
    def _emit(self):
        op, info = self.op, self.info
        self.decl: list[str] = []
        self.body: list[str] = []
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
        live = self._schedule(live)

        self.args = []  # (field, ctype, const) in launch order

        def arg(field, dtype, const):
            self.args.append((field, ctype(dtype), const))
            return f"a.{field}"

        seq_args = [arg(f"seq{k}", v.type.dtype, True) for k, v in enumerate(self.seq_vars)]
        init_args = [arg(f"init{k}", v.type.dtype, True)
                     for k, v in enumerate(self.state_vars + self.unt_vars)]
        for j, v in enumerate(self.nonseq_vars):
            arg(f"ns{j}", v.type.dtype, True)
        trace_args = [arg(f"trace{k}", v.type.dtype, False) for k, v in enumerate(self.state_outs)]
        final_args = [arg(f"final{u}", v.type.dtype, False) for u, v in enumerate(self.unt_outs)]
        nit_args = [arg(f"nit{j}", v.type.dtype, False) for j, v in enumerate(self.nit_outs)]

        carried = self.state_vars + self.unt_vars
        carried_outs = self.state_outs + self.unt_outs
        bufs = [self._slot(f"st{k}_buf", v.type.dtype, 2 * _size(v.type.shape), pinned=True)
                for k, v in enumerate(carried)]
        for j, v in enumerate(self.nonseq_vars):
            self.loc[v] = _Loc(f"ns{j}", 0, v.type.dtype, v.type.shape)
        for k, v in enumerate(self.seq_vars):
            self.loc[v] = _Loc(f"q{k}", 0, v.type.dtype, v.type.shape)
        for k, v in enumerate(carried):
            self.loc[v] = _Loc(f"st{k}", 0, v.type.dtype, v.type.shape)

        # who reads each value, through any view of it
        for pos, en in enumerate(live):
            off = self._view_offset(en)
            if off is not None:
                root, o = self._root(en.inputs[0])
                self.root_of[en.outputs[0]] = (root, o + off)
                continue
            port = _SHAPE_ONLY.get(type(en.op))
            for k, i in enumerate(en.inputs):
                if port is None or not port(k):
                    self.consumers.setdefault(self._root(i)[0], []).append(
                        (pos, self.alias.get(i, i)))
        for out in carried_outs + self.nit_outs:
            self.consumers.setdefault(self._root(out)[0], []).append(("end", out))

        pre = []
        for k, v in enumerate(carried):
            n = _size(v.type.shape)
            pre.append(f"for (int i = tid; i < {n}; i += K2_THREADS) "
                       f"{bufs[k]}[i] = {init_args[k]}[i];")
        self.pre = pre
        for pos, en in enumerate(live):
            self._emit_node(pos, en)
        self._close_run()
        self._flush_reductions()

        # end of step: the new carried values and the trace rows
        self.reads([(out, "ident" if _size(out.type.shape) > 1 else "t0")
                    for out in carried_outs + self.nit_outs])
        for k, out in enumerate(carried_outs):
            n = _size(out.type.shape)
            dt = carried[k].type.dtype
            val = self.operand(out, "i", dt)
            x = store("x", dt)
            line = f"for (int i = tid; i < {n}; i += K2_THREADS) {{ const {rtype(dt)} x = {val}; st{k}_nx[i] = {x};"
            if k < info.n_states:
                line += f" {trace_args[k]}[t * {n} + i] = {x};"
            self.body.append(line + " }")
        for j, out in enumerate(self.nit_outs):
            n = _size(out.type.shape)
            val = store(self.operand(out, "i", out.type.dtype), out.type.dtype)
            self.body.append(f"for (int i = tid; i < {n}; i += K2_THREADS) "
                             f"{nit_args[j]}[t * {n} + i] = {val};")
        self._commit(reads=carried_outs + self.nit_outs)
        self._stamp("end_of_step", "end-of-step writes")
        self._barrier(label="end-of-step barrier")
        step_body = self.body

        offs = self._allocate()
        self._place()
        for name, (ct, _) in self.slots.items():
            if name in offs:
                self.decl.append(f"{ct}* {name} = ({ct}*)(k2_arena + {offs[name]});")
        for j, v in enumerate(self.nonseq_vars):
            ct = ctype(v.type.dtype)
            at = (f"(const {ct}*)(k2_smem + {self.smem_ns[j]})" if j in self.smem_ns
                  else f"a.ns{j}")
            self.decl.append(f"const {ct}* ns{j} = {at};")
        for name, ct, _, where, off in self.const_layout:
            base = "k2_cs" if where == "shared" else "a.consts"
            self.decl.append(f"const {ct}* {name} = (const {ct}*)({base} + {off});")

        # the prelude, and the expression table's helpers the body calls
        # that it lacks
        prelude = _PRELUDE + helpers("\n".join(step_body), have=("k2_max", "k2_ipow"))
        lines = [prelude, "namespace {", "", "struct K2Args {"]
        for field, ct, const in self.args:
            lines.append(f"  {'const ' if const else ''}{ct}* {field};")
        lines += ["  unsigned char* scratch;", "  const unsigned char* consts;",
                  *(["  long long* stamps;"] if self.stamps else []),
                  "  long long T;", "};", ""]
        if self.stamps:
            lines += [f"#define K2_STAMP(k) if (tid == 0 && t >= {STAMP_FROM} && "
                      f"t < {STAMP_FROM + STAMP_STEPS}) a.stamps[(t - {STAMP_FROM}) * "
                      f"{len(self.stamp_labels)} + (k)] = clock64()", ""]
        arena_at = f"k2_smem + {_RED_BYTES}" if self.placement == "shared" else "a.scratch"
        lines += [f"#define K2_SMEM {self.smem_bytes}", "",
                  "__global__ void __launch_bounds__(K2_THREADS) k2_kernel(K2Args a) {",
                  "  K2_SHARED_ARENA;",
                  "  unsigned long long (*k2_red)[32] = (unsigned long long (*)[32])k2_smem;",
                  f"  unsigned char* k2_arena = {arena_at};",
                  f"  unsigned char* k2_cs = k2_smem + {self.smem_const_at};",
                  "  const int tid = threadIdx.x;"]
        lines += ["  " + d for d in self.decl]
        for j, off in self.smem_ns.items():
            v = self.nonseq_vars[j]
            ct = ctype(v.type.dtype)
            lines.append(f"  for (int i = tid; i < {_size(v.type.shape)}; i += K2_THREADS) "
                         f"(({ct}*)(k2_smem + {off}))[i] = a.ns{j}[i];")
        if self.smem_const_bytes:
            lines.append(f"  for (int i = tid; i < {self.smem_const_bytes // 4}; i += K2_THREADS) "
                         "((unsigned int*)k2_cs)[i] = ((const unsigned int*)a.consts)[i];")
        lines += ["  " + p for p in self.pre]
        lines += ["  __syncthreads();", "  for (long long t = 0; t < a.T; ++t) {"]
        for k, v in enumerate(carried):
            n = _size(v.type.shape)
            ct = ctype(v.type.dtype)
            lines.append(f"    {ct}* st{k} = {bufs[k]} + (t & 1) * {n};")
            lines.append(f"    {ct}* st{k}_nx = {bufs[k]} + ((t + 1) & 1) * {n};")
        for k, v in enumerate(self.seq_vars):
            n = _size(v.type.shape)
            lines.append(f"    const {ctype(v.type.dtype)}* q{k} = {seq_args[k]} + t * {n};")
        if self.stamps:
            lines.append("    K2_STAMP(0);")
        lines += ["    " + b for b in step_body]
        lines.append("  }")
        for u, v in enumerate(self.unt_vars):
            k = info.n_states + u
            n = _size(v.type.shape)
            lines.append(f"  for (int i = tid; i < {n}; i += K2_THREADS) "
                         f"{final_args[u]}[i] = {bufs[k]}[(a.T & 1) * {n} + i];")
        lines += ["}", "", "}  // namespace", "",
                  "// Launches one block on `stream`; returns the first CUDA error.",
                  'extern "C" int k2_launch(const unsigned long long* p, long long T, '
                  "void* stream) {",
                  "  K2Args a;"]
        for pos, (field, ct, const) in enumerate(self.args):
            lines.append(f"  a.{field} = ({'const ' if const else ''}{ct}*)p[{pos}];")
        n = len(self.args)
        lines += [f"  a.scratch = (unsigned char*)p[{n}];",
                  f"  a.consts = (const unsigned char*)p[{n + 1}];",
                  *([f"  a.stamps = (long long*)p[{n + 2}];"] if self.stamps else []),
                  "  a.T = T;",
                  "  const cudaError_t e = cudaFuncSetAttribute(",
                  "      k2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, K2_SMEM);",
                  "  if (e != cudaSuccess) { cudaGetLastError(); return (int)e; }",
                  "  k2_kernel<<<1, K2_THREADS, K2_SMEM, (cudaStream_t)stream>>>(a);",
                  "  return (int)cudaGetLastError();", "}", ""]
        return "\n".join(lines)

    def _allocate(self):
        """Offsets of the arena slots.  A slot is taken where it is first
        written and given back after its last reader, for use only past
        the next barrier (so no thread still reads it); pinned slots (the
        carried double buffers, shapes) keep theirs."""
        first, last = {}, {}
        for k, ev in enumerate(self.events):
            if ev is None:
                continue
            rd, wr = ev
            for s in wr:
                first.setdefault(s, k)
                last[s] = k
            for s in rd - set(self.pinned):
                if s not in first:
                    raise AssertionError(f"K2: slot {s} is read before it is written")
                last[s] = k
        offs, top = {}, 0
        for s in self.pinned:
            offs[s] = top
            top += self.slots[s][1]
        order = {s: j for j, s in enumerate(self.slots)}
        free, pending = [], []  # free: sorted (offset, bytes)
        for k, ev in enumerate(self.events):
            if ev is None:
                for s in pending:
                    free.append((offs[s], self.slots[s][1]))
                free.sort()
                merged = []
                for o, b in free:
                    if merged and merged[-1][0] + merged[-1][1] == o:
                        merged[-1] = (merged[-1][0], merged[-1][1] + b)
                    else:
                        merged.append((o, b))
                free, pending = merged, []
                continue
            rd, wr = ev
            for s in sorted(wr, key=order.get):
                if first[s] != k:
                    continue
                b = self.slots[s][1]
                hole = next((j for j, (_, fb) in enumerate(free) if fb >= b), None)
                if hole is None:
                    offs[s] = top
                    top += b
                else:
                    o, fb = free[hole]
                    offs[s] = o
                    free[hole:hole + 1] = [(o + b, fb - b)] if fb > b else []
            pending += [s for s in sorted(rd | wr, key=order.get)
                        if s not in self.pinned and last[s] == k]
        self.arena = top
        return offs

    def _place(self):
        """Shared or device memory for the arena, then the constants, in
        the order they were made, and the non-sequences into shared memory
        while they fit."""
        used = _RED_BYTES
        if used + self.arena <= SMEM_LIMIT:
            self.placement = "shared"
            used += self.arena
        else:
            self.placement = "device"
        self.smem_const_at = used
        shared, device = [], []
        for name, ct, raw in self.consts:
            if used + len(raw) <= SMEM_LIMIT:
                shared.append((name, ct, raw))
                used += len(raw)
            else:
                device.append((name, ct, raw))
        # then the non-sequences, which no step changes
        self.smem_ns = {}
        for j, v in enumerate(self.nonseq_vars):
            b = _align(max(_size(v.type.shape), 1) * np_dtype(v.type.dtype).itemsize)
            if used + b <= SMEM_LIMIT:
                self.smem_ns[j] = used
                used += b
        self.smem_bytes = used
        self.smem_const_bytes = sum(len(r) for _, _, r in shared)
        self.const_layout, off = [], 0
        for name, ct, raw in shared + device:
            where = "shared" if off < self.smem_const_bytes else "device"
            self.const_layout.append((name, ct, raw, where, off))
            off += len(raw)
        self.const_bytes = b"".join(r for _, _, r in shared + device) or b"\0" * 16

    # --- one node -------------------------------------------------------------------
    def _new_slot(self, v, pinned=False):
        name = self._slot(f"v{len(self.loc)}", v.type.dtype, _size(v.type.shape), pinned)
        self.loc[v] = _Loc(name, 0, v.type.dtype, v.type.shape)
        return self.loc[v]

    def _alias(self, out, src, off=0):
        """``out`` is a view of ``src``'s elements from ``off`` on."""
        s = self.get(src)
        self.loc[out] = _Loc(s.root, s.off + off, s.dtype, out.type.shape, s.const)

    def _view_offset(self, en):
        """The offset of a node that only views its input, else None:
        ``Reshape``, ``SpecifyShape``, a ``DimShuffle`` that keeps the
        order, a ``Subtensor`` that keeps the row-major order."""
        op = en.op
        if isinstance(op, (Reshape, SpecifyShape, DeepCopyOp, ViewOp)) or (
                isinstance(op, DimShuffle) and list(op.shuffle) == sorted(op.shuffle)):
            return 0
        if isinstance(op, Subtensor):
            base, dims = self._index_map(op.idx_list, en.inputs[0].type.shape)
            shape = [n for n, _ in dims]
            if ([s for n, s in dims if n > 1]
                    == [s for n, s in zip(shape, _row_major(shape)) if n > 1]):
                return base
        return None

    _MAP_OPS = (Elemwise, IncSubtensor, Alloc, Subtensor, DimShuffle, Join, ARange)

    def _schedule(self, live):
        """The live nodes in an order that keeps element-wise ops of one
        size together, so that runs are long and barriers few: next comes
        a ready node that emits nothing (a view, a shape), else one that
        can extend the current run, else a loop of its own (ready
        reductions then share a barrier), else a one-hot product (its run
        opens with a barrier in any case), else the first ready node, each
        in the graph's order and, but for views, shapes and the last
        resort, not one that reads a reduction still waiting for its
        barrier."""
        order = {en: k for k, en in enumerate(live)}
        made = {o: en for en in live for o in en.outputs}

        def value_inputs(en):
            port = _SHAPE_ONLY.get(type(en.op))
            return [(k, self.alias.get(i, i)) for k, i in enumerate(en.inputs)
                    if port is None or not port(k)]

        deps = {en: {made[i] for _, i in value_inputs(en) if i in made} for en in live}
        users: dict = {en: [] for en in live}
        for en in live:
            for d in deps[en]:
                users[d].append(en)
        waiting = {en: len(deps[en]) for en in live}
        ready = [en for en in live if not waiting[en]]
        out, run_n, run_vars = [], None, set()

        def free(en):
            return isinstance(en.op, (Shape, Shape_i)) or self._view_offset(en) is not None

        def maps(en):
            if isinstance(en.op, Dot):
                plan = self._onehot(en)
                return plan is not None and not plan.by_warp
            return isinstance(en.op, self._MAP_OPS)

        def extends(en):
            o = en.outputs[0]
            if (run_n is None or isinstance(en.op, Dot) or not maps(en)
                    or _size(o.type.shape) != run_n):
                return False
            for k, i in value_inputs(en):
                if i in run_vars and not (
                        (isinstance(en.op, Elemwise) and (i.type.shape == o.type.shape
                                                          or run_n == 1))
                        or (isinstance(en.op, (IncSubtensor, Alloc)) and k == 0
                            and i.type.shape == o.type.shape)):
                    return False
            return True

        queued = set()  # reductions that will share a barrier, as _queue_reduction does

        def waits(en):
            return not any(i in queued for _, i in value_inputs(en))

        def reduces(en):
            return (isinstance(en.op, CAReduce) and _size(en.outputs[0].type.shape) == 1
                    and _size(en.inputs[0].type.shape) > 1)

        while ready:
            pick = (next((en for en in ready if free(en)), None)
                    or next((en for en in ready if extends(en) and waits(en)), None)
                    or next((en for en in ready if not maps(en) and waits(en)), None)
                    or next((en for en in ready if isinstance(en.op, Dot) and waits(en)), None)
                    or next((en for en in ready if waits(en)), None) or ready[0])
            ready.remove(pick)
            out.append(pick)
            o = pick.outputs[0]
            if reduces(pick):
                queued = set() if len(queued) == _RED_BATCH - 1 else queued | {o}
            elif not waits(pick) or isinstance(pick.op, Dot):
                queued = set()
            if free(pick):
                i = self.alias.get(pick.inputs[0], pick.inputs[0])
                if self._view_offset(pick) == 0 and i in run_vars:
                    run_vars.add(o)
            elif extends(pick):
                run_vars.add(o)
            elif maps(pick):
                run_n, run_vars = _size(o.type.shape), {o}
            else:
                run_n, run_vars = None, set()
            for u in users[pick]:
                waiting[u] -= 1
                if not waiting[u]:
                    ready.append(u)
            ready.sort(key=order.get)
        return out

    def _emit_node(self, pos, en):
        """Views alias their input and Shape values are written before the
        loop; element-wise ops join the open run; a reduction, a Dot that
        is not one-hot or a MakeVector is a loop of its own."""
        op = en.op
        out = en.outputs[0]
        off = self._view_offset(en)
        if off is not None:
            return self._alias(out, en.inputs[0], off)
        if isinstance(op, (Shape, Shape_i)):
            shp = en.inputs[0].type.shape
            loc = self._new_slot(out, pinned=True)
            for j, s in enumerate(shp if isinstance(op, Shape) else [shp[op.i]]):
                self.pre.append(f"if (tid == 0) {loc.at(j)} = {int(s)}LL;")
            return None
        plan = self._onehot(en) if isinstance(op, Dot) else None
        if plan is not None and not plan.by_warp:
            return self._add(self._onehot_unit(pos, en, plan))
        unit = {Elemwise: self._elemwise, Subtensor: self._strided_copy,
                DimShuffle: self._strided_copy, IncSubtensor: self._inc_subtensor,
                Alloc: self._alloc, Join: self._join, ARange: self._arange}.get(type(op))
        if unit is not None:
            return self._add(unit(pos, en))
        self._close_run()
        if isinstance(op, CAReduce) and self._queue_reduction(en):
            return None
        self._flush_for(en.inputs)
        if plan is not None:
            self._segsum_by_warp(en, plan)
        else:
            {CAReduce: self._careduce, Dot: self._dot, Gemm: self._gemm,
             Dot22Scalar: self._dot22scalar, MakeVector: self._make_vector}[type(op)](en)
        self.n_ops += 1
        self.n_units += 1
        self._stamp("onehot_dot" if plan is not None else "careduce" if isinstance(op, CAReduce)
                    else "dot" if isinstance(op, (Dot, Gemm, Dot22Scalar)) else "copy",
                    f"{op} -> {tuple(out.type.shape)}")
        return None

    # --- runs ----------------------------------------------------------------------
    def _add(self, unit):
        """Append ``unit`` to the open run, or close it and open another:
        a unit joins when it has the run's size and reads the run's own
        values only at its own element.  A one-hot product opens a run,
        whose leading ``__syncthreads_or`` is also the barrier it needs."""
        self._flush_for(v for v, _ in unit.reads)
        self.n_units += 1
        run = self.run
        joins = run is not None and run.n == unit.n and unit.guard is None
        for v, mode in unit.reads if joins else ():
            root, off = self._root(v)
            if root in run.outs and not (mode == "reg" and off == 0
                                         and _size(v.type.shape) == unit.n):
                joins = False
        if not joins:
            self._close_run()
            self.run = run = _Run(unit.n)
        run.units.append(unit)
        run.outs.add(unit.out)

    def _needs_slot(self, var, members, n):
        """Does a value of the run reach a reader outside it?"""
        for pos, read in self.consumers.get(var, ()):
            if pos == "end" or pos not in members:
                return True
            _, off = self._root(read)
            if off or _size(read.type.shape) != n:
                return True
        return False

    def _close_run(self):
        """Emit the open run: its barrier (or the ``__syncthreads_or`` of a
        one-hot operand), then one loop over its size in which each unit
        leaves its element in a register, stored only where read outside."""
        run, self.run = self.run, None
        if run is None:
            return
        n = run.n
        members = {u.pos for u in run.units}
        stores = {u.out for u in run.units if self._needs_slot(u.out, members, n)}
        guard = run.units[0].guard
        flag = self._flush_reductions(guard=guard) if guard is not None else None
        thread = self._scalar_threads(run) if n == 1 else {}
        # the runs' reads of other values: a scalar chain off thread 0
        # reads as any other thread does
        ext = [(v, "gen" if thread.get(u) or (n > 1 and mode == "gen")
                else "t0" if n == 1 else "ident")
               for u in run.units for v, mode in u.reads if self._root(v)[0] not in run.outs]
        self.reads(ext)
        groups: dict = {}
        for k, u in enumerate(run.units):
            r = f"r{k}"
            rt = rtype(u.out.type.dtype)
            lines = groups.setdefault(thread.get(u, 0), [])
            lines += [f"{rt} {r};", "{"] + ["  " + s for s in u.code(r, k, flag)] + ["}"]
            loc = self.get(u.out)
            if u.out in stores:
                lines.append(f"{loc.at('i')} = {store(r, u.out.type.dtype)};")
            self.regs[loc.root] = (r, n)
        self.regs = {}
        for t, lines in groups.items():
            head = (f"for (int i = tid; i < {n}; i += K2_THREADS) {{" if n > 1
                    else f"if (tid == {t}) {{ const int i = 0;")
            self.body += [head] + ["  " + s for s in lines] + ["}"]
        self._commit(reads=[v for v, _ in ext], writes=stores)
        for u in run.units:
            if u.out in stores:
                self.wrote(u.out, _Writer.STD if n > 1 else
                           _Writer.T0 if not thread.get(u, 0) else _Writer.OTHER)
        self.n_ops += 1
        names = "+".join(str(u.out.owner.op if u.out.owner else "?").split("{")[0]
                         for u in run.units[:6])
        more = f"+{len(run.units) - 6} more" if len(run.units) > 6 else ""
        self._stamp(run.units[0].cls, f"run of {len(run.units)} ({names}{more}) -> {n}")

    def _scalar_threads(self, run):
        """The thread of each unit of a scalar run.  Units that read each
        other's values form a chain; a chain that reads a value only
        thread 0 may read yet (written since the last barrier, when the run
        needs no barrier anyway) stays on thread 0, the others go to lane 0
        of warps 1, 2, ... in turn, so that independent chains of ``powf``
        and ``expf`` run side by side.  Their stores are then read after a
        barrier."""
        comp = {u.out: u.out for u in run.units}

        def find(v):
            while comp[v] is not v:
                v = comp[v]
            return v

        for u in run.units:
            for v, _ in u.reads:
                root = self._root(v)[0]
                if root in comp:
                    comp[find(u.out)] = find(root)
        chains: dict = {}
        for u in run.units:
            chains.setdefault(find(u.out), []).append(u)
        ext = [v for u in run.units for v, _ in u.reads if self._root(v)[0] not in run.outs]
        # a barrier that thread 0 needs anyway frees every chain
        anyway = not all(self._safe(v, "t0") for v in ext)
        thread, spare = {}, 0
        for units in chains.values():
            pinned = not anyway and any(
                not self._safe(v, "gen") for u in units for v, _ in u.reads
                if self._root(v)[0] not in run.outs)
            t = 0
            if not pinned:
                t = 32 * (1 + spare % (WARPS - 1))
                spare += 1
            for u in units:
                thread[u] = t
        return thread

    # --- element-wise units -------------------------------------------------------
    def _elemwise(self, pos, en):
        out_v = en.outputs[0]
        self._new_slot(out_v)
        shape = tuple(out_v.type.shape)
        n = _size(shape)
        name = en.op.scalar_op.name
        out_dt = out_v.type.dtype
        comp = en.op.scalar_op.compute_dtypes([i.type.dtype for i in en.inputs], out_dt)
        ins = [(i, dt, self.get(i)) for i, dt in zip(en.inputs, comp)]

        def ident(loc):
            return loc.shape == shape or (n == 1 and loc.size == 1)

        def code(r, u, flag):
            lines = _unravel(shape, "i", f"o{u}_") if n > 1 else []
            args = []
            for i, dt, loc in ins:
                if loc.const is not None or loc.size == 1:
                    idx = "0"
                elif ident(loc):
                    idx = "i"
                else:
                    idx = _offset(_bcast_strides(loc.shape, shape), f"o{u}_")
                args.append(self.operand(i, idx, dt, ident=ident(loc)))
            if name.startswith("cast{"):
                expr = f"({args[0]} != 0)" if out_dt == "bool" else args[0]
                if "bfloat16" in (comp[0], out_dt):
                    return lines + [f"{r} = {cexpr.operand(f'({expr})', comp[0], out_dt)};"]
            elif "bfloat16" in comp:
                return lines + [f"{r} = {expression(name, args, comp, out_dt)};"]
            else:
                expr = CEXPR[name](args, comp[0])
            return lines + [f"{r} = ({ctype(out_dt)})({expr});"]

        reads = [(i, "reg" if ident(loc) else "gen") for i, _, loc in ins if loc.const is None]
        return _Unit(pos, out_v, reads, code, "elemwise_0d" if n == 1 else "elemwise_vec")

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

    def _strided_copy(self, pos, en):
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

        def code(r, u, flag):
            lines = _unravel(out.shape, "i", f"o{u}_")
            idx = f"{base} + {_offset(strides, f'o{u}_')}"
            return lines + [f"{r} = {self.operand(x, idx, xl.dtype)};"]

        return _Unit(pos, out_v, [(x, "gen")], code, "copy")

    def _join(self, pos, en):
        """Concatenation as index arithmetic: element ``i`` of the output
        reads the input whose segment of the axis holds it."""
        axis, *xs = en.inputs
        out_v = en.outputs[0]
        out = self._new_slot(out_v)
        shape = out.shape
        a = int(np.asarray(axis.data)) % len(shape)
        dt = out_v.type.dtype

        def code(r, u, flag):
            o = f"o{u}_"
            lines = _unravel(shape, "i", o)
            start, branches = 0, []
            for k, x in enumerate(xs):
                n = x.type.shape[a]
                st = _row_major(x.type.shape)
                idx = " + ".join([f"({o}{a} - {start}) * {st[a]}" if st[a] else "0"]
                                 + [f"{o}{d} * {st[d]}" for d in range(len(shape))
                                    if d != a and st[d]])
                cond = "" if k == len(xs) - 1 else f"if ({o}{a} < {start + n}) "
                branches.append(f"{'else ' if k else ''}{cond}{r} = "
                                f"{self.operand(x, idx, dt)};")
                start += n
            return lines + branches

        return _Unit(pos, out_v, [(x, "gen") for x in xs], code, "copy")

    def _arange(self, pos, en):
        """numpy's arange as index arithmetic: ``first + i * delta`` in the
        output dtype, delta the difference of the first two values, as
        numpy's fill computes it."""
        out_v = en.outputs[0]
        self._new_slot(out_v)
        dt = out_v.type.dtype
        vals = np.arange(*(np.asarray(i.data) for i in en.inputs), dtype=dt)
        first = literal(vals[0] if vals.size else 0, dt)
        delta = literal(vals[1] - vals[0] if vals.size > 1 else 0, dt)

        def code(r, u, flag):
            return [f"{r} = ({ctype(dt)})({first} + ({ctype(dt)})i * {delta});"]

        return _Unit(pos, out_v, [], code, "copy")

    def _inc_subtensor(self, pos, en):
        x, y = en.inputs[:2]
        out_v = en.outputs[0]
        out = self._new_slot(out_v)
        shape = out.shape
        yl = self.get(y)
        out_dt = out_v.type.dtype

        def code(r, u, flag):
            o = f"o{u}_"
            conds, region = [], []  # region: (length, C++ index) per non-int entry
            d = 0
            for e in en.op.idx_list:
                if isinstance(e, (int, np.integer)):
                    conds.append(f"{o}{d} == {int(e) % shape[d]}")
                else:
                    _, a, b, c = e
                    start, stop, step = slice(a, b, c).indices(shape[d])
                    n = len(range(start, stop, step))
                    if step > 0:
                        conds.append(f"{o}{d} >= {start} && {o}{d} < {stop}")
                    else:
                        conds.append(f"{o}{d} <= {start} && {o}{d} > {stop}")
                    if step not in (1, -1):
                        conds.append(f"({o}{d} - {start}) % {step} == 0")
                    region.append((n, f"({o}{d} - {start}) / {step}" if step != 1
                                   else f"({o}{d} - {start})"))
                d += 1
            region += [(shape[k], f"{o}{k}") for k in range(d, len(shape))]
            ystr = _bcast_strides(yl.shape, [n for n, _ in region])
            yidx = " + ".join(f"({ri}) * {s}" for (_, ri), s in zip(region, ystr) if s) or "0"
            lines = _unravel(shape, "i", o)
            lines.append(f"{r} = {self.operand(x, 'i', out_dt, ident=True)};")
            yv = self.operand(y, yidx, out_dt)
            total = f"{r} + {yv}" if out_dt != "bfloat16" else f"k2_rbf({r} + {yv})"
            upd = f"{r} = {yv};" if en.op.set_instead_of_inc else f"{r} = {total};"
            lines.append(f"if ({' && '.join(conds) or 'true'}) {upd}")
            return lines

        # y's element i is read at element i of a leading slice from 0
        lead = (len(en.op.idx_list) == 1 and not isinstance(en.op.idx_list[0], (int, np.integer))
                and slice(*en.op.idx_list[0][1:]).indices(shape[0])[::2] == (0, 1)
                and yl.shape == (yl.shape[0], *shape[1:]))
        return _Unit(pos, out_v, [(x, "reg"), (y, "ident" if lead else "gen")], code, "copy")

    def _alloc(self, pos, en):
        value, out_v = en.inputs[0], en.outputs[0]
        out = self._new_slot(out_v)
        vl = self.get(value)
        ident = vl.shape == out.shape

        def code(r, u, flag):
            lines = _unravel(out.shape, "i", f"o{u}_")
            idx = (_offset(_bcast_strides(vl.shape, out.shape), f"o{u}_")
                   if vl.size > 1 else "0")
            return lines + [f"{r} = {self.operand(value, idx, out_v.type.dtype, ident=ident)};"]

        return _Unit(pos, out_v, [(value, "reg" if ident else "gen")], code, "copy")

    # --- one-hot products ------------------------------------------------------------
    def _onehot(self, en):
        """The plan of a Dot one of whose operands is a 2-D constant whose
        rows (or columns) each hold one 1 and zeros, else None.  ``kind``
        is "gather" when each output element reads one element of the
        other operand ``v``, "segsum" when it sums a segment of them;
        ``idx`` maps each output element (gather) or each operand element
        (segsum) to its partner; ``P`` is the constant's free length, ``C``
        the contracted one, ``B`` the other free length of ``v``.
        ``by_warp``: ``_dot`` would give each output element a warp."""
        x, y = (self.alias.get(v, v) for v in en.inputs)
        for side, m, v in (("left", x, y), ("right", y, x)):
            if not isinstance(m, Constant) or m.type.ndim != 2 or isinstance(v, Constant):
                continue
            d = np.asarray(m.data)
            ones = d == 1
            if not np.all(ones | (d == 0)):
                continue
            rows = bool(np.all(ones.sum(axis=1) == 1))
            cols = bool(np.all(ones.sum(axis=0) == 1))
            if (rows if side == "left" else cols):
                kind, idx = "gather", ones.argmax(axis=1 if side == "left" else 0)
            elif (cols if side == "left" else rows):
                kind, idx = "segsum", ones.argmax(axis=0 if side == "left" else 1)
            else:
                continue
            P, C = d.shape if side == "left" else d.shape[::-1]
            O = _size(en.outputs[0].type.shape)
            by_warp = kind == "segsum" and not (
                O == 1 or math.ceil(O / THREADS) * C
                <= math.ceil(O / WARPS) * math.ceil(C / 32) + 5)
            return _OneHot(kind, side, m, v, idx, P, C, _size(v.type.shape) // C, by_warp)
        return None

    def _onehot_tables(self, plan):
        """The index tables of a one-hot constant (each made once, as equal
        tables are): ``idx``, and for a segment sum the CSR of the segments
        (``ptr``, and ``rows`` in ascending order within each, or for a
        warp's sum by lane first, with ``lanes``)."""
        tables = {"idx": self._table(_small_index(plan.idx))}
        if plan.kind == "segsum":
            counts = np.bincount(plan.idx, minlength=plan.P)
            c = np.arange(len(plan.idx))
            if plan.by_warp:
                # within a segment, by lane (c % 32), then ascending;
                # lanes[32 p + l]: where lane l's elements start in it
                order = np.lexsort((c, c % 32, plan.idx))
                lane_of = (c % 32)[order]
                starts = np.concatenate([[0], np.cumsum(counts)])
                lanes = np.stack([np.searchsorted(lane_of[starts[p]:starts[p + 1]],
                                                  np.arange(32)) for p in range(plan.P)])
                tables["lanes"] = self._table(lanes.astype("uint8") if counts.max(initial=0) < 256
                                              else _small_index(lanes))
            else:
                order = np.argsort(plan.idx, kind="stable")
            tables["rows"] = self._table(_small_index(order))
            tables["ptr"] = self._table(_small_index(np.concatenate([[0], np.cumsum(counts)])))
        return tables

    @staticmethod
    def _onehot_elem(plan, c, b):
        """C++ index of the operand's element (c, b)."""
        if plan.B == 1:
            return c
        return f"({c}) * {plan.B} + {b}" if plan.side == "left" else f"{b} * {plan.C} + ({c})"

    def _onehot_nan(self, plan, tab, flag, r, p, b, ct):
        """The line that makes ``r`` NaN where the operand holds an inf or
        a NaN outside element p's segment, as ``0 * inf`` does in the
        product (only when the run's flag says there is one)."""
        outside = (f"c != (int){tab['idx']}[{p}]" if plan.kind == "gather"
                   else f"(int){tab['idx']}[c] != {p}")
        return (f"if ({flag}) for (int c = 0; c < {plan.C}; ++c) if ({outside} && "
                f"!isfinite({self.get(plan.v).value(self._onehot_elem(plan, 'c', b))})) "
                f"{r} = ({ct})NAN;")

    def _onehot_unit(self, pos, en, plan):
        """A one-hot product as index loads, one thread an element.
        ``gather``: element p reads ``v[idx[p]]``; ``segsum``: element p
        sums, in ascending c, the operand elements c with ``idx[c] == p``,
        as ``_dot``'s one thread an element sums the whole product.  The
        terms that the one-hot matrix zeroes add +0 to a sum that is never
        -0, so this is the product's value bit for bit.  Both start from 0,
        as the product's sum does, so a -0.0 gives 0.0; where the operand
        holds an inf or a NaN outside an element's segment, the product's
        ``0 * inf`` makes it NaN, and so does the guard here."""
        out_v, v = en.outputs[0], plan.v
        self._new_slot(out_v)
        ct = rtype(out_v.type.dtype)
        tab = self._onehot_tables(plan)
        B, P = plan.B, plan.P
        p_of, b_of = ((f"i / {B}", f"i % {B}") if plan.side == "left"
                      else (f"i % {P}", f"i / {P}"))

        def code(r, u, flag):
            p, b = f"p{u}", f"b{u}"
            lines = [f"const int {p} = {p_of if B > 1 else 'i'};",
                     f"const int {b} = {b_of if B > 1 else '0'};"]
            if plan.kind == "gather":
                at = self._onehot_elem(plan, f"(int){tab['idx']}[{p}]", b)
                lines.append(f"{r} = ({ct})0 + {self.operand(v, at, out_v.type.dtype)};")
            else:
                at = self._onehot_elem(plan, f"(int){tab['rows']}[q]", b)
                lines += [f"{r} = ({ct})0;",
                          f"for (int q = {tab['ptr']}[{p}]; q < {tab['ptr']}[{p} + 1]; ++q) "
                          f"{r} = {r} + {self.operand(v, at, out_v.type.dtype)};"]
                if out_v.type.dtype == "bfloat16":
                    # the segment's sum in float, rounded once
                    lines.append(f"{r} = k2_rbf({r});")
            if flag is not None:
                lines.append(self._onehot_nan(plan, tab, flag, r, p, b, ct))
            return lines

        guard = v if dtype_kind(v.type.dtype) == "f" else None
        return _Unit(pos, out_v, [(v, "gen")], code, "onehot_dot", guard)

    def _segsum_by_warp(self, en, plan):
        """A one-hot segment sum where ``_dot`` would give each output
        element a warp: lane l sums, in ascending c, the segment's elements
        with c % 32 == l (from the ``lanes`` table), then the warp's shuffle
        tree; ``_dot``'s order, so the product's value bit for bit, with the
        guard of ``_onehot_unit``.  Lane 0 writes the element."""
        out_v, v = en.outputs[0], plan.v
        out = self._new_slot(out_v)
        ct = rtype(out_v.type.dtype)
        tab = self._onehot_tables(plan)
        flag = None
        if dtype_kind(v.type.dtype) == "f":
            flag = self._flush_reductions(guard=v)
        else:
            self.reads([(v, "gen")])
        B, P = plan.B, plan.P
        p, b = (("o / %d" % B, "o %% %d" % B) if plan.side == "left"
                else ("o %% %d" % P, "o / %d" % P)) if B > 1 else ("o", "0")
        at = self._onehot_elem(plan, "k", "b")
        # lane l reads only its own elements of the segment, from lanes[];
        # a warp's several elements are summed side by side
        rounds = math.ceil(out.size / WARPS)
        body = ["{", "  const int lane = tid & 31;", f"  {ct} acc[{rounds}];",
                "  #pragma unroll",
                f"  for (int r = 0; r < {rounds}; ++r) {{",
                f"    const int o = (tid >> 5) + r * {WARPS};",
                "    acc[r] = 0;",
                f"    if (o < {out.size}) {{",
                f"      const int p = {p}; const int b = {b};",
                f"      const int q0 = {tab['ptr']}[p], q1 = {tab['ptr']}[p + 1];",
                f"      const int qa = q0 + {tab['lanes']}[32 * p + lane];",
                f"      const int qb = lane < 31 ? q0 + {tab['lanes']}[32 * p + lane + 1] : q1;",
                f"      for (int q = qa; q < qb; ++q) {{ const int k = {tab['rows']}[q]; "
                f"acc[r] = acc[r] + {self.operand(v, at, out_v.type.dtype)}; }}",
                "    }", "  }",
                "  #pragma unroll",
                f"  for (int r = 0; r < {rounds}; ++r) {{",
                f"    const int o = (tid >> 5) + r * {WARPS};",
                f"    {ct} sum = k2_warp_add(acc[r]);",
                f"    if (lane == 0 && o < {out.size}) {{",
                f"      const int p = {p}; const int b = {b};"]
        if flag is not None:
            body.append("      " + self._onehot_nan(plan, tab, flag, "sum", "p", "b", ct))
        body += [f"      {out.at('o')} = {store('sum', out_v.type.dtype)};", "    }", "  }", "}"]
        self.body += body
        self._commit(reads=[v], writes=[out_v])
        self.wrote(out_v, _Writer.OTHER)

    # --- loops of their own ----------------------------------------------------------
    def _queue_reduction(self, en):
        """Queue a reduction of many elements to one, to share the barrier
        of the ready ones (at most _RED_BATCH); False for any other."""
        x, out_v = en.inputs[0], en.outputs[0]
        if _size(out_v.type.shape) != 1 or _size(x.type.shape) <= 1:
            return False
        self._new_slot(out_v)
        self.reds.append(en)
        self.n_units += 1
        if len(self.reds) == _RED_BATCH:
            self._flush_reductions()
        return True

    def _flush_for(self, reads):
        """Emit the queued reductions if one of ``reads`` is their output."""
        pending = {en.outputs[0] for en in self.reds}
        if any(self._root(v)[0] in pending for v in reads):
            self._flush_reductions()

    def _flush_reductions(self, guard=None):
        """The queued block reductions, each in its own fixed order (element
        j on thread j % K2_THREADS, warp shuffles, one warp over the 32
        partials), with one barrier for all of them.  With
        ``guard``, that barrier is a ``__syncthreads_or`` that also flags a
        non-finite element of ``guard`` (each thread reading its own);
        returns the flag's name."""
        reds, self.reds = self.reds, []
        if not reds and guard is None:
            return None
        ins = [en.inputs[0] for en in reds] + ([guard] if guard is not None else [])
        self.reads([(v, "ident") for v in ins])
        flag = None
        if guard is not None:
            flag = f"k2_bad{self.n_barriers}"
            self.body.append(f"int {flag} = 0;")
        base = _RED_BATCH * self.red_set
        self.red_set ^= 1
        head, tail = ["{"], ["  if (tid < 32) {"]
        for k, en in enumerate(reds):
            x, out_v = en.inputs[0], en.outputs[0]
            xl, out = self.get(x), self.get(out_v)
            acc_dt = en.op.acc_dtype or out_v.type.dtype
            acc = _acc_ctype(acc_dt)
            ident_of, combine, warp_fn = _REDUCE[en.op.scalar_op.name]
            red = f"(({acc}*)k2_red[{base + k}])"
            head += [f"  {acc} p{k} = {literal(ident_of(acc_dt), acc_dt)};",
                     f"  for (int j = tid; j < {xl.size}; j += K2_THREADS) "
                     f"p{k} = {combine(f'p{k}', f'({acc})' + xl.value('j'))};",
                     f"  p{k} = {warp_fn}(p{k});",
                     f"  if ((tid & 31) == 0) {red}[tid >> 5] = p{k};"]
            tail.append(f"    {{ {acc} q = {red}[tid]; q = {warp_fn}(q); "
                        f"if (tid == 0) {out.at(0)} = {_from_acc('q', out_v.type.dtype)}; }}")
        if guard is not None:
            gl = self.get(guard)
            head.append(f"  for (int j = tid; j < {gl.size}; j += K2_THREADS) "
                        f"{flag} |= !isfinite({gl.value('j')});")
        self.body += head
        self._commit(reads=ins)
        self._barrier(f"  {flag} = __syncthreads_or({flag});" if guard is not None
                      else "  __syncthreads();",
                      "block reduction barrier" if reds else "__syncthreads_or of a one-hot operand")
        if reds:
            self.body += tail + ["  }"]
        self.body.append("}")
        if reds:
            self._commit(writes=[en.outputs[0] for en in reds])
            for en in reds:
                self.wrote(en.outputs[0], _Writer.T0)
            self.n_ops += 1
            self._stamp("careduce", f"{len(reds)} block reductions -> ()")
        return flag

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
        ident = literal(ident_of(acc_dt), acc_dt)
        st = _row_major(shape)
        kept_shape = [shape[d] for d in kept]
        red_shape = [shape[d] for d in red]
        base = _offset([st[d] for d in kept], "k")
        roff = _offset([st[d] for d in red], "j")
        by_thread = math.ceil(O / THREADS) * R
        by_warp = math.ceil(O / WARPS) * math.ceil(R / 32) + 5
        if O == 1 or by_thread <= by_warp:
            self.reads([(x, "t0" if O == 1 else "gen")])
            lines = _unravel(kept_shape, "i", "k")
            lines.append(f"const int base = {base};")
            lines.append(f"{acc} acc = {ident};")
            loops = "".join(f"for (int j{k} = 0; j{k} < {n}; ++j{k}) "
                            for k, n in enumerate(red_shape))
            lines.append(f"{loops}acc = {combine('acc', f'({acc})' + xl.value('base + ' + roff))};")
            lines.append(f"{out.at('i')} = {_from_acc('acc', out_v.type.dtype)};")
            head = (f"for (int i = tid; i < {O}; i += K2_THREADS) {{" if O > 1
                    else "if (tid == 0) { const int i = 0;")
            self.body += [head] + ["  " + s for s in lines] + ["}"]
            self._commit(reads=[x], writes=[out_v])
            self.wrote(out_v, _Writer.STD if O > 1 else _Writer.T0)
            return
        self.reads([(x, "gen")])
        body = ["{", "  const int lane = tid & 31;",
                f"  for (int i = tid >> 5; i < {O}; i += {WARPS}) {{"]
        body += ["    " + s for s in _unravel(kept_shape, "i", "k")]
        body += [f"    const int base = {base};", f"    {acc} acc = {ident};",
                 f"    for (int jj = lane; jj < {R}; jj += 32) {{"]
        body += ["      " + s for s in _unravel(red_shape, "jj", "j")]
        body += [f"      acc = {combine('acc', f'({acc})' + xl.value('base + ' + roff))};", "    }",
                 f"    acc = {warp_fn}(acc);",
                 f"    if (lane == 0) {out.at('i')} = {_from_acc('acc', out_v.type.dtype)};",
                 "  }", "}"]
        self.body += body
        self._commit(reads=[x], writes=[out_v])
        self.wrote(out_v, _Writer.OTHER)

    def _gemm(self, en):
        """beta * z + alpha * dot(x, y): the product's FMA loop, then each
        multiply and the add rounded on its own, as the JAX package's
        expression is."""
        z, alpha, x, y, beta = en.inputs
        ct = rtype(en.outputs[0].type.dtype)
        dt = en.outputs[0].type.dtype
        self._dot(en, x, y, [z, alpha, beta], lambda acc, o: (
            f"({self.operand(beta, '0', dt)} * {self.operand(z, o, dt)} + "
            f"{self.operand(alpha, '0', dt)} * ({ct}){acc})"))

    def _dot22scalar(self, en):
        """alpha * dot(x, y)."""
        x, y, alpha = en.inputs
        dt = en.outputs[0].type.dtype
        # in bfloat16 the product rounds, then the scaling, as the step
        # loop's alpha * matmul(x, y)
        prod = "k2_rbf(acc)" if dt == "bfloat16" else "acc"
        self._dot(en, x, y, [alpha], lambda acc, o: f"({self.operand(alpha, '0', dt)} * {prod})")

    def _dot(self, en, x=None, y=None, extra=(), epilogue=None):
        """A product on the block's threads: one thread, or one warp, an
        output element, its multiply-adds as explicit FMAs in a fixed
        order; ``epilogue(acc, o)`` makes the value stored from the sum
        (Gemm and Dot22Scalar), reading ``extra`` too."""
        if x is None:
            x, y = en.inputs
        out_v = en.outputs[0]
        out = self._new_slot(out_v)
        xl, yl = self.get(x), self.get(y)
        K = xl.shape[-1]
        O = out.size
        # the accumulator: a bfloat16 product sums in float, rounded once
        ct = rtype(out_v.type.dtype)
        if len(xl.shape) == 2 and len(yl.shape) == 1:
            xb, yb, ys = f"o * {K}", "0", 1
        elif len(xl.shape) == 1 and len(yl.shape) == 2:
            xb, yb, ys = "0", "o", yl.shape[1]
        elif len(xl.shape) == 2:
            N = yl.shape[1]
            xb, yb, ys = f"(o / {N}) * {K}", f"(o % {N})", N
        else:
            xb, yb, ys = "0", "0", 1
        xk = f"({ct}){xl.value('xb + k')}"
        yk = f"({ct}){yl.value(f'yb + k * {ys}' if ys != 1 else 'yb + k')}"
        # one rounding per multiply-add: an explicit FMA, since K2 is built
        # with -fmad=false
        step = (f"acc = {'fmaf' if ct == 'float' else 'fma'}({xk}, {yk}, acc)"
                if ct in ("float", "double") else f"acc += {xk} * {yk}")
        self.reads([(v, "gen") for v in (x, y, *extra)])
        self._commit(reads=[x, y, *extra], writes=[out_v])

        def value(o):
            return store("acc" if epilogue is None else epilogue("acc", o), out_v.type.dtype)

        by_thread = math.ceil(O / THREADS) * K
        by_warp = math.ceil(O / WARPS) * math.ceil(K / 32) + 5
        if O == 1 or by_thread <= by_warp:
            self.body += [
                f"for (int o = tid; o < {O}; o += K2_THREADS) {{",
                f"  const int xb = {xb}; const int yb = {yb};",
                f"  {ct} acc = 0;",
                f"  for (int k = 0; k < {K}; ++k) {step};",
                f"  {out.at('o')} = {value('o')};",
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
            f"    for (int k = lane; k < {K}; k += 32) {step};",
            "    acc = k2_warp_add(acc);",
            f"    if (lane == 0) {out.at('o')} = {value('o')};",
            "  }",
            "}",
        ]
        self.wrote(out_v, _Writer.OTHER)

    def _make_vector(self, en):
        out_v = en.outputs[0]
        out = self._new_slot(out_v)
        self.reads([(i, "t0") for i in en.inputs])
        vals = [f"{out.at(j)} = {store(self.operand(i, '0', out_v.type.dtype), out_v.type.dtype)};"
                for j, i in enumerate(en.inputs)]
        self.body.append("if (tid == 0) { " + " ".join(vals) + " }")
        self._commit(reads=en.inputs, writes=[out_v])
        self.wrote(out_v, _Writer.T0)


# --- the wrapper ----------------------------------------------------------------------

class ScanKernel:
    """K2 for one Scan node on one device.

    ``__call__(n_steps, *outer)`` takes the Scan node's outer inputs after
    ``n_steps`` and returns its outputs.  On CPU tensors it runs the plain
    step loop; on CUDA tensors it launches the kernel, or raises.  With
    ``stamps`` (a measurement variant, never linked into a function) each
    launch leaves its clock64() stamps in ``stamp_buf``, shaped
    ``(STAMP_STEPS, len(src.stamp_labels))``.
    """

    def __init__(self, op, node, device, stamps=False):
        from pytensor_tpu_torch.link.torch.convert import resolve_device
        from pytensor_tpu_torch.link.torch.dispatch import scan_loop

        self.op, self.node = op, node
        self.device = resolve_device(device)
        self.src = ScanKernelSource(op, node, stamps=stamps)
        self.stamp_buf = None
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
            lib, self.build_log = build_library(self.source, "scan_k2", verbose=verbose,
                                                flags=K2_NVCC_FLAGS)
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
        # the arena lives in shared memory unless it did not fit there
        scratch = torch.empty(src.arena if src.placement == "device" else 16,
                              dtype=torch.uint8, device=self.device)
        ptrs = [t.data_ptr() for t in ins + outs] + [scratch.data_ptr(), self.consts.data_ptr()]
        if src.stamps:
            self.stamp_buf = torch.zeros((STAMP_STEPS, len(src.stamp_labels)), dtype=torch.int64,
                                         device=self.device)
            ptrs.append(self.stamp_buf.data_ptr())
        lib = self.build()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        err = lib.k2_launch((ctypes.c_ulonglong * len(ptrs))(*ptrs), T, stream)
        if err != 0:
            raise RuntimeError(f"K2 launch failed: CUDA error {err}")
        LAUNCHES += 1
        return outs

"""torch lowerings of the ops: the ``torch_funcify`` registry.

Counterpart of ``pytensor_tpu/link/xla/dispatch.py`` (``xla_funcify:27``
and the lowerings at ``:155-693``), of the Scan lowering at
``pytensor_tpu/scan/op.py:790`` and of the sparse lowerings at
``pytensor_tpu/sparse/basic.py:642-757`` and ``sparse/spmv.py:412``.
``torch_funcify(op, node=node, device=device)`` returns a function of
torch tensors.  Shape values (``Shape``, ``Shape_i`` and the arithmetic
on them) stay on the host, so a reshape never waits on the device.

Integer indices are checked explicitly: an out-of-range index on CUDA is
a device-side assert, and that poisons the whole CUDA context.  Constant
indices are checked when the graph is linked, where the axis length is
static, and against the runtime length otherwise; dynamic indices are
checked on each call (one device-to-host read).  The JAX path clamps and
the numpy oracle raises; the port raises.
"""

from __future__ import annotations

from functools import singledispatch

import numpy as np
import torch

from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.link.torch.convert import CSR, torch_dtype
from pytensor_tpu_torch.scan.op import Scan
from pytensor_tpu_torch.sparse.basic import StructuredDot, StructuredDotGrad, Transpose
from pytensor_tpu_torch.sparse.spmv import RoutedSpMV
from pytensor_tpu_torch.tensor.basic import Alloc, MakeVector
from pytensor_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise
from pytensor_tpu_torch.tensor.fused import FusedElemwise
from pytensor_tpu_torch.tensor.math import Dot
from pytensor_tpu_torch.tensor.shape import Reshape, Shape, Shape_i, SpecifyShape
from pytensor_tpu_torch.tensor.subtensor import (
    DYN,
    AdvancedIncSubtensor,
    AdvancedIncSubtensor1,
    AdvancedSubtensor,
    AdvancedSubtensor1,
    IncSubtensor,
    Subtensor,
)


@singledispatch
def torch_funcify(op, node=None, device=None, **kwargs):
    """Return a python callable computing ``op`` on torch tensors."""
    raise NotImplementedError(f"No torch lowering for {op} ({type(op).__name__})")


# --- elementwise --------------------------------------------------------------

def elemwise_fn(node):
    """torch implementation of one Elemwise node.

    Operands are cast to the node's output dtype before the op, which is
    numpy's rule of computing in the promoted dtype; torch's own promotion
    would let a 0-d float64 operand be computed at float32.
    """
    so = node.op.scalar_op
    so.check_inputs(*(i.type.dtype for i in node.inputs))
    fn = so.torch_fn
    if so.name == "second" or so.name.startswith("cast{"):
        return fn
    out_dtype = node.outputs[0].type.dtype
    if out_dtype == "bool":
        # comparisons compute in the operands' common dtype
        from pytensor_tpu_torch.scalar.basic import upcast

        out_dtype = upcast(*(i.type.dtype for i in node.inputs))
    out = torch_dtype(out_dtype)

    def elemwise(*args):
        return fn(*[a if a.dtype == out else a.to(out) for a in args])

    return elemwise


@torch_funcify.register(Elemwise)
def _elemwise(op, node=None, **kw):
    fn = elemwise_fn(node)

    def elemwise(*args):
        if len(args) > 1:
            Elemwise._check_runtime_broadcast(node, [tuple(a.shape) for a in args])
        return fn(*args)

    return elemwise


@torch_funcify.register(FusedElemwise)
def _fused(op, node=None, device=None, **kw):
    from pytensor_tpu_torch.tensor.fused_kernel import FusedElemwiseKernel

    return FusedElemwiseKernel(op.fgraph, device)


@torch_funcify.register(DimShuffle)
def _dimshuffle(op, node=None, **kw):
    transposition = op.transposition
    nshuffle = len(op.shuffle)
    augment = op.augment
    drop = op.drop

    def dimshuffle(x):
        for d in drop:
            if x.shape[d] != 1:
                raise ValueError(f"Cannot drop dim {d} of length {x.shape[d]} (!= 1)")
        res = x.permute(*transposition) if x.ndim else x
        shape = list(res.shape[:nshuffle])
        for a in augment:
            shape.insert(a, 1)
        return res.reshape(shape)

    return dimshuffle


@torch_funcify.register(CAReduce)
def _careduce(op, node=None, **kw):
    name = op.scalar_op.name
    if name not in ("add", "mul", "maximum"):
        raise NotImplementedError(f"torch lowering of {op}")
    axis = op.axis
    out = torch_dtype(node.outputs[0].type.dtype)
    acc = torch_dtype(op.acc_dtype) if op.acc_dtype is not None else out

    def careduce(x):
        dims = tuple(range(x.ndim)) if axis is None else tuple(axis)
        if not dims:
            return x.to(out).clone()
        if name == "add":
            r = torch.sum(x, dim=dims, dtype=acc)
        elif name == "maximum":
            # NaN propagates, as in numpy's maximum.reduce
            r = torch.amax(x, dim=dims)
        else:
            r = x.to(acc)
            for d in sorted(dims, reverse=True):
                r = torch.prod(r, dim=d)
        return r if r.dtype == out else r.to(out)

    return careduce


@torch_funcify.register(Dot)
def _dot(op, node=None, **kw):
    # full float32: a function linked for CUDA runs with TF32 off
    return torch.matmul


# --- shapes (host values) -----------------------------------------------------

@torch_funcify.register(Shape)
def _shape(op, node=None, **kw):
    def shape(x):
        return torch.tensor(tuple(x.shape), dtype=torch.int64)

    return shape


@torch_funcify.register(Shape_i)
def _shape_i(op, node=None, **kw):
    i = op.i

    def shape_i(x):
        return torch.tensor(x.shape[i], dtype=torch.int64)

    return shape_i


@torch_funcify.register(SpecifyShape)
def _specify_shape(op, node=None, **kw):
    def specify_shape(x, *shape):
        for d, s in enumerate(shape):
            if s is not None and x.shape[d] != int(s):
                raise AssertionError(
                    f"SpecifyShape: dim {d} is {x.shape[d]}, expected {int(s)}")
        return x

    return specify_shape


@torch_funcify.register(Reshape)
def _reshape(op, node=None, **kw):
    def reshape(x, shp):
        return x.reshape(tuple(int(s) for s in shp.tolist()))

    return reshape


@torch_funcify.register(MakeVector)
def _make_vector(op, node=None, **kw):
    dtype = torch_dtype(op.dtype)

    def make_vector(*scalars):
        dev = next((s.device for s in scalars if s.device.type != "cpu"), torch.device("cpu"))
        return torch.stack([s.to(device=dev, dtype=dtype) for s in scalars])

    return make_vector


@torch_funcify.register(Alloc)
def _alloc(op, node=None, **kw):
    def alloc(value, *shape):
        return torch.broadcast_to(value, tuple(int(s) for s in shape))

    return alloc


# --- indexing -----------------------------------------------------------------

def _basic_index(idx_list, dyn):
    it = iter(dyn)
    idx = []
    for e in idx_list:
        if e == DYN:
            idx.append(int(next(it)))
        elif isinstance(e, (int, np.integer)):
            idx.append(int(e))
        else:
            _, a, b, c = e
            idx.append(slice(*(int(next(it)) if p == DYN else p for p in (a, b, c))))
    return tuple(idx)


def _negative_steps(idx):
    return any(isinstance(e, slice) and e.step is not None and e.step < 0 for e in idx)


def _select(x, idx):
    """x[idx] for ints and slices; torch slicing rejects negative steps,
    which become an index_select of the explicit positions."""
    if not _negative_steps(idx):
        return x[idx]
    dim = 0
    for e in idx:
        if isinstance(e, int):
            x = x.select(dim, e)
            continue
        ids = range(*e.indices(x.shape[dim]))
        x = x.index_select(dim, torch.arange(ids.start, ids.stop, ids.step,
                                             device=x.device))
        dim += 1
    return x


@torch_funcify.register(Subtensor)
def _subtensor(op, node=None, **kw):
    idx_list = op.idx_list

    def subtensor(x, *dyn):
        return _select(x, _basic_index(idx_list, dyn))

    return subtensor


@torch_funcify.register(IncSubtensor)
def _inc_subtensor(op, node=None, **kw):
    idx_list = op.idx_list
    set_mode = op.set_instead_of_inc

    def inc_subtensor(x, y, *dyn):
        idx = _basic_index(idx_list, dyn)
        if _negative_steps(idx):
            raise NotImplementedError("IncSubtensor with a negative slice step")
        out = x.clone()
        if set_mode:
            out[idx] = y
        else:
            out[idx] += y
        return out

    return inc_subtensor


class _IndexCheck:
    """Bounds check and negative-index normalisation of one index input."""

    def __init__(self, var, static_dim=None):
        self.const = isinstance(var, Constant)
        if self.const:
            data = np.asarray(var.data)
            self.lo = int(data.min()) if data.size else 0
            self.hi = int(data.max()) if data.size else -1
            if static_dim is not None:
                self._check(self.lo, self.hi, static_dim)

    @staticmethod
    def _check(lo, hi, n):
        if lo < -n or hi >= n:
            bad = lo if lo < -n else hi
            raise IndexError(f"index {bad} is out of bounds for axis with size {n}")

    def __call__(self, idx, n):
        if idx.dtype == torch.bool:
            raise NotImplementedError("boolean mask indices have a dynamic shape")
        if self.const:
            lo, hi = self.lo, self.hi
        elif idx.numel():
            lo, hi = int(idx.min()), int(idx.max())
        else:
            return idx.long()
        self._check(lo, hi, n)
        idx = idx.long()
        return torch.where(idx < 0, idx + n, idx) if lo < 0 else idx


@torch_funcify.register(AdvancedSubtensor1)
def _adv_sub1(op, node=None, **kw):
    check = _IndexCheck(node.inputs[1], node.inputs[0].type.shape[0])

    def adv_sub1(x, ilist):
        return x.index_select(0, check(ilist, x.shape[0]))

    return adv_sub1


@torch_funcify.register(AdvancedIncSubtensor1)
def _adv_incsub1(op, node=None, **kw):
    check = _IndexCheck(node.inputs[2], node.inputs[0].type.shape[0])
    set_mode = op.set_instead_of_inc
    ignore_dups = op.ignore_duplicates

    def adv_incsub1(x, y, ilist):
        idx = check(ilist, x.shape[0])
        expected = (idx.shape[0], *x.shape[1:])
        AdvancedIncSubtensor1._check_runtime_broadcast(node, tuple(y.shape), expected)
        y = y.expand(expected)
        out = x.clone()
        if set_mode:
            out.index_copy_(0, idx, y)
        elif ignore_dups:
            out[idx] += y
        else:
            out.index_add_(0, idx, y)
        return out

    return adv_incsub1


def _adv_entries(idx_list, inputs):
    """(axis, input position) of each array index in an advanced index."""
    entries = []
    axis = 0
    pos = 0
    for e in idx_list:
        if e == "none":
            continue
        if e == DYN:
            entries.append((axis, pos))
            pos += 1
        elif isinstance(e, tuple):
            pos += sum(1 for p in e[1:] if p == DYN)
        axis += 1
    return entries


def _adv_index(idx_list, ind, checks, x):
    it = iter(ind)
    idx = []
    axis = 0
    k = 0
    for e in idx_list:
        if e == "none":
            idx.append(None)
            continue
        if e == DYN:
            idx.append(checks[k](next(it), x.shape[axis]))
            k += 1
        elif isinstance(e, (int, np.integer)):
            idx.append(int(e))
        else:
            _, a, b, c = e
            idx.append(slice(*(int(next(it)) if p == DYN else p for p in (a, b, c))))
        axis += 1
    return tuple(idx)


@torch_funcify.register(AdvancedSubtensor)
def _adv_sub(op, node=None, **kw):
    idx_list = op.idx_list
    x_shape = node.inputs[0].type.shape
    checks = [_IndexCheck(node.inputs[1 + pos], x_shape[axis])
              for axis, pos in _adv_entries(idx_list, node.inputs[1:])]

    def adv_sub(x, *ind):
        idx = _adv_index(idx_list, ind, checks, x)
        if _negative_steps(idx):
            raise NotImplementedError("AdvancedSubtensor with a negative slice step")
        return x[idx]

    return adv_sub


@torch_funcify.register(AdvancedIncSubtensor)
def _adv_incsub(op, node=None, **kw):
    """One 1-d integer index along an axis, full slices elsewhere: the form
    a gradient of ``x[:, idx]`` takes.  Other forms raise."""
    idx_list = op.idx_list
    full = ("slice", None, None, None)
    dyn_axes = [d for d, e in enumerate(idx_list) if e == DYN]
    if (len(dyn_axes) != 1 or any(e not in (DYN, full) for e in idx_list)
            or node.inputs[2].type.ndim != 1):
        raise NotImplementedError(f"torch lowering of {op} with index {idx_list}")
    axis = dyn_axes[0]
    check = _IndexCheck(node.inputs[2], node.inputs[0].type.shape[axis])
    set_mode = op.set_instead_of_inc

    def adv_incsub(x, y, ilist):
        idx = check(ilist, x.shape[axis])
        expected = list(x.shape)
        expected[axis] = idx.shape[0]
        y = y.expand(expected)
        out = x.clone()
        if set_mode:
            out.index_copy_(axis, idx, y)
        elif op.ignore_duplicates:
            out[(slice(None),) * axis + (idx,)] += y
        else:
            out.index_add_(axis, idx, y)
        return out

    return adv_incsub


# --- scan -----------------------------------------------------------------------

@torch_funcify.register(Scan)
def _scan(op, node=None, device=None, **kw):
    """The loop below, or with ``config.scan__pallas`` and an eligible
    scan the whole-loop kernel K2 (the rule of
    ``pytensor_tpu/scan/op.py:801-806``); K2's wrapper runs this loop on
    CPU tensors and the kernel on CUDA tensors, never the loop in its place."""
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda.scan_kernel import ScanKernel, scan_kernel_eligible

    if config.scan__pallas and scan_kernel_eligible(op, node):
        return ScanKernel(op, node, device)
    return scan_loop(op, device)


def scan_loop(op, device):
    """A for-scan as a torch step loop over the inner graph linked for
    ``device`` (counterpart of ``pytensor_tpu/scan/op.py:817-875``); the
    plain version of K2.  Returns ``loop(n_steps, *outer)``, which gives
    the traces of the states, the final untraced states and the nit-sot
    traces, in that order."""
    from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch

    info = op.info
    inner = fgraph_to_torch(op.fgraph, device, trust_input=True)
    n_seqs, n_states, n_unt = info.n_seqs, info.n_states, info.n_untraced
    depth = [-min(taps) for taps in info.taps]
    single = [m == 1 and len(taps) == 1 for m, taps in zip(depth, info.taps)]
    nit_types = [o.type for o in op.inner_nit_sot_outs()]

    def loop(n_steps, *outer):
        T = int(n_steps)
        seqs = outer[:n_seqs]
        for s in seqs:
            if s.shape[0] < T:
                raise ValueError(f"scan of {T} steps over a sequence of {s.shape[0]} rows")
        inits = outer[n_seqs: n_seqs + n_states]
        untraced = list(outer[n_seqs + n_states: n_seqs + n_states + n_unt])
        non_seqs = list(outer[n_seqs + n_states + n_unt:])
        # state histories, oldest first
        hist = [[init] if one else [init[i] for i in range(m)]
                for init, one, m in zip(inits, single, depth)]
        traces = [[] for _ in range(n_states)]
        nits = [[] for _ in range(info.n_nit_sot)]
        for t in range(T):
            args = [s[t] for s in seqs]
            for k, taps in enumerate(info.taps):
                args.extend(hist[k][depth[k] + tap] for tap in taps)
            res = inner(*args, *untraced, *non_seqs)
            for k in range(n_states):
                traces[k].append(res[k])
                hist[k] = hist[k][1:] + [res[k]]
            untraced = list(res[n_states: n_states + n_unt])
            for j in range(info.n_nit_sot):
                nits[j].append(res[n_states + n_unt + j])

        def stacked(rows, core_shape, dtype):
            if rows:
                return torch.stack(rows)
            return torch.empty((0, *core_shape), dtype=dtype, device=device)

        out = [stacked(traces[k], tuple(hist[k][-1].shape), inits[k].dtype)
               for k in range(n_states)]
        out += untraced
        out += [stacked(nits[j], tuple(s or 0 for s in nit_types[j].shape),
                        torch_dtype(nit_types[j].dtype)) for j in range(info.n_nit_sot)]
        return out

    return loop


# --- sparse ---------------------------------------------------------------------
# A sparse value is the canonical CSR triple (link/torch/convert.py CSR) of
# the logical matrix, whatever its graph format.

def _csr_rows(a):
    """The row of each nonzero of CSR ``a``."""
    counts = (a.indptr[1:] - a.indptr[:-1]).long()
    return torch.repeat_interleave(torch.arange(a.shape[0], device=a.data.device), counts)


@torch_funcify.register(StructuredDot)
def _structured_dot(op, node=None, **kw):
    """The matvec of a matrix the routed rewrite refused (under 4,096
    nonzeros, float64, a sparse input, a 2-d operand).  As the JAX
    package's ``_sdot``: a float32 CSR constant sums each row as a
    difference of one prefix sum over the products; any other operand
    adds the products into their rows (``index_add_``)."""
    out = torch_dtype(node.outputs[0].type.dtype)
    a_var = node.inputs[0]
    prefix = (out == torch.float32 and isinstance(a_var, Constant)
              and a_var.type.format == "csr")

    def structured_dot(a, b):
        b = b.to(out)
        prod = a.data.to(out)[(slice(None),) + (None,) * (b.ndim - 1)] * b[a.indices.long()]
        if prefix:
            cs = torch.cumsum(prod, dim=0)
            padded = torch.cat([torch.zeros_like(cs[:1]), cs])
            starts = a.indptr.long()
            return padded[starts[1:]] - padded[starts[:-1]]
        y = torch.zeros((a.shape[0], *b.shape[1:]), dtype=out, device=b.device)
        return y.index_add_(0, _csr_rows(a), prod)

    return structured_dot


@torch_funcify.register(Transpose)
def _transpose(op, node=None, **kw):
    def transpose(a):
        rows = _csr_rows(a)
        cols = a.indices.long()
        # a stable sort by column keeps each new row's columns sorted
        order = torch.sort(cols, stable=True).indices
        counts = torch.bincount(cols, minlength=a.shape[1])
        indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)]).to(torch.int32)
        return CSR(indptr, rows[order].to(torch.int32), a.data[order],
                   (a.shape[1], a.shape[0]))

    return transpose


@torch_funcify.register(StructuredDotGrad)
def _structured_dot_grad(op, node=None, **kw):
    dtype = torch_dtype(node.outputs[0].type.dtype)

    def structured_dot_grad(a, b, gz):
        b2 = b if b.ndim == 2 else b[:, None]
        gz2 = gz if gz.ndim == 2 else gz[:, None]
        vals = (gz2[_csr_rows(a)] * b2[a.indices.long()]).sum(1)
        return CSR(a.indptr, a.indices, vals.to(dtype), a.shape)

    return structured_dot_grad


@torch_funcify.register(RoutedSpMV)
def _routed_spmv(op, node=None, **kw):
    """K4 on a CUDA device, its plain version on the CPU; a (N, 1)
    operand is viewed flat."""
    from pytensor_tpu_torch.link.cuda.spmv_kernel import spmv

    def routed_spmv(b, indptr, indices, data):
        x = b.reshape(-1) if b.ndim == 2 else b
        return spmv(indptr, indices, data, x.contiguous())

    return routed_spmv

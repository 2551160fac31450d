"""torch lowerings of the ops: the ``torch_funcify`` registry.

Counterpart of ``pytensor_tpu/link/xla/dispatch.py`` (``xla_funcify:27``
and the lowerings at ``:155-760``, with the blas lowerings of
``pytensor_tpu/tensor/blas.py:246-289``, and the ``Blockwise`` lowering
of ``:870``, with those of ``extra_ops`` and ``sort`` at ``:772-868``;
the lowering of ``FromFunctionOp`` waits for its module), of the
lowerings of ``pytensor_tpu/raise_op.py:81``, ``ifelse.py:114``,
``breakpoint.py:94`` and ``typed_list/basic.py:255-357``, of the
lowerings of ``pytensor_tpu/tensor/einsum.py:229``,
``fft.py:142`` and ``signal/conv.py:180``, of those of
``pytensor_tpu/tensor/optimize.py:346`` (in ``link/torch/optimize.py``), of the Scan lowering at
``pytensor_tpu/scan/op.py:790`` and of the sparse lowerings of
``pytensor_tpu/sparse/{basic,structured,linalg,compat,spmv}.py`` (in
``link/torch/sparse.py``).
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

from pytensor_tpu_torch.breakpoint import PdbBreakpoint
from pytensor_tpu_torch.compile.builders import OpFromGraph
from pytensor_tpu_torch.compile.ops import DeepCopyOp, TypeCastingOp
from pytensor_tpu_torch.gradient import GradManipulatorOp
from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.ifelse import IfElse
from pytensor_tpu_torch.printing import Print
from pytensor_tpu_torch.raise_op import CheckAndRaise
from pytensor_tpu_torch.scalar.basic import upcast
from pytensor_tpu_torch.link.torch.convert import UNSIGNED, torch_dtype
from pytensor_tpu_torch.scan.dynlen import PadTraceGrad, TruncateToDone
from pytensor_tpu_torch.scan.op import Scan
from pytensor_tpu_torch.tensor.basic import (
    ARange,
    Alloc,
    AllocEmpty,
    Eye,
    ExtractDiag,
    Join,
    MakeVector,
    Nonzero,
    Split,
)
from pytensor_tpu_torch.tensor.blockwise import Blockwise
from pytensor_tpu_torch.tensor.blas import BatchedDot, Dot22, Dot22Scalar, Gemm, Gemv, Ger
from pytensor_tpu_torch.tensor.einsum import Einsum, contraction_path
from pytensor_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise
from pytensor_tpu_torch.tensor.extra_ops import (
    CumOp,
    RavelMultiIndex,
    Repeat,
    SearchsortedOp,
    Unique,
    UnravelIndex,
)
from pytensor_tpu_torch.tensor.fft import IRFFTOp, RFFTOp
from pytensor_tpu_torch.tensor.fused import FusedElemwise
from pytensor_tpu_torch.tensor.linalg import (
    QR,
    SVD,
    Cholesky,
    CholeskySolve,
    Det,
    Eigh,
    Expm,
    Lu,
    MatrixInverse,
    SLogDet,
    Solve,
    SolveTriangular,
    TridiagonalSolve,
)
from pytensor_tpu_torch.tensor.math import Argmax, Dot
from pytensor_tpu_torch.tensor.signal.conv import Convolve1d, Convolve2d
from pytensor_tpu_torch.tensor.sort import ArgSortOp, SortOp, TopKOp
from pytensor_tpu_torch.tensor.shape import Reshape, Shape, Shape_i, SpecifyShape, Unbroadcast
from pytensor_tpu_torch.tensor.type import TensorType
from pytensor_tpu_torch.tensor.type_other import MakeSlice
from pytensor_tpu_torch.typed_list.basic import (
    Append,
    Count,
    Extend,
    GetItem,
    Index,
    Insert,
    Length,
    MakeList,
    Remove,
    Reverse,
)
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


# --- what a lowering reads on the host ----------------------------------------

ALL = "all"


def ports(host=(), checked=(), scalar=(), reads_back=False, keeps_host=(), batched=False,
          host_outputs=(), bounded=()):
    """Declare, on a lowering, what its function does with the host.  Each
    of ``host``, ``checked``, ``scalar`` and ``keeps_host`` is a tuple of
    input positions, ``ALL`` or a function of the node giving them:

    - ``host``: inputs read with ``int()``, ``.item()`` or ``.tolist()``
      (a shape, a step count, a basic index's bounds, an axis);
    - ``checked``: integer indices bounds-checked by ``_IndexCheck`` (a
      constant at link time, any other by reading its min and max);
    - ``scalar``: inputs at which a one-element host value is taken as a
      scalar argument, not a tensor copied to the device;
    - ``reads_back``: the function reads the device on the host (the
      output's size, or a torch routine that synchronises): a string that
      says why, or a function of the node giving one;
    - ``keeps_host``: inputs at which a host value is handed on as it is,
      to a plan that keeps it on the host (a scan's non-sequences, which
      its step loop's inner plan reads as host values);
    - ``batched``: the function takes leading batch dimensions on its
      inputs and broadcasts them, so that a ``Blockwise`` of the op is one
      call of it (a flag, or a function of the ``Blockwise`` node);
    - ``host_outputs``: output positions the function returns as host
      values made from what the host knows (``CSMProperties``' shape);
    - ``bounded``: output positions whose least and greatest entries the
      function knows from its inputs' shapes and records in the plan's
      ``bounds`` (a dict by variable, which the linker hands each
      lowering), so that a bounds check of an index by one reads nothing
      back (``_IndexCheck``; ``sparse/compat.py _MajorIds``' row ids).

    The linker places the constants of ``host`` ports on the host, and its
    capture rule (``linker.py _host_reads``) reads these declarations."""
    def declare(lowering):
        lowering.ports = {"host": host, "checked": checked, "scalar": scalar,
                          "reads_back": reads_back, "keeps_host": keeps_host,
                          "batched": batched, "host_outputs": host_outputs,
                          "bounded": bounded}
        return lowering

    return declare


def ports_of(node, kind, op=None):
    """What the lowering of ``node``'s op (or of ``op``) declares
    (``ports``): a set of input positions, ``reads_back``'s reason (empty
    when it reads nothing back) or ``batched``'s flag."""
    op = node.op if op is None else op
    spec = getattr(torch_funcify.dispatch(type(op)), "ports", {}).get(kind, ())
    if callable(spec):
        spec = spec(node)
    if kind == "reads_back":
        return spec or ""
    if kind == "batched":
        return bool(spec)
    if spec == ALL:
        spec = range(len(node.inputs))
    return set(spec)


def _from(k):
    """Ports ``k`` onwards."""
    return lambda node: range(k, len(node.inputs))


# --- elementwise --------------------------------------------------------------

def elemwise_fn(node):
    """torch implementation of one Elemwise node.

    Operands are cast to their compute dtypes before the op
    (``ScalarOp.compute_dtypes``: mostly the output's), which is numpy's
    rule of computing in the promoted dtype; torch's own promotion would
    let a 0-d float64 operand be computed at float32.
    """
    so = node.op.scalar_op
    so.check_inputs(*(i.type.dtype for i in node.inputs))
    fn = so.torch_fn
    if any(v.type.dtype in UNSIGNED for v in node.inputs + node.outputs):
        return _unsigned_elemwise(node)
    if so.name == "second" or so.name.startswith("cast{"):
        return fn
    comp = [torch_dtype(d) for d in so.compute_dtypes([i.type.dtype for i in node.inputs],
                                                      node.outputs[0].type.dtype)]

    def elemwise(*args):
        shape = None
        dev = next((a.device for a in args if a.device.type != "cpu"), None)
        if dev is not None and any(a.device != dev for a in args):
            # one-element values from the host beside tensors on the card
            # (shapes, cast): torch takes them as scalars when 0-d
            shape = torch.broadcast_shapes(*(a.shape for a in args))
            args = [a if a.device == dev else a.reshape(()) for a in args]
        out = fn(*[a if a.dtype == c else a.to(c) for a, c in zip(args, comp)])
        return out if shape is None or out.shape == shape else out.reshape(shape)

    return elemwise


def _host_op_reads(node):
    so = node.op.scalar_op
    return f"{so.name} runs scipy on the host" if so.on_host else ""


# --- uint16, uint32 and uint64, held in int64 (convert.py UNSIGNED) ---------------

_SIGN_BIT = -(2 ** 63)


def _width_mask(dtype):
    """The bits of an unsigned dtype below 64 bits, else None."""
    return {"uint16": 0xFFFF, "uint32": 0xFFFFFFFF}.get(str(dtype))


def _to_held(x, src, dst):
    """A value of graph dtype ``src`` converted to graph dtype ``dst``,
    either side held: numpy's conversions, unsigned where a side is."""
    if src == dst:
        return x
    if src in UNSIGNED and dst not in UNSIGNED:
        if src == "uint64" and dst != "bool":
            return x.view(torch.uint64).to(torch_dtype(dst))
        return x.to(torch_dtype(dst))
    if dst in UNSIGNED:
        if x.is_floating_point():
            # past int64's range a float wraps as numpy's conversion does
            x = torch.where(x >= 2.0 ** 63, x - 2.0 ** 64, x).to(torch.int64)
        x = x.to(torch.int64)
        mask = _width_mask(dst)
        return x & mask if mask is not None else x
    return x.to(torch_dtype(dst))


def _ucmp(a, b):
    """Signed stand-ins of held uint64 values that order as the unsigned ones."""
    return a ^ _SIGN_BIT, b ^ _SIGN_BIT


def _udivmod64(a, b):
    """numpy's unsigned floor division and remainder of held uint64 values
    (an integer divisor of 0 gives 0, as numpy's)."""
    zero = b == 0
    b1 = torch.where(zero, torch.ones_like(b), b)
    # a divisor of 2**63 or more: the quotient is 0 or 1
    big_q = (_ucmp(a, b1)[0] >= _ucmp(a, b1)[1]).to(torch.int64)
    # else twice the quotient of a >> 1 (a logical shift), then one more
    # if the remainder, below 2 b, is b or more
    bs = torch.where(b1 < 0, torch.ones_like(b1), b1)
    q = torch.div((a >> 1) & ~_SIGN_BIT, bs, rounding_mode="floor") << 1
    r = a - q * bs
    q = q + (_ucmp(r, bs)[0] >= _ucmp(r, bs)[1]).to(torch.int64)
    q = torch.where(b1 < 0, big_q, q)
    q = torch.where(zero, torch.zeros_like(q), q)
    return q, torch.where(zero, torch.zeros_like(a), a - q * b1)


def _unsigned_elemwise(node):
    """An Elemwise that meets uint16, uint32 or uint64: each operand
    converted to its compute dtype by ``_to_held``; wrapping arithmetic in
    int64, cut to the width; comparisons, division, maximum and minimum of
    uint64 as unsigned."""
    so = node.op.scalar_op
    name = so.name
    in_dts = [i.type.dtype for i in node.inputs]
    out_dt = node.outputs[0].type.dtype
    if name.startswith("cast{"):
        return lambda a: _to_held(a, in_dts[0], out_dt)
    comp = so.compute_dtypes(in_dts, out_dt)
    c = comp[0]
    fn = so.torch_fn
    mask = _width_mask(out_dt)
    wide = c == "uint64"

    def unsigned(*args):
        args = [_to_held(a, d, cd) for a, d, cd in zip(args, in_dts, comp)]
        if c in UNSIGNED and name in ("lt", "gt", "le", "ge", "maximum", "minimum") and wide:
            ua, ub = _ucmp(*args)
            r = fn(ua, ub)
            return r if r.dtype == torch.bool else r ^ _SIGN_BIT
        if c in UNSIGNED and name in ("int_div", "mod") and wide:
            return _udivmod64(*args)[0 if name == "int_div" else 1]
        if c in UNSIGNED and name == "abs":
            return args[0].clone()
        if c in UNSIGNED and name == "sign":
            return (args[0] != 0).to(torch.int64)
        r = fn(*args)
        if mask is not None and r.dtype == torch.int64:
            r = r & mask
        return r

    return unsigned


@torch_funcify.register(Elemwise)
@ports(scalar=ALL, reads_back=_host_op_reads)
def _elemwise(op, node=None, device=None, **kw):
    """The op's torch version; on a CUDA device, a special function of
    ``scalar/math.py`` is K1 over the one-node graph (the fusion pass left
    it alone, as it leaves every node of a scan's inner graph), and never
    its plain version."""
    if op.scalar_op.special and device is not None and torch.device(device).type == "cuda":
        return _one_node_k1(op, node, device)
    fn = elemwise_fn(node)

    def elemwise(*args):
        if len(args) > 1:
            Elemwise._check_runtime_broadcast(node, [tuple(a.shape) for a in args])
        return fn(*args)

    return elemwise


def _one_node_k1(op, node, device):
    """K1 over the graph of ``node`` alone: its constants are the kernel's
    literals (or, for arrays, its extra inputs), its other inputs the
    kernel's.  The function takes the node's inputs; ``.k1`` is the
    kernel, which the linker builds with the plan's others."""
    from pytensor_tpu_torch.tensor.fused_kernel import FusedElemwiseKernel

    takes = [k for k, i in enumerate(node.inputs) if not isinstance(i, Constant)]
    fresh = {k: node.inputs[k].type() for k in takes}
    args = [fresh.get(k, i) for k, i in enumerate(node.inputs)]
    kern = FusedElemwiseKernel(
        FunctionGraph([fresh[k] for k in takes], [op(*args)], clone=False), device)

    def one_node_k1(*args):
        if len(args) > 1:
            Elemwise._check_runtime_broadcast(node, [tuple(a.shape) for a in args])
        return kern(*[args[k] for k in takes])[0]

    one_node_k1.k1 = kern
    return one_node_k1


@torch_funcify.register(FusedElemwise)
@ports(scalar=ALL)
def _fused(op, node=None, device=None, **kw):
    from pytensor_tpu_torch.tensor.fused_kernel import FusedElemwiseKernel

    return FusedElemwiseKernel(op.fgraph, device)


@torch_funcify.register(OpFromGraph)
def _op_from_graph(op, node=None, device=None, checks=None, **kw):
    """A composite (``SymbolicOp``: the softmax family) runs its inner graph
    linked for ``device`` (its deferred checks the outer plan's)."""
    from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch

    inner = fgraph_to_torch(op.fgraph, device, trust_input=True, checks=checks)

    def op_from_graph(*args):
        res = inner(*args)
        return res if len(res) > 1 else res[0]

    return op_from_graph


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
    if name not in ("add", "mul", "maximum", "minimum", "and_", "or_"):
        raise NotImplementedError(f"torch lowering of {op}")
    axis = op.axis
    out = torch_dtype(node.outputs[0].type.dtype)
    acc = torch_dtype(op.acc_dtype) if op.acc_dtype is not None else out
    # a bfloat16 sum or product accumulates in float32 and rounds once, as
    # XLA's reductions of bfloat16 do
    acc = torch.float32 if acc == torch.bfloat16 else acc

    in_dt, out_dt = node.inputs[0].type.dtype, node.outputs[0].type.dtype
    if in_dt in UNSIGNED or out_dt in UNSIGNED:
        return _unsigned_careduce(op, node)

    def careduce(x):
        dims = tuple(range(x.ndim)) if axis is None else tuple(axis)
        if not dims:
            return x.to(out).clone()
        if name == "add":
            r = torch.sum(x, dim=dims, dtype=acc)
        elif name in ("maximum", "minimum") and x.is_complex():
            r = _complex_extreme(x, dims, name == "maximum")
        elif name == "maximum":
            # NaN propagates, as in numpy's maximum.reduce
            r = torch.amax(x, dim=dims)
        elif name == "minimum":
            r = torch.amin(x, dim=dims)
        elif name == "and_":
            r = torch.all(x, dim=dims)
        elif name == "or_":
            r = torch.any(x, dim=dims)
        else:
            r = x.to(acc)
            for d in sorted(dims, reverse=True):
                r = torch.prod(r, dim=d)
        return r if r.dtype == out else r.to(out)

    return careduce


def _complex_extreme(x, dims, largest):
    """numpy's max (or min) of complex values over ``dims``: the real parts'
    extreme, then the imaginary parts' among the values that reach it."""
    ext = torch.amax if largest else torch.amin
    re = ext(x.real, dim=dims, keepdim=True)
    fill = -torch.inf if largest else torch.inf
    im = ext(torch.where(x.real == re, x.imag, torch.full_like(x.imag, fill)), dim=dims)
    return torch.complex(re.squeeze(dims), im)


def _unsigned_careduce(op, node):
    """A reduction that meets a held unsigned dtype: in the accumulator's
    dtype, held (a sum wraps in int64, then is cut to the width); maximum
    and minimum of uint64 as unsigned."""
    name = op.scalar_op.name
    in_dt, out_dt = node.inputs[0].type.dtype, node.outputs[0].type.dtype
    acc_dt = op.acc_dtype or out_dt

    def careduce(x):
        dims = tuple(range(x.ndim)) if op.axis is None else tuple(op.axis)
        x = _to_held(x, in_dt, acc_dt)
        if not dims:
            return _to_held(x.clone(), acc_dt, out_dt)
        flip = acc_dt == "uint64" and name in ("maximum", "minimum")
        if flip:
            x = x ^ _SIGN_BIT
        if name == "add":
            r = torch.sum(x, dim=dims)
        elif name == "maximum":
            r = torch.amax(x, dim=dims)
        elif name == "minimum":
            r = torch.amin(x, dim=dims)
        elif name == "and_":
            r = torch.all(x, dim=dims)
        elif name == "or_":
            r = torch.any(x, dim=dims)
        elif name == "mul":
            r = x
            for d in sorted(dims, reverse=True):
                r = torch.prod(r, dim=d)
        else:
            raise NotImplementedError(f"torch lowering of {op}")
        if flip:
            r = r ^ _SIGN_BIT
        mask = _width_mask(acc_dt)
        if mask is not None and r.dtype == torch.int64:
            r = r & mask
        return _to_held(r, acc_dt, out_dt)

    return careduce


@torch_funcify.register(Dot)
@torch_funcify.register(Dot22)
@ports(batched=True)
def _dot(op, node=None, **kw):
    """``torch.matmul`` (full float32: a function linked for CUDA runs with
    TF32 off; a bfloat16 product accumulates in float32 and rounds once,
    with cuBLAS's reduced-precision reductions off).  Operands with leading batch dimensions (a ``Blockwise``'s)
    are matrices: a vector core is a row or a column of one."""
    cx, cy = (i.type.ndim for i in node.inputs)
    if cx == cy == 2:
        return torch.matmul

    def dot(x, y):
        if x.ndim == cx and y.ndim == cy:
            return torch.matmul(x, y)
        r = torch.matmul(x.unsqueeze(-2) if cx == 1 else x, y.unsqueeze(-1) if cy == 1 else y)
        return r[..., 0, 0] if cx == cy else r[..., 0] if cy == 1 else r[..., 0, :]

    return dot


@torch_funcify.register(BatchedDot)
def _batched_dot(op, node=None, **kw):
    return torch.bmm


def _const_scalar(var):
    """The Python number of a 0-d constant, else None."""
    if isinstance(var, Constant) and np.ndim(var.data) == 0:
        return np.asarray(var.data).item()
    return None


@torch_funcify.register(Gemm)
@ports(scalar=(1, 4))
def _gemm(op, node=None, **kw):
    """beta * z + alpha * (x @ y): ``torch.addmm`` where alpha and beta are
    constants, else the JAX package's expression; a 0-d host alpha or
    beta is a scalar argument."""
    alpha, beta = _const_scalar(node.inputs[1]), _const_scalar(node.inputs[4])
    # the operands of other dtypes are cast to the output's, as numpy and
    # XLA promote (a float32 constant z beside float64 x and y)
    cast = _cast_to(node)
    if alpha is not None and beta is not None:
        return lambda z, a, x, y, b: torch.addmm(*cast(z, x, y), beta=beta, alpha=alpha)

    def gemm(z, a, x, y, b):
        z, x, y = cast(z, x, y)
        return b * z + a * torch.matmul(x, y)

    return gemm


@torch_funcify.register(Dot22Scalar)
@ports(scalar=(2,))
def _dot22scalar(op, node=None, **kw):
    return lambda x, y, alpha: alpha * torch.matmul(x, y)


@torch_funcify.register(Gemv)
@ports(scalar=(1, 4))
def _gemv(op, node=None, **kw):
    alpha, beta = _const_scalar(node.inputs[1]), _const_scalar(node.inputs[4])
    if alpha is not None and beta is not None:
        return lambda y, a, A, x, b: torch.addmv(y, A, x, beta=beta, alpha=alpha)
    return lambda y, a, A, x, b: b * y + a * torch.mv(A, x)


@torch_funcify.register(Ger)
@ports(scalar=(1,))
def _ger(op, node=None, **kw):
    return lambda A, alpha, x, y: A + alpha * torch.outer(x, y)


@torch_funcify.register(Argmax)
def _argmax(op, node=None, **kw):
    """numpy's argmax (the first maximum); several axes are moved last
    and merged, in numpy's C order."""
    axis = op.axis

    def argmax(x):
        if axis is None:
            return torch.argmax(x.reshape(-1))
        if len(axis) == 1:
            return torch.argmax(x, dim=axis[0])
        keep = [d for d in range(x.ndim) if d not in axis]
        xt = x.permute(*keep, *axis)
        return torch.argmax(xt.reshape(*xt.shape[: len(keep)], -1), dim=-1)

    return argmax


# --- identities, copies, slices ------------------------------------------------

@torch_funcify.register(TypeCastingOp)
@torch_funcify.register(GradManipulatorOp)
@torch_funcify.register(Unbroadcast)
def _identity(op, node=None, **kw):
    return lambda x: x


@torch_funcify.register(DeepCopyOp)
def _deep_copy(op, node=None, **kw):
    # torch tensors are mutable, so the copy is real (the JAX package's
    # arrays are not, and its DeepCopyOp is the identity)
    return torch.clone


@torch_funcify.register(Print)
@ports(reads_back="Print reads its value back to the host and prints it")
def _print(op, node=None, **kw):
    from pytensor_tpu_torch.link.torch.convert import to_numpy

    def print_(x):
        op.show(to_numpy(x))
        return x

    return print_


# --- control and debug ops ---------------------------------------------------

@torch_funcify.register(CheckAndRaise)
@ports(keeps_host=_from(1))
def _check_and_raise(op, node=None, device=None, checks=None, slot=None, host=frozenset(),
                     **kw):
    """On the CPU the check at the node, in ``perform``'s order.  On a CUDA
    device (a plan given ``checks``) a condition that is a host value is
    checked at the node, and a device one ORs whether it failed into the
    node's slot of the outermost plan's flags (``linker.py Checks``), read
    after the call: no read of the device here, so the plan may still be
    captured."""
    def check_at_node(value, *conds):
        for c in conds:
            if not bool(torch.as_tensor(c).all()):
                raise op.exc_type(op.msg)
        return value

    if checks is None:
        return check_at_node

    on_host = [i in host for i in node.inputs[1:]]

    def check_deferred(value, *conds):
        failed = None
        for c, at_host in zip(conds, on_host):
            if at_host:
                if not bool(c.all()):
                    raise op.exc_type(op.msg)
            else:
                bad = c.all().logical_not()
                failed = bad if failed is None else failed.logical_or(bad)
        if failed is not None:
            checks.buffer[slot].logical_or_(failed)
        return value if value.device == device else value.to(device)

    return check_deferred


@torch_funcify.register(IfElse)
@ports(reads_back="the condition is read on the host to choose the branch")
def _ifelse(op, node=None, device=None, **kw):
    """The taken branch's values.  The linker's lazy run (``linker.py
    Lazy``) reads the condition once, computes only the taken branch and
    passes the condition as a Python bool, the other branch's values as
    None; a branch value that is a host value moves to the device."""
    n = op.n_outs

    def ifelse(cond, *branches):
        chosen = [b if b.device == device else b.to(device)
                  for b in (branches[:n] if bool(cond) else branches[n:])]
        return chosen if n > 1 else chosen[0]

    return ifelse


@torch_funcify.register(PdbBreakpoint)
@ports(reads_back="the condition is read on the host to decide whether to break")
def _pdb_breakpoint(op, node=None, **kw):
    """The monitored values themselves; where the condition holds, the
    debugger first, with CPU numpy copies of them."""
    from pytensor_tpu_torch.link.torch.convert import to_numpy

    def breakpoint_(condition, *monitored):
        if bool(condition):
            type(op).debugger(op.name, [to_numpy(m) for m in monitored])
        return monitored[0] if len(monitored) == 1 else tuple(monitored)

    return breakpoint_


# --- typed lists (Python lists of tensors) --------------------------------------

def _list_equal(v, e):
    """``np.array_equal`` of two tensors as a 0-d bool on the device."""
    if v.shape != e.shape:
        return torch.zeros((), dtype=torch.bool, device=v.device)
    return (v == e).all()


@torch_funcify.register(MakeList)
def _make_list(op, node=None, **kw):
    return lambda *elems: list(elems)


@torch_funcify.register(GetItem)
@ports(host=(1,))
def _getitem(op, node=None, **kw):
    return lambda x, i: x[int(i)]


@torch_funcify.register(Append)
def _append(op, node=None, **kw):
    return lambda x, e: list(x) + [e]


@torch_funcify.register(Extend)
def _extend(op, node=None, **kw):
    return lambda x, y: list(x) + list(y)


@torch_funcify.register(Insert)
@ports(host=(1,))
def _insert(op, node=None, **kw):
    def insert(x, i, e):
        res = list(x)
        res.insert(int(i), e)
        return res

    return insert


@torch_funcify.register(Remove)
@ports(reads_back="the list's values are compared on the host to find the one to remove")
def _remove(op, node=None, **kw):
    def remove(x, e):
        res = list(x)
        for k, v in enumerate(res):
            if bool(_list_equal(v, e)):
                del res[k]
                break
        return res

    return remove


@torch_funcify.register(Reverse)
def _reverse(op, node=None, **kw):
    return lambda x: list(reversed(x))


@torch_funcify.register(Length)
def _length(op, node=None, **kw):
    # a host value (linker.py _host_variables): the length is the list's
    return lambda x: torch.tensor(len(x), dtype=torch.int64)


@torch_funcify.register(Count)
def _count(op, node=None, device=None, **kw):
    def count(x, e):
        if not x:
            return torch.zeros((), dtype=torch.int64, device=device)
        return torch.stack([_list_equal(v, e) for v in x]).sum(dtype=torch.int64)

    return count


@torch_funcify.register(Index)
@ports(reads_back="the list's values are compared on the host to find the first match")
def _index(op, node=None, device=None, **kw):
    def index(x, e):
        for k, v in enumerate(x):
            if bool(_list_equal(v, e)):
                return torch.tensor(k, dtype=torch.int64, device=device)
        raise ValueError("element not in typed list")

    return index


@torch_funcify.register(MakeSlice)
@ports(host=ALL)
def _make_slice(op, node=None, **kw):
    def make_slice(*args):
        return slice(*(None if a is None else int(a) for a in args))

    return make_slice


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
@ports(host=_from(1))
def _specify_shape(op, node=None, **kw):
    def specify_shape(x, *shape):
        for d, s in enumerate(shape):
            if s is not None and x.shape[d] != int(s):
                raise AssertionError(
                    f"SpecifyShape: dim {d} is {x.shape[d]}, expected {int(s)}")
        return x

    return specify_shape


@torch_funcify.register(Reshape)
@ports(host=(1,))
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
@ports(host=_from(1))
def _alloc(op, node=None, **kw):
    def alloc(value, *shape):
        return torch.broadcast_to(value, tuple(int(s) for s in shape))

    return alloc


@torch_funcify.register(AllocEmpty)
@ports(host=ALL)
def _alloc_empty(op, node=None, device=None, **kw):
    dtype = torch_dtype(op.dtype)

    def alloc_empty(*shape):
        return torch.empty(tuple(int(s) for s in shape), dtype=dtype, device=device)

    return alloc_empty


@torch_funcify.register(Join)
@ports(host=(0,))
def _join(op, node=None, **kw):
    def join(axis, *tensors):
        return torch.cat(tensors, dim=int(axis))

    return join


@torch_funcify.register(Split)
@ports(host=(1, 2))
def _split(op, node=None, **kw):
    n = op.len_splits

    def split(x, axis, splits):
        a = int(axis)
        sp = [int(s) for s in splits.tolist()]
        if len(sp) != n:
            raise ValueError(f"Length of splits is not equal to n_splits: {len(sp)} vs {n}")
        if any(s < 0 for s in sp):
            raise ValueError("Split sizes cannot be negative")
        dim = x.shape[a % x.ndim]
        if sum(sp) != dim:
            raise ValueError("Split sizes do not sum up to input length along "
                             f"axis: {dim} (got {sum(sp)})")
        return list(torch.split(x, sp, dim=a))

    return split


@torch_funcify.register(ARange)
@ports(host=ALL)
def _arange(op, node=None, device=None, **kw):
    dtype = torch_dtype(op.dtype)

    def arange(start, stop, step):
        return torch.arange(start.item(), stop.item(), step.item(), dtype=dtype, device=device)

    return arange


@torch_funcify.register(Eye)
@ports(host=ALL)
def _eye(op, node=None, device=None, **kw):
    dtype = torch_dtype(op.dtype)

    def eye(n, m, k):
        n, m, k = int(n), int(m), int(k)
        out = torch.zeros((n, m), dtype=dtype, device=device)
        out.diagonal(k).fill_(1)
        return out

    return eye


@torch_funcify.register(ExtractDiag)
@ports(batched=True)
def _extract_diag(op, node=None, **kw):
    nd = node.inputs[0].type.ndim
    a1, a2 = op.axis1 % nd, op.axis2 % nd

    def extract_diag(x):
        nb = x.ndim - nd  # a Blockwise's leading batch dimensions
        return torch.diagonal(x, op.offset, a1 + nb, a2 + nb)

    return extract_diag


@torch_funcify.register(Nonzero)
@ports(reads_back="its output length is read back from the device")
def _nonzero(op, node=None, **kw):
    """The output length depends on the data: torch reads it back from the
    device, so a plan that holds this node is never captured."""
    def nonzero(x):
        return list(torch.nonzero(x, as_tuple=True))

    return nonzero


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


def _positive_steps(x, idx, y):
    """``x[idx]`` written by ``y`` with each negative-step slice made the
    positive-step slice of the same positions, and ``y`` flipped along the
    dimensions it fills there (torch slicing rejects negative steps)."""
    new, flips, d_out = [], [], 0
    for dim, e in enumerate(idx):
        if isinstance(e, slice):
            if e.step is not None and e.step < 0:
                r = range(*e.indices(x.shape[dim]))
                new.append(slice(r[-1], r[0] + 1, -e.step) if len(r) else slice(0, 0))
                flips.append(d_out)
            else:
                new.append(e)
            d_out += 1
        else:
            new.append(e)
    lead = d_out + x.ndim - len(idx) - y.ndim  # y broadcasts from the right
    dims = [d - lead for d in flips if d >= lead and y.shape[d - lead] != 1]
    return tuple(new), (torch.flip(y, dims) if dims else y)


def argmax_index(node):
    """Does ``node``, a Subtensor, take one scalar index that an Argmax
    computes over static lengths no longer than the axis it indexes (the
    multinomial HMC's ``all_theta[argmax(H + G)]``)?  Such an index is in
    bounds by construction: it stays on the device, and no check reads it
    on the host."""
    if tuple(node.op.idx_list) != (DYN,) or node.inputs[1].owner is None:
        return False
    am = node.inputs[1].owner
    if not isinstance(am.op, Argmax):
        return False
    shape = am.inputs[0].type.shape
    axes = range(len(shape)) if am.op.axis is None else am.op.axis
    if any(shape[a] is None for a in axes):
        return False
    n = int(np.prod([shape[a] for a in axes]))
    dim = node.inputs[0].type.shape[0]
    return dim is not None and n <= dim


@torch_funcify.register(Subtensor)
@ports(host=lambda node: () if argmax_index(node) else range(1, len(node.inputs)))
def _subtensor(op, node=None, **kw):
    idx_list = op.idx_list
    if argmax_index(node):
        return lambda x, i: torch.index_select(x, 0, i.reshape(1))[0]

    def subtensor(x, *dyn):
        return _select(x, _basic_index(idx_list, dyn))

    return subtensor


@torch_funcify.register(IncSubtensor)
@ports(host=_from(2))
def _inc_subtensor(op, node=None, **kw):
    idx_list = op.idx_list
    set_mode = op.set_instead_of_inc

    def inc_subtensor(x, y, *dyn):
        idx = _basic_index(idx_list, dyn)
        if _negative_steps(idx):
            idx, y = _positive_steps(x, idx, y)
        out = x.clone()
        if set_mode:
            out[idx] = y
        else:
            out[idx] += y
        return out

    return inc_subtensor


def arange_index(var):
    """``(first, step)`` when ``var`` is ``arange(start, stop, step)`` with a
    constant start and step, through DimShuffles and the addition of 0-d
    integer constants (the indices of ``diagonal``'s gradient): its entries
    are ``first + step * k`` for ``k`` below its size, so its bounds follow
    from its size, which the host knows, and not from its values.  Else
    None."""
    first = 0
    while var.owner is not None:
        op, ins = var.owner.op, var.owner.inputs
        if isinstance(op, DimShuffle):
            var = ins[0]
        elif (isinstance(op, Elemwise) and op.scalar_op.name == "add" and len(ins) == 2
              and any(_const_int(i) is not None for i in ins)):
            k = 0 if _const_int(ins[0]) is not None else 1
            first += _const_int(ins[k])
            var = ins[1 - k]
        elif isinstance(op, ARange):
            start, step = _const_int(ins[0]), _const_int(ins[2])
            return None if start is None or step is None else (first + start, step)
        else:
            return None
    return None


def bounded_by_producer(var) -> bool:
    """Does ``var``'s producer record its bounds on the host: its lowering
    declares the output ``bounded`` (``ports``)."""
    return (var.owner is not None
            and var.owner.outputs.index(var) in ports_of(var.owner, "bounded"))


def _const_int(var):
    """The Python int of a 0-d integer constant, else None."""
    if isinstance(var, Constant) and np.ndim(var.data) == 0 and var.type.dtype.startswith("int"):
        return int(var.data)
    return None


class _IndexCheck:
    """Bounds check and negative-index normalisation of one index input.
    A constant is checked by its values, an ``arange_index`` by its size,
    one ``bounded_by_producer`` by what its producer recorded in the plan's
    ``bounds`` (the lowering's ``bounds`` keyword); any other index reads
    its min and max on the host."""

    def __init__(self, var, static_dim=None, bounds=None):
        self.const = isinstance(var, Constant)
        self.arange = arange_index(var)
        self.var = var
        self.known = bounds if bounds is not None and bounded_by_producer(var) else None
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

    def bounds(self, idx):
        """The least and greatest entry of ``idx`` (None when it is empty):
        a constant's from link time, an ``arange_index``'s from its size,
        any other's read on the host."""
        if self.const:
            return self.lo, self.hi
        if not idx.numel():
            return None
        if self.arange is not None:
            first, step = self.arange
            return tuple(sorted((first, first + step * (idx.numel() - 1))))
        if self.known is not None:
            return self.known[self.var]
        return int(idx.min()), int(idx.max())

    def __call__(self, idx, n):
        if idx.dtype == torch.bool:
            raise NotImplementedError("boolean mask indices have a dynamic shape")
        if not self.const and not idx.numel():
            return idx.long()
        lo, hi = self.bounds(idx)
        self._check(lo, hi, n)
        idx = idx.long()
        return torch.where(idx < 0, idx + n, idx) if lo < 0 else idx


@torch_funcify.register(AdvancedSubtensor1)
@ports(checked=(1,))
def _adv_sub1(op, node=None, **kw):
    check = _IndexCheck(node.inputs[1], node.inputs[0].type.shape[0], kw.get("bounds"))

    def adv_sub1(x, ilist):
        return x.index_select(0, check(ilist, x.shape[0]))

    return adv_sub1


@torch_funcify.register(AdvancedIncSubtensor1)
@ports(checked=(2,))
def _adv_incsub1(op, node=None, **kw):
    check = _IndexCheck(node.inputs[2], node.inputs[0].type.shape[0], kw.get("bounds"))
    set_mode = op.set_instead_of_inc
    ignore_dups = op.ignore_duplicates

    def adv_incsub1(x, y, ilist):
        idx = check(ilist, x.shape[0])
        expected = (idx.shape[0], *x.shape[1:])
        AdvancedIncSubtensor1._check_runtime_broadcast(node, tuple(y.shape), expected)
        y = y.expand(expected)
        out = x.clone()
        if set_mode or ignore_dups:
            _copy_last(out, 0, idx, y, add=not set_mode)
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


def _adv_ports(node, first, host=False):
    """An advanced index's array indices (inputs ``first`` on), which are
    bounds-checked, or with ``host`` its other index inputs: the slice
    bounds, read on the host."""
    checked = {first + pos for _, pos in _adv_entries(node.op.idx_list, node.inputs[first:])}
    return set(range(first, len(node.inputs))) - checked if host else checked


def _last_writes(pos, n):
    """For each entry of ``pos`` (positions in ``0..n-1``), the entry that
    writes last to its position.  A write of duplicate positions without
    accumulate (``index_put_``, ``index_copy_``) leaves the winner undefined
    on CUDA; numpy's last write wins, and gathering each position's last
    value first makes every write of it the same."""
    order = torch.arange(pos.numel(), device=pos.device)
    last = torch.full((n,), -1, dtype=order.dtype, device=pos.device)
    last.scatter_reduce_(0, pos, order, reduce="amax")
    return last[pos]


def _copy_last(out, axis, idx, y, add):
    """``out[..., idx, ...] = y`` along ``axis``, or ``+= y`` with ``add``
    (numpy's, not ``np.add.at``), in place: of duplicate indices the last
    write wins, as in numpy."""
    y = y.index_select(axis, _last_writes(idx, out.shape[axis]))
    if add:
        y = out.index_select(axis, idx) + y
    out.index_copy_(axis, idx, y.to(out.dtype))


def _take_negative_steps(x, idx):
    """``(x', idx')`` with ``x'[idx'] == x[idx]`` and no negative step in
    ``idx'``: each negative-step slice is taken first, as an
    ``index_select`` of its positions, and becomes a full slice (a slice
    keeps its dimension, so the advanced entries' placement is numpy's)."""
    new = []
    axis = 0
    for e in idx:
        if isinstance(e, slice) and e.step is not None and e.step < 0:
            r = range(*e.indices(x.shape[axis]))
            x = x.index_select(axis, torch.arange(r.start, r.stop, r.step, device=x.device))
            e = slice(None)
        new.append(e)
        if e is not None:
            axis += 1
    return x, tuple(new)


def _adv_index(idx_list, ind, checks, shape):
    """The torch index of ``idx_list`` for a tensor of ``shape``."""
    it = iter(ind)
    idx = []
    axis = 0
    k = 0
    for e in idx_list:
        if e == "none":
            idx.append(None)
            continue
        if e == DYN:
            idx.append(checks[k](next(it), shape[axis]))
            k += 1
        elif isinstance(e, (int, np.integer)):
            idx.append(int(e))
        else:
            _, a, b, c = e
            idx.append(slice(*(int(next(it)) if p == DYN else p for p in (a, b, c))))
        axis += 1
    return tuple(idx)


@torch_funcify.register(AdvancedSubtensor)
@ports(host=lambda node: _adv_ports(node, 1, host=True),
       checked=lambda node: _adv_ports(node, 1))
def _adv_sub(op, node=None, **kw):
    idx_list = op.idx_list
    x_shape = node.inputs[0].type.shape
    checks = [_IndexCheck(node.inputs[1 + pos], x_shape[axis], kw.get("bounds"))
              for axis, pos in _adv_entries(idx_list, node.inputs[1:])]

    def adv_sub(x, *ind):
        idx = _adv_index(idx_list, ind, checks, x.shape)
        if _negative_steps(idx):
            x, idx = _take_negative_steps(x, idx)
        return x[idx]

    return adv_sub


def _batched_adv_incsub(node):
    """A ``Blockwise`` of an advanced increment takes its batch in one call
    when its indices have no batch dimensions (each is cut to its core and
    serves every batch element) and its array indices are adjacent, so
    that full slices over the batch dimensions put the batch first, as the
    ``Blockwise`` does."""
    core = node.op.core_op
    nb = node.op.node_batch_ndim(node)
    adv = [d for d, e in enumerate(core.idx_list) if e == DYN]
    return bool(adv) and adv == list(range(adv[0], adv[0] + len(adv))) and all(
        all(s == 1 for s in i.type.shape[:nb]) for i in node.inputs[2:])


@torch_funcify.register(AdvancedIncSubtensor)
@ports(host=lambda node: _adv_ports(node, 2, host=True),
       checked=lambda node: _adv_ports(node, 2), batched=_batched_adv_incsub)
def _adv_incsub(op, node=None, **kw):
    """One 1-d integer index along an axis, full slices elsewhere (the form
    a gradient of ``x[:, idx]`` takes) runs as ``index_add_``/``index_copy_``.
    Any other index is numpy's: the flat positions it selects are
    ``arange(x.size).reshape(x.shape)[idx]``, and the update is one
    ``index_put_`` into the flat copy, summing duplicates for an increment
    (``np.add.at``) unless ``ignore_duplicates``.  A set, or an increment
    that ignores duplicates (numpy's ``x[idx] += y``), writes each
    position's last value, as numpy does (``_last_writes``).  Leading
    batch dimensions of ``x`` and ``y`` (a ``Blockwise``'s, with indices
    of no batch dimensions) take full slices."""
    idx_list = op.idx_list
    x_shape = node.inputs[0].type.shape
    core_nd = node.inputs[0].type.ndim
    entries = _adv_entries(idx_list, node.inputs[2:])
    checks = [_IndexCheck(node.inputs[2 + pos], x_shape[axis], kw.get("bounds"))
              for axis, pos in entries]
    set_mode = op.set_instead_of_inc
    full = ("slice", None, None, None)
    dyn_axes = [d for d, e in enumerate(idx_list) if e == DYN]
    if (len(dyn_axes) == 1 and all(e in (DYN, full) for e in idx_list)
            and node.inputs[2].type.ndim == 1):
        axis = dyn_axes[0]
        check = checks[0]

        def adv_incsub_axis(x, y, ilist):
            ax = axis + x.ndim - core_nd
            idx = check(ilist, x.shape[ax])
            expected = list(x.shape)
            expected[ax] = idx.shape[0]
            y = y.expand(expected)
            out = x.clone()
            if set_mode or op.ignore_duplicates:
                _copy_last(out, ax, idx, y, add=not set_mode)
            else:
                out.index_add_(ax, idx, y)
            return out

        return adv_incsub_axis

    def adv_incsub(x, y, *ind):
        nb = x.ndim - core_nd
        idx = (slice(None),) * nb + _adv_index(idx_list, ind, checks, x.shape[nb:])
        flat_pos = torch.arange(x.numel(), device=x.device).reshape(x.shape)
        if _negative_steps(idx):
            flat_pos, idx = _take_negative_steps(flat_pos, idx)
        sel = flat_pos[idx]
        pos = sel.reshape(-1)
        vals = y.to(x.dtype).expand(sel.shape).reshape(-1)
        out = x.clone()
        flat = out.view(-1)
        if set_mode or op.ignore_duplicates:
            vals = vals[_last_writes(pos, x.numel())]
            flat.index_put_((pos,), vals if set_mode else flat[pos] + vals)
        else:
            flat.index_put_((pos,), vals, accumulate=True)
        return out

    return adv_incsub


# --- sort -------------------------------------------------------------------------

@torch_funcify.register(SortOp)
@ports(host=(1,))
def _sort(op, node=None, **kw):
    # stable, as jnp.sort; numpy's quicksort orders ties arbitrarily
    return lambda x, axis: torch.sort(x, dim=int(axis), stable=True).values


@torch_funcify.register(ArgSortOp)
@ports(host=(1,))
def _argsort(op, node=None, **kw):
    return lambda x, axis: torch.argsort(x, dim=int(axis), stable=True)


@torch_funcify.register(TopKOp)
def _topk(op, node=None, **kw):
    """``lax.top_k``'s order whether or not ``sorted`` is asked for: values
    descending, the lowest index first among ties (a stable sort, cut to
    k); ``torch.topk`` on a card orders ties as it likes."""
    k, want = op.k, (op.return_values, op.return_indices)

    def topk(x):
        vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
        outs = [o[..., :k] for o, w in zip((vals, idx), want) if w]
        return outs if len(outs) > 1 else outs[0]

    return topk


# --- extra_ops --------------------------------------------------------------------

@torch_funcify.register(CumOp)
def _cum(op, node=None, **kw):
    """``torch.cumsum``/``torch.cumprod`` in the output's dtype (torch's own
    result of an integer or bool input is int64).  A bool running sum or
    product is taken in int64 and cast back, as the numpy oracle does
    (``np.cumsum`` counts, then ``astype(bool)``); an unsigned dtype held in
    int64 (``convert.py UNSIGNED``) wraps at its width."""
    fn = torch.cumsum if op.mode == "add" else torch.cumprod
    dtype = node.outputs[0].type.dtype
    acc = torch.int64 if dtype == "bool" else torch_dtype(dtype)
    mask = _width_mask(dtype)
    dim = 0 if op.axis is None else op.axis

    def cum(x):
        r = fn(x.reshape(-1) if op.axis is None else x, dim, dtype=acc)
        if dtype == "bool":
            return r != 0
        return r & mask if mask else r

    return cum


@torch_funcify.register(Repeat)
@ports(host=(1,))
def _repeat(op, node=None, device=None, **kw):
    """``torch.repeat_interleave`` with concrete counts, read on the host.
    Constant counts are read when the graph is linked, and a vector of them
    goes to the device then, with its total as the output size, so a call
    reads nothing back; counts that are a function input are a host read
    (``linker.py _host_reads``: that plan runs eagerly)."""
    axis, reps = op.axis, node.inputs[1]
    static = None
    if isinstance(reps, Constant) and np.ndim(reps.data) == 1:
        counts = np.asarray(reps.data, dtype=np.int64)
        static = (torch.as_tensor(counts, device=device), int(counts.sum()))

    def repeat(x, repeats):
        if static is not None:
            return torch.repeat_interleave(x, static[0], dim=axis, output_size=static[1])
        counts = repeats.tolist()
        if not isinstance(counts, list):
            return torch.repeat_interleave(x, int(counts), dim=axis)
        r = torch.tensor(counts, dtype=torch.int64, device=x.device)
        return torch.repeat_interleave(x, r, dim=axis, output_size=int(sum(counts)))

    return repeat


@torch_funcify.register(SearchsortedOp)
@ports(checked=(2,))
def _searchsorted(op, node=None, **kw):
    """``torch.searchsorted`` on both operands in their common dtype; a
    ``sorter`` is taken first, its entries bounds-checked."""
    right = op.side == "right"
    a_var, v_var = node.inputs[:2]
    dtype = torch_dtype(upcast(a_var.type.dtype, v_var.type.dtype))
    check = (_IndexCheck(node.inputs[2], a_var.type.shape[0], kw.get("bounds"))
             if len(node.inputs) == 3 else None)

    def searchsorted(a, v, *sorter):
        if check is not None:
            a = a.index_select(0, check(sorter[0], a.shape[0]))
        return torch.searchsorted(a.to(dtype).contiguous(), v.to(dtype).contiguous(),
                                  right=right)

    return searchsorted


def _check_range(check, idx, n, what):
    """Raise unless every entry of ``idx`` is in ``[0, n)``, as numpy's
    ``unravel_index`` and ``ravel_multi_index(mode="raise")`` do (the
    entries of a constant or an ``arange`` are known without a read)."""
    b = check.bounds(idx)
    if b is not None and (b[0] < 0 or b[1] >= n):
        raise ValueError(f"{what}: entry {b[0] if b[0] < 0 else b[1]} is out of bounds for "
                         f"size {n}")


@torch_funcify.register(UnravelIndex)
@ports(host=(1,), checked=(0,))
def _unravel_index(op, node=None, **kw):
    """The coordinates of each flat index in ``dims`` (a host value, read
    when the graph is linked where it is a constant); an index out of
    range raises, as in the numpy oracle."""
    check = _IndexCheck(node.inputs[0], None, kw.get("bounds"))
    c_order = op.order == "C"

    def unravel_index(indices, dims):
        d = [int(x) for x in dims.tolist()]
        _check_range(check, indices, int(np.prod(d)), "unravel_index")
        rem, out = indices.long(), [None] * len(d)
        for k in (reversed(range(len(d))) if c_order else range(len(d))):
            out[k] = torch.remainder(rem, d[k])
            rem = torch.div(rem, d[k], rounding_mode="floor")
        return out

    return unravel_index


def _ravel_checked(node):
    modes = node.op.mode if isinstance(node.op.mode, (list, tuple)) else [node.op.mode] * (
        len(node.inputs) - 1)
    return [k for k, m in enumerate(modes) if m == "raise"]


@torch_funcify.register(RavelMultiIndex)
@ports(host=lambda node: (len(node.inputs) - 1,), checked=_ravel_checked)
def _ravel_multi_index(op, node=None, **kw):
    """The flat index of each coordinate tuple in ``dims`` (a host value).
    ``mode="raise"`` raises on an entry out of bounds, as the numpy oracle
    does, where the JAX package's XLA path clips; its bounds check reads
    the entries back (a plan holding it runs eagerly) unless they are
    constants.  ``"wrap"`` and ``"clip"`` are numpy's."""
    n = len(node.inputs) - 1
    modes = list(op.mode) if isinstance(op.mode, (list, tuple)) else [op.mode] * n
    checks = [_IndexCheck(v, None, kw.get("bounds")) for v in node.inputs[:n]]
    c_order = op.order == "C"

    def ravel_multi_index(*inp):
        *multi, dims = inp
        d = [int(x) for x in dims.tolist()]
        strides = [int(np.prod(d[k + 1:] if c_order else d[:k])) for k in range(n)]
        out = None
        for k, (idx, mode) in enumerate(zip(multi, modes)):
            idx = idx.long()
            if mode == "raise":
                _check_range(checks[k], idx, d[k], "ravel_multi_index")
            elif mode == "wrap":
                idx = torch.remainder(idx, d[k])
            else:
                idx = idx.clamp(0, d[k] - 1)
            out = idx * strides[k] if out is None else out + idx * strides[k]
        return out

    return ravel_multi_index


@torch_funcify.register(Unique)
def _unique(op, node=None, **kw):
    raise NotImplementedError(
        "Unique has a data-dependent output shape and cannot be linked; its perform (the "
        "numpy oracle) runs it")


# --- einsum -----------------------------------------------------------------------

@torch_funcify.register(Einsum)
def _einsum(op, node=None, **kw):
    """The contraction order of ``einsum.contraction_path`` (numpy's optimal
    path), planned on the host once per input signature and run as
    one- and two-operand ``torch.einsum`` calls (cuBLAS products on a
    card, with TF32 off, as every product of the port); the operands in
    the output's dtype first, as ``jnp.einsum`` promotes.  The plans by
    input shapes are ``fn.paths``: ``(steps, flops)``."""
    in_specs, out_spec = op._parse(None)
    subscripts = ",".join(in_specs) + "->" + out_spec
    dtype = torch_dtype(node.outputs[0].type.dtype)
    paths: dict = {}

    def einsum(*operands):
        ops = [o if o.dtype == dtype else o.to(dtype) for o in operands]
        key = tuple(tuple(o.shape) for o in ops)
        if key not in paths:
            paths[key] = contraction_path(subscripts, key)
        for pos, spec in paths[key][0]:
            taken = [ops.pop(p) for p in pos]
            ops.append(torch.einsum(spec, *taken))
        return ops[0]

    einsum.paths = paths
    return einsum


# --- fft --------------------------------------------------------------------------
# torch.fft (cuFFT on a card), a complex spectrum packed as a trailing
# (real, imaginary) pair, as the JAX package packs it

@torch_funcify.register(RFFTOp)
def _rfft(op, node=None, **kw):
    dtype, norm = torch_dtype(node.outputs[0].type.dtype), op.norm

    def rfft(a):
        return torch.view_as_real(torch.fft.rfft(a.to(dtype), dim=-1, norm=norm))

    return rfft


@torch_funcify.register(IRFFTOp)
def _irfft(op, node=None, **kw):
    """The inverse of a packed half spectrum; like numpy's, the transform
    ignores the imaginary parts of the first bin (and of the last, for an
    even length)."""
    dtype, norm, n = torch_dtype(node.outputs[0].type.dtype), op.norm, op.n

    def irfft(a):
        a = a.to(dtype)
        return torch.fft.irfft(torch.complex(a[..., 0], a[..., 1]), n=n, dim=-1, norm=norm)

    return irfft


# --- signal -----------------------------------------------------------------------
# True convolutions: torch's conv1d and conv2d correlate, so the kernel is
# flipped, and padded by its length less one for "full" and "same" ("same"
# then takes numpy's centre, starting at (k - 1) // 2).  Floats go through
# cuDNN on a card (with TF32 off while a linked call runs, linker.py); other
# dtypes multiply and sum the windows of ``unfold``, which torch's
# convolutions do not take.

def _correlate1d(x, w, pad):
    """Cross-correlation of rows ``x`` (B, n) with kernels ``w`` (B, k),
    each row with its own kernel, padded by ``pad`` zeros at each end."""
    B, k = w.shape
    if x.dtype.is_floating_point:
        return torch.nn.functional.conv1d(x[None], w[:, None], padding=pad, groups=B)[0]
    xp = torch.nn.functional.pad(x, (pad, pad))
    return (xp.unfold(-1, k, 1) * w[:, None, :]).sum(-1)


@torch_funcify.register(Convolve1d)
@ports(batched=True)
def _convolve1d(op, node=None, **kw):
    """``np.convolve`` of the last axes, over broadcast batch dimensions in
    one call (a grouped convolution, a kernel a row): the longer operand is
    the signal, as numpy swaps them."""
    mode, dtype = op.mode, torch_dtype(node.outputs[0].type.dtype)

    def convolve1d(a, v):
        a, v = a.to(dtype), v.to(dtype)
        if v.shape[-1] > a.shape[-1]:
            a, v = v, a
        n, k = a.shape[-1], v.shape[-1]
        batch = tuple(torch.broadcast_shapes(a.shape[:-1], v.shape[:-1]))
        rows = a.expand(*batch, n).reshape(-1, n)
        kern = v.expand(*batch, k).reshape(-1, k).flip(-1)
        out = _correlate1d(rows, kern, 0 if mode == "valid" else k - 1)
        if mode == "same":
            out = out[:, (k - 1) // 2:(k - 1) // 2 + n]
        return out.reshape(*batch, out.shape[-1])

    return convolve1d


@torch_funcify.register(Convolve2d)
def _convolve2d(op, node=None, **kw):
    """``scipy.signal.convolve2d`` with zero fill: "valid" takes the larger
    operand as the signal where scipy swaps them, "same" has the first
    operand's shape."""
    mode, dtype = op.mode, torch_dtype(node.outputs[0].type.dtype)

    def convolve2d(a, v):
        a, v = a.to(dtype), v.to(dtype)
        if mode == "valid":
            if all(p <= q for p, q in zip(a.shape, v.shape)) and a.shape != v.shape:
                a, v = v, a
            elif not all(p >= q for p, q in zip(a.shape, v.shape)):
                raise ValueError("For 'valid' mode, one must be at least as large as the other "
                                 "in every dimension")
        (m, n), (kr, kc) = a.shape, v.shape
        pad = (0, 0) if mode == "valid" else (kr - 1, kc - 1)
        w = v.flip(0, 1)
        if a.dtype.is_floating_point:
            out = torch.nn.functional.conv2d(a[None, None], w[None, None], padding=pad)[0, 0]
        else:
            ap = torch.nn.functional.pad(a, (pad[1], pad[1], pad[0], pad[0]))
            out = (ap.unfold(0, kr, 1).unfold(1, kc, 1) * w).sum((-2, -1))
        if mode == "same":
            r0, c0 = (kr - 1) // 2, (kc - 1) // 2
            out = out[r0:r0 + m, c0:c0 + n]
        return out

    return convolve2d


# --- linalg -----------------------------------------------------------------------
# torch.linalg, which runs cuSOLVER and cuBLAS on a card, as the JAX
# package's lowerings run jnp.linalg and jax.scipy.linalg
# (pytensor_tpu/tensor/linalg.py:914-1037, 1366-1373).  Each lowering takes
# leading batch dimensions and broadcasts them (``batched``): a Blockwise of
# the op is one call.  Operands are cast to the output dtype first (an
# integer matrix is factorised in float64, ``upcast_float``).  None of these
# reads the device on the host, but the three that declare ``reads_back``:
# torch's eigh, svd and matrix_exp synchronise, and a CUDA graph refuses them.

def _cast_to(node):
    dtype = torch_dtype(node.outputs[0].type.dtype)
    return lambda *xs: [x if x.dtype == dtype else x.to(dtype) for x in xs]


def _cholesky_lower(x, masks):
    """The lower factor of the lower triangle of ``x``, NaN in the lower
    triangle of each matrix that is not positive definite, as XLA's
    Cholesky gives (a raise would read ``info`` on the host every call).
    ``masks`` caches the lower-triangle masks by size and device."""
    L, info = torch.linalg.cholesky_ex(x)
    key = (x.shape[-1], x.device)
    if key not in masks:
        masks[key] = torch.ones(key[0], key[0], dtype=torch.bool, device=x.device).tril_()
    return L.masked_fill((info != 0)[..., None, None] & masks[key], float("nan"))


def _trsm(a, b, lower, unit=False):
    """``a^-1 b`` for triangular ``a`` (cuBLAS trsm), reading one triangle."""
    return torch.linalg.solve_triangular(a, b, upper=not lower, unitriangular=unit)


def _cho_solve(c, b, lower):
    """``(c c^T)^-1 b`` as two triangular solves, as ``jax.scipy``'s
    ``cho_solve`` computes it (torch's ``cholesky_solve`` takes MAGMA for a
    batch, which a CUDA graph does not capture)."""
    if lower:
        return _trsm(c.mT, _trsm(c, b, True), False)
    return _trsm(c, _trsm(c.mT, b, True), False)


def _as_matrix(b_ndim, fn):
    """``fn`` of a right-hand side of ``b_ndim`` core dimensions: a vector
    is solved as one column."""
    if b_ndim == 2:
        return fn
    return lambda a, b: fn(a, b.unsqueeze(-1)).squeeze(-1)


@torch_funcify.register(Cholesky)
@ports(batched=True)
def _cholesky(op, node=None, **kw):
    cast = _cast_to(node)
    masks: dict = {}

    def cholesky(x):
        L = _cholesky_lower(*cast(x), masks)
        return L if op.lower else L.mT

    return cholesky


@torch_funcify.register(SolveTriangular)
@ports(batched=True)
def _solve_triangular(op, node=None, **kw):
    """``trans`` transposes ``a``, as the oracle's ``scipy`` call does
    (``solve_triangular()`` never makes such a node: it transposes ``a`` in
    the graph)."""
    cast = _cast_to(node)
    trans = op.trans in (1, 2, "T", "C")
    lower = op.lower != trans
    solve = _as_matrix(op.b_ndim, lambda a, b: _trsm(a.mT if trans else a, b, lower,
                                                     op.unit_diagonal))
    return lambda a, b: solve(*cast(a, b))


@torch_funcify.register(CholeskySolve)
@ports(batched=True)
def _cholesky_solve(op, node=None, **kw):
    cast = _cast_to(node)
    solve = _as_matrix(op.b_ndim, lambda c, b: _cho_solve(c, b, op.lower))
    return lambda c, b: solve(*cast(c, b))


@torch_funcify.register(Solve)
@ports(batched=True)
def _solve(op, node=None, **kw):
    """``assume_a="pos"`` is a Cholesky factorisation of the symmetric part
    of ``a`` (``jnp.linalg.cholesky``'s default) and two triangular solves,
    as in the JAX package; any other is an LU solve."""
    cast = _cast_to(node)
    masks: dict = {}
    if op.assume_a == "pos":
        solve = _as_matrix(op.b_ndim, lambda a, b: _cho_solve(
            _cholesky_lower((a + a.mT) / 2, masks), b, True))
    else:
        solve = _as_matrix(op.b_ndim, lambda a, b: torch.linalg.solve_ex(a, b)[0])
    return lambda a, b: solve(*cast(a, b))


@torch_funcify.register(MatrixInverse)
@ports(batched=True)
def _matrix_inverse(op, node=None, **kw):
    cast = _cast_to(node)
    return lambda x: torch.linalg.inv_ex(*cast(x))[0]


@torch_funcify.register(Det)
@ports(batched=True)
def _det(op, node=None, **kw):
    cast = _cast_to(node)
    return lambda x: torch.linalg.det(*cast(x))


@torch_funcify.register(SLogDet)
@ports(batched=True)
def _slogdet(op, node=None, **kw):
    cast = _cast_to(node)
    return lambda x: list(torch.linalg.slogdet(*cast(x)))


@torch_funcify.register(Eigh)
@ports(batched=True, reads_back="torch's eigh synchronises (cuSOLVER syevd)")
def _eigh(op, node=None, **kw):
    cast = _cast_to(node)
    return lambda x: list(torch.linalg.eigh(*cast(x), UPLO=op.UPLO))


@torch_funcify.register(QR)
@ports(batched=True)
def _qr(op, node=None, **kw):
    if op.mode not in ("reduced", "complete", "r", "raw"):
        raise NotImplementedError(f"torch lowering of QR(mode={op.mode!r})")
    cast = _cast_to(node)
    if op.mode == "raw":
        # numpy's (h, tau): LAPACK's geqrf, h in Fortran order, so the
        # transpose of torch's; shapes (n, m) and (k,), whatever the
        # graph's types say (the JAX package's make_node types them as the
        # complete mode's, pytensor_tpu/tensor/linalg.py:555-562)
        def qr_raw(x):
            a, tau = torch.geqrf(*cast(x))
            return [a.transpose(-1, -2), tau]

        return qr_raw

    def qr(x):
        q, r = torch.linalg.qr(*cast(x), mode=op.mode)
        return r if op.mode == "r" else [q, r]

    return qr


@torch_funcify.register(SVD)
@ports(batched=True, reads_back="torch's svd synchronises (cuSOLVER gesvd)")
def _svd(op, node=None, **kw):
    cast = _cast_to(node)
    if not op.compute_uv:
        return lambda x: torch.linalg.svdvals(*cast(x))
    return lambda x: list(torch.linalg.svd(*cast(x), full_matrices=op.full_matrices))


@torch_funcify.register(Lu)
@ports(batched=True)
def _lu(op, node=None, **kw):
    """``A = P L U``, the convention of ``scipy.linalg.lu``."""
    cast = _cast_to(node)

    def lu(x):
        p, l, u = torch.linalg.lu(*cast(x))
        return [p @ l, u] if op.permute_l else [p, l, u]

    return lu


@torch_funcify.register(Expm)
@ports(batched=True, reads_back="torch's matrix_exp copies a value from the host")
def _expm(op, node=None, **kw):
    cast = _cast_to(node)
    return lambda x: torch.linalg.matrix_exp(*cast(x))


@torch_funcify.register(TridiagonalSolve)
@ports(batched=True)
def _tridiagonal_solve(op, node=None, **kw):
    """The dense tridiagonal matrix's LU solve (torch has no ``gtsv``; XLA's
    ``tridiagonal_solve`` is the Thomas algorithm): ``dl[0]`` and ``du[-1]``
    are ignored, as in ``lax.linalg``."""
    cast = _cast_to(node)

    def tridiagonal_solve(dl, d, du, b):
        dl, d, du, b = cast(dl, d, du, b)
        a = (torch.diag_embed(d) + torch.diag_embed(du[..., :-1], 1)
             + torch.diag_embed(dl[..., 1:], -1))
        solve = _as_matrix(op.b_ndim, lambda a, b: torch.linalg.solve_ex(a, b)[0])
        return solve(a, b)

    return tridiagonal_solve


# --- blockwise ------------------------------------------------------------------

def _core_node(node):
    """The core op's node on inputs of the core types.  An input with no
    batch dimensions, or with broadcast ones added by a DimShuffle (the
    padding of ``Blockwise.make_node``), is the core variable itself, and
    a constant whose batch dimensions are all 1 is the constant of its
    core, so that the core lowering sees what it is (a constant, an
    ``arange``) and checks a constant index when it is linked, as the
    capture rule (``linker.py _host_reads``) takes it to."""
    from pytensor_tpu_torch.tensor.basic import constant

    op = node.op

    def core(i, c):
        nb = i.type.ndim - c
        if nb and all(s == 1 for s in i.type.shape[:nb]) and i.owner is not None \
                and isinstance(i.owner.op, DimShuffle) \
                and i.owner.op.new_order == ("x",) * nb + tuple(range(c)):
            i = i.owner.inputs[0]
        if nb and isinstance(i, Constant) and all(s == 1 for s in np.shape(i.data)[:nb]):
            return constant(np.asarray(i.data).reshape(np.shape(i.data)[nb:]),
                            dtype=i.type.dtype)
        if i.type.ndim == c:
            return i
        return TensorType(i.type.dtype, i.type.shape[i.type.ndim - c:] if c else ())()

    return op.core_op.make_node(*[core(i, c) for i, c in zip(node.inputs, op._core_ndims()[0])])


def _core_ports(kind):
    """A Blockwise reads on the host what its core lowering reads."""
    return lambda node: ports_of(_core_node(node), kind)


def _scatter_index(node):
    """A Blockwise of ``IncSubtensor`` by one integer index of the core's
    first axis (a row of a vectorized ``jacobian``): one scatter of the
    whole batch, its index read on the device (``_batched_inc_subtensor``)."""
    core = node.op.core_op
    return (isinstance(core, IncSubtensor) and tuple(core.idx_list) == (DYN,)
            and len(node.inputs) == 3)


def _blockwise_host(node):
    return () if _scatter_index(node) else _core_ports("host")(node)


def _batched_inc_subtensor(op, node):
    """``x[b][i[b]] (+)= y[b]`` for every element b of the batch, as one
    advanced-index write with nothing read back: a negative index counts
    from the end, and the update of an index still out of range is dropped,
    as the JAX package's ``x.at[i]`` scatter drops it (the numpy oracle
    raises)."""
    set_mode = op.core_op.set_instead_of_inc
    cx = node.inputs[0].type.ndim - node.inputs[2].type.ndim
    cy = node.inputs[1].type.ndim - node.inputs[2].type.ndim
    dtype = torch_dtype(node.outputs[0].type.dtype)

    def scatter(x, y, i):
        core, ycore = tuple(x.shape[x.ndim - cx:]), tuple(y.shape[y.ndim - cy:])
        batch = tuple(torch.broadcast_shapes(x.shape[:x.ndim - cx], y.shape[:y.ndim - cy],
                                             i.shape))
        n = int(np.prod(batch))
        out = x.to(dtype).expand(batch + core).reshape((n,) + core).clone()
        idx = i.expand(batch).reshape(-1)
        idx = torch.where(idx < 0, idx + core[0], idx)
        keep = ((idx >= 0) & (idx < core[0])).reshape((n,) + (1,) * (len(core) - 1))
        idx = idx.clamp(0, core[0] - 1)
        rows = torch.arange(n, device=out.device)
        # y's core broadcast against the row: (n,), 1s, then its own axes
        vals = y.to(dtype).expand(batch + ycore).reshape(
            (n,) + (1,) * (len(core) - 1 - len(ycore)) + ycore)
        if set_mode:
            # a dropped row is written with its own value
            out[rows, idx] = torch.where(keep, vals, out[rows, idx])
        else:
            out[rows, idx] += torch.where(keep, vals, torch.zeros((), dtype=dtype,
                                                                  device=out.device))
        return out.reshape(batch + core)

    return scatter


@torch_funcify.register(Blockwise)
@ports(host=_blockwise_host, checked=_core_ports("checked"),
       scalar=_core_ports("scalar"), reads_back=_core_ports("reads_back"))
def _blockwise(op, node=None, device=None, **kw):
    """The core lowering over the broadcast batch dimensions
    (``pytensor_tpu/link/xla/dispatch.py:870``, ``jax.vmap`` of the core
    lowering).  An input whose batch dimensions are all 1 stays unbatched:
    it is cut to its core and given whole to every batch element.  A core
    lowering that declares ``batched`` (``ports``: the linalg lowerings, a
    ``Dot`` of 2-d cores) takes the batch itself in one call, as XLA
    batches a custom call under ``vmap``; any other runs once for each
    element of the flattened batch.  A Blockwise of ``IncSubtensor`` by one
    integer index is one scatter (``_batched_inc_subtensor``)."""
    if _scatter_index(node):
        return _batched_inc_subtensor(op, node)
    in_core, _ = op._core_ndims()
    core_fn = torch_funcify(op.core_op, node=_core_node(node), device=device)
    batched = ports_of(node, "batched", op=op.core_op)
    out_types = node.outputs

    def blockwise(*args):
        batch_shapes = [tuple(a.shape[: a.ndim - c]) for a, c in zip(args, in_core)]
        batch = tuple(torch.broadcast_shapes(*batch_shapes))
        invariant = [all(d == 1 for d in bs) for bs in batch_shapes]
        args = [a.reshape(a.shape[len(bs):]) if inv and bs else a
                for a, bs, inv in zip(args, batch_shapes, invariant)]
        if all(invariant):
            res = core_fn(*args)
            res = res if isinstance(res, (list, tuple)) else (res,)
            res = [r.reshape(batch + tuple(r.shape)) for r in res]
        elif batched:
            res = core_fn(*args)
            res = res if isinstance(res, (list, tuple)) else (res,)
        else:
            n = int(np.prod(batch))
            flat = [a if inv else a.expand(batch + tuple(a.shape[a.ndim - c:])).reshape(
                (n,) + tuple(a.shape[a.ndim - c:]))
                for a, c, inv in zip(args, in_core, invariant)]
            rows = []
            for b in range(n):
                r = core_fn(*[a if inv else a[b] for a, inv in zip(flat, invariant)])
                rows.append(r if isinstance(r, (list, tuple)) else (r,))
            if rows:
                res = [torch.stack(col).reshape(batch + tuple(col[0].shape))
                       for col in zip(*rows)]
            else:
                res = [torch.empty(batch + tuple(s or 0 for s in o.type.shape[len(batch):]),
                                   dtype=torch_dtype(o.type.dtype), device=args[0].device)
                       for o in out_types]
        return res[0] if len(res) == 1 else res

    return blockwise


# --- scan -----------------------------------------------------------------------

def _takes_kernel(op, node):
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda.scan_kernel import scan_kernel_eligible

    return config.scan__pallas and scan_kernel_eligible(op, node)


def _non_seq_ports(node):
    """The step loop hands its non-sequences to its inner plan as they are."""
    op = node.op
    if _takes_kernel(op, node):
        return ()
    return range(len(node.inputs) - op.info.n_non_seqs, len(node.inputs))


def _reads_condition(node):
    if node.op.info.as_while:
        return "a while-scan reads its condition on the host after each step"
    return ""


@torch_funcify.register(Scan)
@ports(host=(0,), keeps_host=_non_seq_ports, reads_back=_reads_condition)
def _scan(op, node=None, device=None, host=frozenset(), checks=None, **kw):
    """The loop below, or with ``config.scan__pallas`` and an eligible
    scan the whole-loop kernel K2 (the rule of
    ``pytensor_tpu/scan/op.py:801-806``); K2's wrapper runs this loop on
    CPU tensors and the kernel on CUDA tensors, never the loop in its place.
    ``host`` holds the variables of the outer plan that are host values.
    A while-scan reads its condition back after each step, so a plan that
    holds one runs eagerly (``reads_back``)."""
    from pytensor_tpu_torch.link.cuda.scan_kernel import ScanKernel

    if _takes_kernel(op, node):
        return ScanKernel(op, node, device)
    return scan_loop(op, device, node, host, checks)


def scan_loop(op, device, node=None, host=frozenset(), checks=None):
    """A scan as a torch step loop over the inner graph linked for
    ``device`` (counterpart of ``pytensor_tpu/scan/op.py:817-946``); the
    plain version of K2.  Returns ``loop(n_steps, *outer)``, which gives
    the traces of the states, the final untraced states and the nit-sot
    traces, in that order, and a while-scan's ``steps_done`` last;
    ``loop.inner`` is the inner plan.

    A while-scan (the counterpart of the JAX package's ``lax.while_loop``
    lowering, ``pytensor_tpu/scan/op.py:876-946``) reads each step's
    condition with ``bool()`` (one wait on the device a step), stops after
    the step at which it holds, or at ``n_steps``, and pads its traces
    with zero rows to ``(n_steps, *core)``.  ``steps_done`` is the
    count of steps run, a 0-d int64 tensor on the CPU: the loop knows it
    without a read, and ``TruncateToDone`` and the gradient's reverse scan
    take it as a host integer.  Left out: a loop that reads the condition
    less often (a chunk of steps run ahead and masked; ROADMAP.md, item 4's
    note).

    Given the ``node`` and the outer plan's ``host`` values, a non-sequence
    that is a host value stays one in the inner plan, and a constant
    non-sequence is linked into the inner plan as that constant, as the
    JAX package's loop body closes over static values: a shape, a step
    count or an index that the rewrites hoisted out of the loop is then
    read on the host, with no read of the device.  ``checks`` is the outer
    plan's ``Checks`` (``linker.py``): a ``CheckAndRaise`` of the step
    ORs each step's result into its slot."""
    from pytensor_tpu_torch.graph.replace import clone_replace
    from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch

    info = op.info
    fgraph, host_inputs = op.fgraph, ()
    if node is not None:
        first = len(fgraph.inputs) - info.n_non_seqs
        pairs = list(zip(op.inner_non_seq_vars(), op.outer_non_seqs(node.inputs)))
        consts = {i: o for i, o in pairs if isinstance(o, Constant)}
        host_inputs = [first + k for k, (_, o) in enumerate(pairs) if o in host]
        if consts:
            fgraph = FunctionGraph(fgraph.inputs, clone_replace(fgraph.outputs, consts),
                                   clone=True)
    inner = fgraph_to_torch(fgraph, device, trust_input=True, host_inputs=host_inputs,
                            checks=checks)
    n_seqs, n_states, n_unt, n_nit = info.n_seqs, info.n_states, info.n_untraced, info.n_nit_sot
    depth = [-min(taps) for taps in info.taps]
    single = [m == 1 and len(taps) == 1 for m, taps in zip(depth, info.taps)]
    nit_types = [o.type for o in op.inner_nit_sot_outs()]

    def steps(T, outer):
        """The inner plan's outputs, a step at a time, for at most ``T``
        steps."""
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
        for t in range(T):
            args = [s[t] for s in seqs]
            for k, taps in enumerate(info.taps):
                args.extend(hist[k][depth[k] + tap] for tap in taps)
            res = inner(*args, *untraced, *non_seqs)
            for k in range(n_states):
                hist[k] = hist[k][1:] + [res[k]]
            untraced = list(res[n_states: n_states + n_unt])
            yield res

    def empty(k, outer):
        """Output ``k``'s trace of no step (a state's, then a nit-sot's)."""
        if k < n_states:
            init = outer[n_seqs + k]
            core = init.shape if single[k] else init.shape[1:]
            return torch.empty((0, *core), dtype=init.dtype, device=device)
        ty = nit_types[k - n_states]
        return torch.empty((0, *(s or 0 for s in ty.shape)), dtype=torch_dtype(ty.dtype),
                           device=device)

    def loop(n_steps, *outer):
        T = int(n_steps)
        untraced = list(outer[n_seqs + n_states: n_seqs + n_states + n_unt])
        rows = [[] for _ in range(n_states + n_nit)]
        t = 0
        for res in steps(T, outer):
            untraced = list(res[n_states: n_states + n_unt])
            # (a while-scan's condition, its last output, makes no row)
            for r, row in zip(rows, res[:n_states] + res[n_states + n_unt:]):
                r.append(row)
            t += 1
            if info.as_while and bool(res[-1]):
                break
        out = [torch.stack(r) if r else empty(k, outer) for k, r in enumerate(rows)]
        if not info.as_while:
            return out[:n_states] + untraced + out[n_states:]
        # the traces are (n_steps, *core), zero past the exit step
        out = [torch.cat([o, o.new_zeros((T - t, *o.shape[1:]))]) if t < T else o for o in out]
        return out[:n_states] + untraced + out[n_states:] + [torch.tensor(t, dtype=torch.int64)]

    loop.inner = inner
    return loop


# --- while-scan traces --------------------------------------------------------------

@torch_funcify.register(TruncateToDone)
@ports(host=(1,))
def _truncate_to_done(op, node=None, **kw):
    """The executed prefix, a view; ``steps_done`` is the while-scan's
    host integer."""
    def truncate_to_done(trace, steps_done):
        return trace[: int(steps_done)]

    return truncate_to_done


@torch_funcify.register(PadTraceGrad)
def _pad_trace_grad(op, node=None, **kw):
    def pad_trace_grad(g, like, steps_done):
        out = torch.zeros_like(like)
        out[: g.shape[0]] = g
        return out

    return pad_trace_grad


# the lowerings of tensor/optimize.py's ops (BFGS and Newton), in a module
# of their own
import pytensor_tpu_torch.link.torch.optimize  # noqa: E402,F401

# the lowerings of tensor/random (RandomVariable and the key ops)
import pytensor_tpu_torch.link.torch.random  # noqa: E402,F401

# the lowerings of the sparse ops (sparse/{basic,structured,linalg,compat,spmv}.py)
import pytensor_tpu_torch.link.torch.sparse  # noqa: E402,F401

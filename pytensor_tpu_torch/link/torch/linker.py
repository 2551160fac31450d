"""The torch linker: a rewritten FunctionGraph as an eager plan, and on a
CUDA device as one CUDA graph per input signature.

``fgraph_to_torch`` is the counterpart of
``pytensor_tpu/link/xla/linker.py:44 fgraph_to_jax``: it returns a
``Plan``, which runs each node's torch lowering in topological order,
eagerly, on an explicit device.  Fused elementwise chains and, with
``config.scan__pallas``, eligible scans are hand-written kernels;
everything else is a torch op.  For a CUDA device the fused elementwise
kernels (K1) of the whole graph are built when it is linked, in one nvcc
call (``tensor/fused_kernel.py build``).

``TorchLinker.make_torch_fn`` is the counterpart of ``XlaLinker.make_jax_fn``
(``pytensor_tpu/link/xla/linker.py:255-310``), which wraps the traced
function in ``jax.jit``: on a CUDA device, with ``config.xla__jit`` on
and a plan that may be captured, it returns a ``CapturedFunction``, which
captures one call of the plan into a ``torch.cuda.CUDAGraph`` for each
input signature and replays it.

Graph constants move to the device once, at link time, with their dtype
kept; a sparse constant (a scipy matrix) becomes its canonical CSR triple
(``convert.py sparse_as_torch``).  Shape values stay on the host: the
outputs of ``Shape`` and ``Shape_i``, the arithmetic on them, and the
constants that feed a reshape, a shape check or a basic index, so that
the run never waits on the device to learn a shape.  Matrix products
and convolutions run in full float32, bfloat16 products accumulate in
float32, and factorisations run in cuSOLVER: a plan linked for a CUDA
device turns TF32 off for matmuls and cuDNN, turns cuBLAS's
reduced-precision bfloat16 reductions off (unless ``config.matmul_precision``
asks for them) and makes cuSOLVER torch's linalg library while it runs,
and puts the four settings back when it returns.  ``PyLinker`` is the
``"py"`` linker: the eager plan, never captured.

Each intermediate is freed after its last reader, by free lists made at
link time (the rule of the oracle linker's ``allow_gc``,
``pytensor_tpu/link/basic.py:131-151``, always on): inputs, constants and
outputs are never freed.
"""

from __future__ import annotations

import time

import torch

from pytensor_tpu_torch.config import config, matmul_settings
from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.link.basic import raise_with_op
from pytensor_tpu_torch.link.cuda import (
    binomial_kernel,
    gamma_kernel,
    poisson_kernel,
    scan_kernel,
    spmv_kernel,
    threefry_kernel,
)
from pytensor_tpu_torch.link.torch.convert import (
    CSR,
    as_torch,
    held,
    resolve_device,
    sparse_as_torch,
    torch_dtype,
)
from pytensor_tpu_torch.link.torch.dispatch import arange_index, ports_of, torch_funcify
from pytensor_tpu_torch.sparse.type import SparseTensorType
from pytensor_tpu_torch.tensor import fused_kernel
from pytensor_tpu_torch.tensor.basic import MakeVector
from pytensor_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise
from pytensor_tpu_torch.tensor.shape import Shape, Shape_i
from pytensor_tpu_torch.tensor.subtensor import Subtensor
from pytensor_tpu_torch.tensor.type import TensorType

# ops that compute on the host when every non-constant input is host
_HOST_CAPABLE = (Elemwise, DimShuffle, MakeVector, CAReduce, Subtensor)
# the kernel wrappers a linked function launches (K1, K2, K4, threefry and
# the loop samplers' gamma, Poisson and binomial kernels); each counts its
# launches in LAUNCHES
_KERNELS = (fused_kernel, scan_kernel, spmv_kernel, threefry_kernel, gamma_kernel,
            poisson_kernel, binomial_kernel)

# nodes run by plans since the count was last set to 0 (a scan's step
# loop runs its inner plan's nodes once a step)
NODES_RUN = 0


def _takes_host_scalar(node, k, var) -> bool:
    """Does the lowering take the host value ``var`` at input ``k`` as a
    scalar argument: a value of one element (by its static shape) at a port
    that the lowering declares ``scalar`` (``dispatch.py ports``)."""
    return all(s == 1 for s in var.type.shape) and k in ports_of(node, "scalar")


def _host_variables(order, host_inputs=()) -> set:
    """The values computed on the host: shapes, and what the host-capable
    ops compute from them and constants.  A host-capable op of constants
    alone (a graph no rewrite folded, such as a nested scan's body) runs on
    the host where a host port reads what it computes, and on the device
    otherwise."""
    wanted: set = set()
    for node in reversed(order):
        wanted.update(node.inputs[k] for k in ports_of(node, "host"))
        if isinstance(node.op, _HOST_CAPABLE) and any(o in wanted for o in node.outputs):
            wanted.update(node.inputs)
    host: set = set(host_inputs)
    for node in order:
        if isinstance(node.op, (Shape, Shape_i)):
            host.update(node.outputs)
        elif (isinstance(node.op, _HOST_CAPABLE)
              and all(i in host or isinstance(i, Constant) for i in node.inputs)
              and (any(i in host for i in node.inputs)
                   or any(o in wanted for o in node.outputs))):
            host.update(node.outputs)
    return host


def _free_lists(order, fgraph) -> list:
    """For each node, the variables whose last reader it is: never an
    input, a constant or an output (nor an output a later node reads)."""
    keep = set(fgraph.inputs) | set(fgraph.outputs)
    last: dict = {}
    for k, node in enumerate(order):
        for i in node.inputs:
            if not isinstance(i, Constant) and i not in keep:
                last[i] = k
    free = [[] for _ in order]
    for var, k in last.items():
        free[k].append(var)
    return [tuple(f) for f in free]


def _host_reads(steps, host) -> list:
    """The capture rule: why a plan may not be captured into a CUDA graph,
    one line for each node that must move a value between the device and
    the host at run time (a capture records the device's work only, and
    refuses a synchronising copy); empty when it may be captured.  Decided
    from the plan, at link time.

    - a port read on the host (a lowering's ``host`` ports,
      ``dispatch.py ports``: ``Reshape``'s ``shp.tolist()``, ``int()`` of
      ``SpecifyShape``'s, ``Alloc``'s and a basic index's entries, a scan's
      ``int(n_steps)``) fed by a device
      value: an explicit input or a value computed on the device, where
      the JAX package would make the input a static argument
      (``pytensor_tpu/link/xla/linker.py:194-231``);
    - a bounds check (``_IndexCheck``, the ``checked`` ports) of an index
      that is neither a constant nor an ``arange`` of constant start and
      step (``dispatch.py arange_index``, bounded by its size):
      ``idx.min()``/``idx.max()``.  The port raises on an index out of
      bounds where the XLA path clamps, and keeps that;
    - a host value at any other port of a node that runs on the device,
      which torch copies to the device (``MakeVector``'s ``.to(device)``);
      a lowering's ``scalar`` ports (an ``Elemwise``'s, K1's, the blas
      ops' alpha and beta) take a one-element host value as a scalar
      argument instead (``_takes_host_scalar``);
    - a lowering that reads the device on the host (``reads_back``:
      ``Nonzero``'s output size; ``Eigh``, ``SVD`` and ``Expm``, whose
      torch routines synchronise);
    - the same in the inner plan of a scan that runs as the step loop,
      which takes the host values and constants among the scan's
      non-sequences as host values and constants (``keeps_host``).

    These are the run-time host reads of ``dispatch.py`` and the kernel
    wrappers (``.item()``, ``int()``, ``.tolist()``, ``.cpu()`` of a run-time
    value): ``_specify_shape``, ``_reshape``, ``_alloc``, ``_basic_index``
    and ``_adv_index``'s slice bounds, ``_IndexCheck``, ``scan_loop``'s and
    K2's ``int(n_steps)``.  The sparse lowerings read nothing back
    (``_csr_rows`` gives ``repeat_interleave`` its output size, and
    ``Transpose`` counts columns by ``scatter_add_``, not ``bincount``).
    Host values themselves (``_host_variables``) depend only on the
    shapes of the inputs, which the signature of a capture fixes.
    """
    reads = []
    for fn, node, _, _ in steps:
        if any(o in host for o in node.outputs):
            continue  # computed on the host from host values and constants
        ports, checked = ports_of(node, "host"), ports_of(node, "checked")
        keeps = ports_of(node, "keeps_host")
        why = ports_of(node, "reads_back")
        if why:
            reads.append(f"{node}: {why}")
        for k, i in enumerate(node.inputs):
            if isinstance(i, Constant):
                continue
            if k in ports and i not in host:
                reads.append(f"{node}: input {k} is read on the host and lives on the device")
            elif k in checked and arange_index(i) is None:
                reads.append(f"{node}: the bounds check of index input {k} reads its min and "
                             "max on the host")
            elif (k not in ports and k not in keeps and i in host
                  and not _takes_host_scalar(node, k, i)):
                reads.append(f"{node}: input {k} is a host value copied to the device")
        inner = getattr(fn, "inner", None)  # dispatch.py scan_loop's inner plan
        if inner is not None:
            reads += [f"{node}, a step: {r}" for r in inner.host_reads]
    return reads


class Plan:
    """``fgraph_to_torch``'s callable: ``plan(*inputs)`` returns a tuple of
    tensors.

    ``steps`` holds, for each node in topological order, its lowering, the
    node, its arguments (a constant's value or the variable to read) and
    its free list.  ``host_reads`` is the capture rule's verdict
    (``_host_reads``), ``capturable`` whether it is empty.  ``timer``,
    when set, times each node of a run (``PyLinker``'s profiles).
    """

    def __init__(self, fgraph, device, steps, outputs, host_reads, trust_input):
        self.fgraph = fgraph
        self.device = device
        self.steps = steps
        self.inputs = list(fgraph.inputs)
        self.outputs = outputs
        self.host_reads = host_reads
        self.trust_input = trust_input
        # times each node when set (compile/debug/profiling.py NodeTimer)
        self.timer = None

    @property
    def capturable(self):
        return not self.host_reads

    @property
    def free_lists(self):
        return [free for _, _, _, free in self.steps]

    def __call__(self, *args):
        if len(args) != len(self.inputs):
            raise TypeError(f"expected {len(self.inputs)} inputs, got {len(args)}")
        if not self.trust_input:
            args = self.convert(args)
        return self.execute(args)

    def convert(self, args):
        """The inputs checked for device, dtype and shape, numpy values
        (and scipy matrices, for sparse inputs) converted."""
        return [self._convert(var, value) for var, value in zip(self.inputs, args)]

    def _convert(self, var, value):
        device = self.device
        if isinstance(var.type, SparseTensorType):
            return sparse_as_torch(var.type.filter(value), device)
        if isinstance(value, torch.Tensor):
            value = held(value, var.type.dtype)
            if value.device != device:
                raise ValueError(f"input {var} is on {value.device}, the function on {device}")
            if value.dtype != torch_dtype(var.type.dtype):
                raise TypeError(f"input {var} has dtype {value.dtype}, expected {var.type.dtype}")
            if value.ndim != var.type.ndim or any(
                    s is not None and s != d for s, d in zip(var.type.shape, value.shape)):
                raise TypeError(f"input {var} has shape {tuple(value.shape)}, "
                                f"expected {var.type}")
            return value
        return as_torch(var.type.filter(value), device)

    def execute(self, args):
        """Run the plan on inputs already converted."""
        if self.device.type != "cuda":
            return self.run(args)
        # full float32 matmuls, as the float32 tests and the JAX package
        # expect; bfloat16 products that accumulate in float32 and round
        # once, as XLA's do (torch lets cuBLAS reduce split sums in
        # bfloat16 by default); and cuSOLVER for the factorisations: torch
        # takes MAGMA for a batch of LU factorisations by default, which
        # synchronises and a CUDA graph refuses; and full float32
        # convolutions (cuDNN takes TF32 by default).  The caller's settings
        # are restored on return.
        # ``config.matmul_precision`` may allow TF32 and bfloat16 reductions
        # (``config.matmul_settings``), read when the plan runs.
        matmul, cuda, cudnn = torch.backends.cuda.matmul, torch.backends.cuda, torch.backends.cudnn
        prev = (matmul.allow_tf32, matmul.allow_bf16_reduced_precision_reduction,
                cuda.preferred_linalg_library(), cudnn.allow_tf32)
        tf32, bf16_reduced = matmul_settings()
        matmul.allow_tf32 = tf32
        matmul.allow_bf16_reduced_precision_reduction = bf16_reduced
        cuda.preferred_linalg_library("cusolver")
        cudnn.allow_tf32 = tf32
        try:
            return self.run(args)
        finally:
            matmul.allow_tf32 = prev[0]
            matmul.allow_bf16_reduced_precision_reduction = prev[1]
            cuda.preferred_linalg_library(prev[2])
            cudnn.allow_tf32 = prev[3]

    def run(self, args):
        global NODES_RUN
        NODES_RUN += len(self.steps)
        storage = dict(zip(self.inputs, args))
        timer = self.timer
        for fn, node, spec, free in self.steps:
            vals = [v if kind == "const" else storage[v] for kind, v in spec]
            try:
                if timer is None:
                    res = fn(*vals)
                else:
                    mark = timer.start()
                    res = fn(*vals)
                    timer.stop(node, mark)
            except Exception:
                raise_with_op(self.fgraph, node)
            if isinstance(res, (list, tuple)):
                storage.update(zip(node.outputs, res))
            else:
                storage[node.outputs[0]] = res
            for var in free:
                del storage[var]
        return tuple(v if kind == "const" else storage[v] for kind, v in self.outputs)


def fgraph_to_torch(fgraph: FunctionGraph, device, trust_input: bool = False,
                    host_inputs=()) -> Plan:
    """The eager plan of ``fgraph`` on ``device``: each node's torch
    lowering in topological order.

    Inputs are checked for device, dtype and shape, and numpy values
    (and scipy matrices, for sparse inputs) converted, unless
    ``trust_input``: then they are taken as they are.  The inputs at the
    positions ``host_inputs`` are host values (a scan's step loop gives
    its inner plan the host values of the outer one).
    """
    device = resolve_device(device)
    order = fgraph.toposort()
    host = _host_variables(order, [fgraph.inputs[k] for k in host_inputs])
    cpu = torch.device("cpu")
    consts: dict = {}

    def const_value(c, where):
        if not isinstance(c.type, (TensorType, SparseTensorType)):
            return c.data  # NoneConst of an unspecified SpecifyShape dim
        key = (c, where)
        if key not in consts:
            consts[key] = (sparse_as_torch(c.data, where) if isinstance(c.type, SparseTensorType)
                           else as_torch(c.data, where))
        return consts[key]

    steps = []
    for node, free in zip(order, _free_lists(order, fgraph)):
        fn = torch_funcify(node.op, node=node, device=device, host=host)
        ports = ports_of(node, "host")
        on_host = any(o in host for o in node.outputs)
        args = [("const", const_value(i, cpu if on_host or k in ports else device))
                if isinstance(i, Constant) else ("var", i)
                for k, i in enumerate(node.inputs)]
        steps.append((fn, node, args, free))
    if device.type == "cuda":
        # a FusedElemwise's kernel, or a special function's one-node K1
        kernels = [k for k in (getattr(fn, "k1", fn) for fn, _, _, _ in steps)
                   if isinstance(k, fused_kernel.FusedElemwiseKernel)]
        if kernels:
            fused_kernel.build(kernels)
    outputs = [("const", const_value(o, device)) if isinstance(o, Constant) else ("var", o)
               for o in fgraph.outputs]
    return Plan(fgraph, device, steps, outputs, _host_reads(steps, host), trust_input)


# --- the captured function ------------------------------------------------------

def _signature(value):
    """What a capture is keyed by: shape and dtype, and for a sparse value
    its triple's."""
    if isinstance(value, CSR):
        return (value.shape, *(_signature(t) for t in (value.indptr, value.indices, value.data)))
    if not isinstance(value, torch.Tensor):
        raise TypeError(f"a captured function takes tensors, got {type(value)}")
    return value.shape, value.dtype


def _clone(value):
    """A fresh copy of a tensor or of a sparse triple, contiguous."""
    if isinstance(value, CSR):
        return CSR(_clone(value.indptr), _clone(value.indices), _clone(value.data), value.shape)
    return value.clone(memory_format=torch.contiguous_format)


def _copy_into(buffer, value):
    if isinstance(buffer, CSR):
        for field in ("indptr", "indices", "data"):
            getattr(buffer, field).copy_(getattr(value, field))
    else:
        buffer.copy_(value)


def _capture(plan, args):
    """Warm up, then capture one call of ``plan`` on inputs ``args``;
    returns ``(CapturedGraph, the warm-up's outputs)``."""
    dev = plan.device
    inputs = [_clone(a) for a in args]
    # the warm-up, on a side stream, leaves what the capture must find
    # done: K1's layouts, K2's library and constants, K4's library,
    # cuBLAS's handle and workspace
    cur = torch.cuda.current_stream(dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(cur)
    t0 = time.perf_counter()
    with torch.cuda.stream(side):
        warm = plan.execute(inputs)
    cur.wait_stream(side)
    # the warm-up's outputs may be views of the static inputs
    first = tuple(_clone(o) for o in warm)
    del warm
    t1 = time.perf_counter()
    before = [k.LAUNCHES for k in _KERNELS]
    before_ops = fused_kernel.OP_LAUNCHES.copy()
    nodes = NODES_RUN
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph):
            outputs = plan.execute(inputs)
    except Exception as exc:
        raise RuntimeError(
            f"capture of a CUDA graph failed: {exc}.  The plan passed the capture rule "
            "(link/torch/linker.py _host_reads), which must have missed a read of the "
            "device on the host") from exc
    # the capture recorded the launches and ran none on the card: each
    # replay counts them
    launches = [(k, k.LAUNCHES - n) for k, n in zip(_KERNELS, before) if k.LAUNCHES != n]
    for k, n in zip(_KERNELS, before):
        k.LAUNCHES = n
    ops = fused_kernel.OP_LAUNCHES - before_ops
    if ops:
        launches.append((fused_kernel.OP_LAUNCHES, ops))
        fused_kernel.OP_LAUNCHES.clear()
        fused_kernel.OP_LAUNCHES.update(before_ops)
    return CapturedGraph(graph, inputs, outputs, launches, NODES_RUN - nodes, t1 - t0,
                         time.perf_counter() - t1), first


class CapturedGraph:
    """One capture of a plan: the static input buffers, the CUDA graph,
    its outputs (in the graph's memory pool), the kernel launches a replay
    makes (a kernel module and its count, or K1's ``OP_LAUNCHES`` and the
    counts by device function), the nodes the capture ran, and the seconds
    of the warm-up and of the capture."""

    def __init__(self, graph, inputs, outputs, launches, nodes, warmup_s, capture_s):
        self.graph = graph
        self.inputs = inputs
        self.outputs = outputs
        self.launches = launches
        self.nodes = nodes
        self.warmup_s = warmup_s
        self.capture_s = capture_s

    def replay(self, args):
        for buffer, value in zip(self.inputs, args):
            _copy_into(buffer, value)
        # fresh outputs: a later replay overwrites the graph's own
        return tuple(_clone(o) for o in self.run())

    def run(self):
        """Replay on the static inputs as they are; returns the graph's own
        outputs, which the next replay overwrites."""
        self.graph.replay()
        for kernel, n in self.launches:
            if kernel is fused_kernel.OP_LAUNCHES:
                kernel.update(n)
            else:
                kernel.LAUNCHES += n
        return self.outputs


class CapturedFunction:
    """``TorchLinker``'s callable for a capturable plan on a CUDA device.

    Each call converts its inputs as the plan does and looks up the
    capture of their signature (``_signature``).  A new signature is a
    new capture, as a new static-argument combination is a new executable
    under ``jax.jit``: the plan runs once eagerly on a side stream, then
    one call is captured into a ``torch.cuda.CUDAGraph`` with TF32 off,
    and the call returns the warm-up's outputs.  Later calls of that
    signature copy their inputs into the capture's static buffers, replay
    the graph and return copies of its outputs, which no later call
    changes.  A capture that fails raises; nothing falls back.
    """

    def __init__(self, plan: Plan):
        self.plan = plan
        self.graphs: dict = {}

    def __call__(self, *args):
        plan = self.plan
        if len(args) != len(plan.inputs):
            raise TypeError(f"expected {len(plan.inputs)} inputs, got {len(args)}")
        if not plan.trust_input:
            args = plan.convert(args)
        key = tuple(_signature(a) for a in args)
        graph = self.graphs.get(key)
        if graph is None:
            self.graphs[key], first = _capture(plan, args)
            return first
        return graph.replay(args)


class TorchLinker:
    """Linker selected by ``Mode(linker="torch")``."""

    required_rewrites = ("torch",)

    @staticmethod
    def make_torch_fn(fgraph: FunctionGraph, device, trust_input: bool = False):
        """The callable of ``fgraph`` on ``device``: a ``CapturedFunction``
        on a CUDA device when ``config.xla__jit`` is on (read here) and
        the plan may be captured, else the eager ``Plan``."""
        plan = fgraph_to_torch(fgraph, device, trust_input)
        if plan.device.type == "cuda" and config.xla__jit and plan.capturable:
            return CapturedFunction(plan)
        return plan


class PyLinker:
    """Linker selected by ``Mode(linker="py")`` (``FAST_COMPILE``, ``PY``).

    The JAX package's ``"py"`` linker (``pytensor_tpu/link/basic.py:86
    PerformLinker``) runs each node's numpy ``perform`` on the host, one
    thunk a node.  The port's ops have no numpy ``perform``, so its
    ``"py"`` returns the eager ``Plan`` on the device the caller names:
    each node's lowering called in turn, never captured into a CUDA graph,
    whatever ``config.xla__jit`` says.  ``Plan.timer`` times each node
    (``compile/debug/profiling.py``).
    """

    required_rewrites = ("torch",)

    @staticmethod
    def make_torch_fn(fgraph: FunctionGraph, device, trust_input: bool = False):
        return fgraph_to_torch(fgraph, device, trust_input)

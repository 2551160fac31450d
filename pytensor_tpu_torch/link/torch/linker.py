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

A plan that holds an ``IfElse`` runs demand-driven (``Lazy``), as the JAX
package's oracle linker runs such a graph
(``pytensor_tpu/link/basic.py:160-250``): from the outputs' producers
down, an ``IfElse`` depending on its condition's producers only, and on
the taken branch's once the condition is read, so an untaken branch runs
no node.  Its values are freed by what has run: a value goes once every
node that reads it has run, and one that a node never run would read
stays until the call returns.  Every other plan keeps the topological
loop.  On a CUDA device the ``CheckAndRaise`` nodes of a plan and of its
inner plans defer their checks to the outermost plan (``Checks``), which
reads them once after the call.
"""

from __future__ import annotations

import threading
import time

import numpy as np
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
    torch_sparse_as_csr,
)
from pytensor_tpu_torch.link.torch.dispatch import (
    arange_index,
    bounded_by_producer,
    ports_of,
    torch_funcify,
)
from pytensor_tpu_torch.ifelse import IfElse
from pytensor_tpu_torch.raise_op import CheckAndRaise
from pytensor_tpu_torch.sparse.type import SparseTensorType
from pytensor_tpu_torch.tensor import fused_kernel
from pytensor_tpu_torch.tensor.basic import MakeVector
from pytensor_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise
from pytensor_tpu_torch.tensor.shape import Shape, Shape_i
from pytensor_tpu_torch.tensor.subtensor import Subtensor
from pytensor_tpu_torch.tensor.type import TensorType
from pytensor_tpu_torch.typed_list.basic import Length, TypedListType

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
    """The values computed on the host: shapes and typed lists' lengths,
    the outputs a lowering declares ``host_outputs`` (a sparse value's
    shape), and what the host-capable ops compute from them and constants.  A
    host-capable op of constants alone (a graph no rewrite folded, such as
    a nested scan's body) runs on the host where a host port reads what it
    computes, and on the device otherwise."""
    wanted: set = set()
    for node in reversed(order):
        wanted.update(node.inputs[k] for k in ports_of(node, "host"))
        if isinstance(node.op, _HOST_CAPABLE) and any(o in wanted for o in node.outputs):
            wanted.update(node.inputs)
    host: set = set(host_inputs)
    for node in order:
        host.update(node.outputs[k] for k in ports_of(node, "host_outputs"))
        if isinstance(node.op, (Shape, Shape_i, Length)):
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
      that is neither a constant, nor an ``arange`` of constant start and
      step (``dispatch.py arange_index``, bounded by its size), nor the
      output of an op whose lowering records its bounds
      (``bounded_by_producer``: a sparse matrix's row ids):
      ``idx.min()``/``idx.max()``.  The port raises on an index out of
      bounds where the XLA path clamps, and keeps that;
    - a host value at any other port of a node that runs on the device,
      which torch copies to the device (``MakeVector``'s ``.to(device)``);
      a lowering's ``scalar`` ports (an ``Elemwise``'s, K1's, the blas
      ops' alpha and beta) take a one-element host value as a scalar
      argument instead (``_takes_host_scalar``);
    - a lowering that reads the device on the host (``reads_back``:
      ``Nonzero``'s output size and the sparse ops whose count of stored
      entries depends on the values (``link/torch/sparse.py``); ``Eigh``,
      ``SVD`` and ``Expm``, whose torch routines synchronise);
    - the same in the inner plan of a scan that runs as the step loop,
      which takes the host values and constants among the scan's
      non-sequences as host values and constants (``keeps_host``).

    These are the run-time host reads of ``dispatch.py`` and the kernel
    wrappers (``.item()``, ``int()``, ``.tolist()``, ``.cpu()`` of a run-time
    value): ``_specify_shape``, ``_reshape``, ``_alloc``, ``_basic_index``
    and ``_adv_index``'s slice bounds, ``_IndexCheck``, ``scan_loop``'s and
    K2's ``int(n_steps)``.  The other sparse lowerings read nothing back
    (``convert.py csr_rows`` gives ``repeat_interleave`` its output size,
    ``compress_rows`` counts rows by ``scatter_add_``, not ``bincount``,
    and ``CSMProperties``' shape is a host value).
    Host values themselves (``_host_variables``) depend only on the
    shapes of the inputs, which the signature of a capture fixes.
    """
    reads = []
    for fn, node, _, _ in steps:
        if node.outputs and all(o in host for o in node.outputs):
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
            elif k in checked and arange_index(i) is None and not bounded_by_producer(i):
                reads.append(f"{node}: the bounds check of index input {k} reads its min and "
                             "max on the host")
            elif (k not in ports and k not in keeps and i in host
                  and not _takes_host_scalar(node, k, i)):
                reads.append(f"{node}: input {k} is a host value copied to the device")
        inner = getattr(fn, "inner", None)  # dispatch.py scan_loop's inner plan
        if inner is not None:
            reads += [f"{node}, a step: {r}" for r in inner.host_reads]
    return reads


def node_outputs(node, res) -> list:
    """A lowering's result as the list of ``node``'s output values: a list
    or a tuple holds the outputs, but where the output is a typed list,
    which is a Python list itself."""
    if isinstance(res, (list, tuple)) and not isinstance(node.outputs[0].type, TypedListType):
        return list(res)
    return [res]


class Checks:
    """The deferred checks of the ``CheckAndRaise`` nodes of a plan on a
    CUDA device and of its inner plans (a scan's step loop, a composite):
    one slot each, in topological order (an inner plan's at its node's
    place), in a device buffer of flags that the outermost plan zeroes at
    the start of each call and reads once after it (``raise_failed``).  A
    node's lowering ORs into its slot whether a condition failed, so a
    step loop's slot holds whether any step failed."""

    def __init__(self, device):
        self.device = device
        self.nodes: list = []
        self.buffer = None

    def slot(self, fgraph, node) -> int:
        self.nodes.append((fgraph, node))
        return len(self.nodes) - 1

    def allocate(self):
        if self.nodes:
            self.buffer = torch.zeros(len(self.nodes), dtype=torch.bool, device=self.device)

    def zero(self):
        if self.buffer is not None:
            self.buffer.zero_()

    def raise_failed(self):
        """Raise the first failed node's ``exc_type(msg)``, annotated with
        that node (``raise_with_op``); one copy of the flags to the host."""
        if self.buffer is None:
            return
        failed = self.buffer.cpu()
        if not bool(failed.any()):
            return
        fgraph, node = self.nodes[int(failed.nonzero()[0, 0])]
        try:
            raise node.op.exc_type(node.op.msg)
        except Exception:
            raise_with_op(fgraph, node)


# the depth of ``fgraph_to_torch`` calls made by lowerings, per thread
_LOWERING = threading.local()


class Lazy:
    """The demand-driven order of a plan that holds an ``IfElse``
    (``pytensor_tpu/link/basic.py:160-250``): for each step the steps it
    needs (an ``IfElse``'s: its condition's producers) and, for an
    ``IfElse``, its condition and each branch's producers; the outputs'
    producers; each freeable value's count of reading steps, and each
    step's freeable inputs."""

    def __init__(self, steps, fgraph):
        index = {node: k for k, (_, node, _, _) in enumerate(steps)}

        def producers(variables):
            return tuple(dict.fromkeys(index[v.owner] for v in variables
                                       if v.owner is not None and v.owner in index))

        keep = set(fgraph.inputs) | set(fgraph.outputs)
        self.deps, self.branches, self.reads = [], [], []
        self.readers: dict = {}
        for _, node, _, _ in steps:
            if isinstance(node.op, IfElse):
                n = node.op.n_outs
                self.deps.append(producers(node.inputs[:1]))
                self.branches.append((node.inputs[0], producers(node.inputs[1: 1 + n]),
                                      producers(node.inputs[1 + n:])))
            else:
                self.deps.append(producers(node.inputs))
                self.branches.append(None)
            reads = tuple(dict.fromkeys(i for i in node.inputs
                                        if not isinstance(i, Constant) and i not in keep))
            self.reads.append(reads)
            for i in reads:
                self.readers[i] = self.readers.get(i, 0) + 1
        self.targets = producers(fgraph.outputs)


class Plan:
    """``fgraph_to_torch``'s callable: ``plan(*inputs)`` returns a tuple of
    tensors.

    ``steps`` holds, for each node in topological order, its lowering, the
    node, its arguments (a constant's value or the variable to read) and
    its free list.  ``host_reads`` is the capture rule's verdict
    (``_host_reads``), ``capturable`` whether it is empty.  ``lazy``, for
    a plan that holds an ``IfElse``, is its demand-driven order
    (``Lazy``).  ``checks`` are the deferred checks (``Checks``) on a CUDA
    device, of which the outermost plan (``owns_checks``) zeroes and reads
    the flags.  ``hook``, when set, is called around each node a run
    runs: ``hook.before(node, inputs)`` gives a mark, and
    ``hook.after(node, mark, inputs, outputs)`` follows the node (the
    ``"py"`` linker's profiles, ``compile/debug/profiling.py NodeTimer``,
    and the debug modes, ``compile/debug/``).
    """

    def __init__(self, fgraph, device, steps, outputs, host_reads, trust_input, lazy=None,
                 checks=None, owns_checks=False):
        self.fgraph = fgraph
        self.device = device
        self.steps = steps
        self.inputs = list(fgraph.inputs)
        self.outputs = outputs
        self.host_reads = host_reads
        self.trust_input = trust_input
        self.lazy = lazy
        self.checks = checks
        self.owns_checks = owns_checks
        self.hook = None

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
        res = self.execute(args)
        self.raise_failed()
        return res

    def raise_failed(self):
        """The outermost plan's read of its deferred checks after a call."""
        if self.owns_checks:
            self.checks.raise_failed()

    def convert(self, args):
        """The inputs checked for device, dtype and shape, numpy values
        (and scipy matrices or torch sparse tensors, for sparse inputs, and
        lists, for typed-list inputs) converted."""
        return [self._convert(var.type, var, value) for var, value in zip(self.inputs, args)]

    def _convert(self, ty, var, value):
        device = self.device
        if isinstance(ty, TypedListType):
            if not isinstance(value, (list, tuple)):
                raise TypeError(f"input {var} is a typed list, got {type(value)}")
            return [self._convert(ty.ttype, var, v) for v in value]
        if isinstance(ty, SparseTensorType):
            if isinstance(value, CSR):
                return value
            value = ty.filter(value)
            if not isinstance(value, torch.Tensor):
                return sparse_as_torch(value, device)
            if value.device != device:
                raise ValueError(f"input {var} is on {value.device}, the function on {device}")
            return torch_sparse_as_csr(value)
        if isinstance(value, torch.Tensor):
            value = held(value, ty.dtype)
            if value.device != device:
                raise ValueError(f"input {var} is on {value.device}, the function on {device}")
            if value.dtype != torch_dtype(ty.dtype):
                raise TypeError(f"input {var} has dtype {value.dtype}, expected {ty.dtype}")
            if value.ndim != ty.ndim or any(
                    s is not None and s != d for s, d in zip(ty.shape, value.shape)):
                raise TypeError(f"input {var} has shape {tuple(value.shape)}, "
                                f"expected {ty}")
            return value
        return as_torch(ty.filter(value), device)

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
        if self.owns_checks:
            self.checks.zero()
        storage = dict(zip(self.inputs, args))
        if self.lazy is not None:
            self._run_lazy(storage)
            return tuple(v if kind == "const" else storage[v] for kind, v in self.outputs)
        NODES_RUN += len(self.steps)
        for fn, node, spec, free in self.steps:
            outs = self._call(fn, node, [v if kind == "const" else storage[v] for kind, v in spec])
            storage.update(zip(node.outputs, outs))
            for var in free:
                del storage[var]
        return tuple(v if kind == "const" else storage[v] for kind, v in self.outputs)

    def _call(self, fn, node, vals):
        """One node's run: its lowering on ``vals`` between the hook's
        calls, a failure annotated with the node; returns its outputs."""
        hook = self.hook
        if hook is not None:
            mark = hook.before(node, vals)
        try:
            res = fn(*vals)
        except Exception:
            raise_with_op(self.fgraph, node)
        outs = node_outputs(node, res)
        if hook is not None:
            hook.after(node, mark, vals, outs)
        return outs

    def _run_lazy(self, storage):
        """The demand-driven run (``Lazy``): a stack of steps from the
        outputs' producers; a step is expanded into the steps it needs,
        an ``IfElse`` then into its taken branch's (the condition read on
        the host here), and run once they are done.  An ``IfElse`` gets
        the condition as a Python bool and None for each value of the
        untaken branch."""
        global NODES_RUN
        lazy, steps = self.lazy, self.steps
        state = [0] * len(steps)  # 0 new, 1 expanded, 2 branch chosen
        done = [False] * len(steps)
        taken: dict = {}
        readers = dict(lazy.readers)
        stack = list(reversed(lazy.targets))
        while stack:
            k = stack[-1]
            if done[k]:
                stack.pop()
                continue
            if state[k] == 0:
                state[k] = 1
                stack.extend(d for d in reversed(lazy.deps[k]) if not done[d])
                continue
            branch = lazy.branches[k]
            if state[k] == 1 and branch is not None:
                state[k] = 2
                cond = branch[0]
                cond = cond.data if isinstance(cond, Constant) else storage[cond]
                taken[k] = bool(cond)
                stack.extend(d for d in reversed(branch[1 if taken[k] else 2]) if not done[d])
                continue
            fn, node, spec, _ = steps[k]
            if branch is None:
                vals = [v if kind == "const" else storage[v] for kind, v in spec]
            else:
                n, chosen = node.op.n_outs, taken[k]
                vals = [chosen] + [None if (j <= n) != chosen else v if kind == "const"
                                   else storage[v] for j, (kind, v) in enumerate(spec[1:], 1)]
            storage.update(zip(node.outputs, self._call(fn, node, vals)))
            done[k] = True
            NODES_RUN += 1
            stack.pop()
            for var in lazy.reads[k]:
                readers[var] -= 1
                if not readers[var]:
                    storage.pop(var, None)


def fgraph_to_torch(fgraph: FunctionGraph, device, trust_input: bool = False,
                    host_inputs=(), checks=None) -> Plan:
    """The eager plan of ``fgraph`` on ``device``: each node's torch
    lowering in topological order, or demand-driven where the graph holds
    an ``IfElse``.

    Inputs are checked for device, dtype and shape, and numpy values
    (and scipy matrices, for sparse inputs) converted, unless
    ``trust_input``: then they are taken as they are.  The inputs at the
    positions ``host_inputs`` are host values (a scan's step loop gives
    its inner plan the host values of the outer one).  ``checks`` is the
    outer plan's ``Checks``, which an inner plan's ``CheckAndRaise`` nodes
    write into; without it a plan on a CUDA device makes its own.  A
    lowering that links an inner plan holding a ``CheckAndRaise`` must
    pass its own ``checks`` on (raises otherwise): only the outermost
    plan's callers read the flags.
    """
    device = resolve_device(device)
    order = fgraph.toposort()
    host = _host_variables(order, [fgraph.inputs[k] for k in host_inputs])
    cpu = torch.device("cpu")
    consts: dict = {}
    owns_checks = checks is None and device.type == "cuda"
    if owns_checks:
        checks = Checks(device)

    def const_value(c, where):
        if isinstance(c.type, TypedListType):
            return [as_torch(np.asarray(v), where) for v in c.data]
        if not isinstance(c.type, (TensorType, SparseTensorType)):
            return c.data  # NoneConst of an unspecified SpecifyShape dim
        key = (c, where)
        if key not in consts:
            consts[key] = (sparse_as_torch(c.data, where) if isinstance(c.type, SparseTensorType)
                           else as_torch(c.data, where))
        return consts[key]

    nested = getattr(_LOWERING, "depth", 0)
    if owns_checks and nested and any(isinstance(n.op, CheckAndRaise) for n in order):
        raise RuntimeError("an inner plan's CheckAndRaise nodes must write into the outer "
                           "plan's flags: its lowering must pass fgraph_to_torch its checks")
    steps = []
    # the bounds of the ``bounded`` outputs (dispatch.py ports), recorded
    # by their producers as the plan runs and read by ``_IndexCheck``
    bounds: dict = {}
    _LOWERING.depth = nested + 1
    try:
        for node, free in zip(order, _free_lists(order, fgraph)):
            kw = {}
            if checks is not None and isinstance(node.op, CheckAndRaise):
                kw["slot"] = checks.slot(fgraph, node)
            fn = torch_funcify(node.op, node=node, device=device, host=host, checks=checks,
                               bounds=bounds, **kw)
            ports = ports_of(node, "host")
            on_host = bool(node.outputs) and all(o in host for o in node.outputs)
            args = [("const", const_value(i, cpu if on_host or k in ports else device))
                    if isinstance(i, Constant) else ("var", i)
                    for k, i in enumerate(node.inputs)]
            steps.append((fn, node, args, free))
    finally:
        _LOWERING.depth = nested
    if device.type == "cuda":
        # a FusedElemwise's kernel, or a special function's one-node K1
        kernels = [k for k in (getattr(fn, "k1", fn) for fn, _, _, _ in steps)
                   if isinstance(k, fused_kernel.FusedElemwiseKernel)]
        if kernels:
            fused_kernel.build(kernels)
    outputs = [("const", const_value(o, device)) if isinstance(o, Constant) else ("var", o)
               for o in fgraph.outputs]
    if owns_checks:
        checks.allocate()
    lazy = Lazy(steps, fgraph) if any(isinstance(n.op, IfElse) for n in order) else None
    return Plan(fgraph, device, steps, outputs, _host_reads(steps, host), trust_input, lazy,
                checks, owns_checks and checks.buffer is not None)


# --- the captured function ------------------------------------------------------

def _signature(value):
    """What a capture is keyed by: shape and dtype, for a sparse value its
    triple's, for a typed list its length and its elements'."""
    if isinstance(value, CSR):
        return (value.shape, *(_signature(t) for t in (value.indptr, value.indices, value.data)))
    if isinstance(value, list):
        return ("list", *(_signature(v) for v in value))
    if not isinstance(value, torch.Tensor):
        raise TypeError(f"a captured function takes tensors, got {type(value)}")
    return value.shape, value.dtype


def _clone(value):
    """A fresh copy of a tensor, of a sparse triple or of a typed list,
    contiguous."""
    if isinstance(value, CSR):
        return CSR(_clone(value.indptr), _clone(value.indices), _clone(value.data), value.shape)
    if isinstance(value, list):
        return [_clone(v) for v in value]
    return value.clone(memory_format=torch.contiguous_format)


def _copy_into(buffer, value):
    if isinstance(buffer, list):
        for b, v in zip(buffer, value):
            _copy_into(b, v)
    elif isinstance(buffer, CSR):
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
    plan.raise_failed()
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
    changes.  A capture that fails raises; nothing falls back.  A plan
    with deferred checks (``Checks``) zeroes its flags inside the capture
    and reads them after the warm-up and after each replay.
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
        res = graph.replay(args)
        plan.raise_failed()
        return res


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
    whatever ``config.xla__jit`` says.  ``Plan.hook`` is called around each
    node (``compile/debug/profiling.py``, ``compile/debug/*mode.py``).
    """

    required_rewrites = ("torch",)

    @staticmethod
    def make_torch_fn(fgraph: FunctionGraph, device, trust_input: bool = False):
        return fgraph_to_torch(fgraph, device, trust_input)

"""The torch linker: a rewritten FunctionGraph run node by node.

Counterpart of ``pytensor_tpu/link/xla/linker.py:44 fgraph_to_jax``.
Where the JAX package traces the graph once into one jitted executable,
the port runs each node's torch lowering in topological order, eagerly,
on an explicit device.  Fused elementwise chains and, with
``config.scan__pallas``, eligible scans are hand-written kernels;
everything else is a torch op.  For a CUDA device the fused elementwise
kernels (K1) of the whole graph are built when it is linked, in one nvcc
call (``tensor/fused_kernel.py build``).

Graph constants move to the device once, at link time, with their dtype
kept; a sparse constant (a scipy matrix) becomes its canonical CSR triple
(``convert.py sparse_as_torch``).  Shape values stay on the host: the
outputs of ``Shape`` and ``Shape_i``, the arithmetic on them, and the
constants that feed a reshape or a shape check, so that the run never
waits on the device to learn a shape.  Matrix products run in full float32: a function linked
for a CUDA device turns TF32 off for matmuls while it runs and puts the
setting back when it returns.
"""

from __future__ import annotations

import torch

from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.link.basic import raise_with_op
from pytensor_tpu_torch.link.torch.convert import (
    as_torch,
    resolve_device,
    sparse_as_torch,
    torch_dtype,
)
from pytensor_tpu_torch.link.torch.dispatch import torch_funcify
from pytensor_tpu_torch.scan.op import Scan
from pytensor_tpu_torch.sparse.type import SparseTensorType
from pytensor_tpu_torch.tensor import fused_kernel
from pytensor_tpu_torch.tensor.basic import Alloc, MakeVector
from pytensor_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise
from pytensor_tpu_torch.tensor.shape import Reshape, Shape, Shape_i, SpecifyShape
from pytensor_tpu_torch.tensor.subtensor import Subtensor
from pytensor_tpu_torch.tensor.type import TensorType

# ops that compute on the host when every non-constant input is host
_HOST_CAPABLE = (Elemwise, DimShuffle, MakeVector, CAReduce, Subtensor)
# input positions that are shapes, or a scan's step count
_SHAPE_PORTS = {Reshape: lambda i: i == 1, SpecifyShape: lambda i: i >= 1,
                Alloc: lambda i: i >= 1, Scan: lambda i: i == 0}


def _host_variables(order) -> set:
    host: set = set()
    for node in order:
        if isinstance(node.op, (Shape, Shape_i)):
            host.update(node.outputs)
        elif (isinstance(node.op, _HOST_CAPABLE)
              and any(i in host for i in node.inputs)
              and all(i in host or isinstance(i, Constant) for i in node.inputs)):
            host.update(node.outputs)
    return host


def _on_host(node, i, host) -> bool:
    port = _SHAPE_PORTS.get(type(node.op))
    return (port is not None and port(i)) or any(o in host for o in node.outputs)


def fgraph_to_torch(fgraph: FunctionGraph, device, trust_input: bool = False):
    """A python callable applying each node's torch lowering in
    topological order on ``device``; it returns a tuple of tensors.

    Inputs are checked for device, dtype and shape, and numpy values
    (and scipy matrices, for sparse inputs) converted, unless
    ``trust_input``: then they are taken as they are.
    """
    device = resolve_device(device)
    order = fgraph.toposort()
    host = _host_variables(order)
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

    plan = []
    for node in order:
        fn = torch_funcify(node.op, node=node, device=device)
        args = [("const", const_value(i, cpu if _on_host(node, k, host) else device))
                if isinstance(i, Constant) else ("var", i)
                for k, i in enumerate(node.inputs)]
        plan.append((fn, node, args))
    if device.type == "cuda":
        kernels = [fn for fn, _, _ in plan if isinstance(fn, fused_kernel.FusedElemwiseKernel)]
        if kernels:
            fused_kernel.build(kernels)

    inputs = list(fgraph.inputs)
    outputs = [("const", const_value(o, device)) if isinstance(o, Constant) else ("var", o)
               for o in fgraph.outputs]

    def convert(var, value):
        if isinstance(var.type, SparseTensorType):
            return sparse_as_torch(var.type.filter(value), device)
        if isinstance(value, torch.Tensor):
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

    def run(*args):
        if len(args) != len(inputs):
            raise TypeError(f"expected {len(inputs)} inputs, got {len(args)}")
        if trust_input:
            storage = dict(zip(inputs, args))
        else:
            storage = {var: convert(var, val) for var, val in zip(inputs, args)}
        for fn, node, spec in plan:
            vals = [v if kind == "const" else storage[v] for kind, v in spec]
            try:
                res = fn(*vals)
            except Exception:
                raise_with_op(fgraph, node)
            if isinstance(res, (list, tuple)):
                storage.update(zip(node.outputs, res))
            else:
                storage[node.outputs[0]] = res
        return tuple(v if kind == "const" else storage[v] for kind, v in outputs)

    if device.type != "cuda":
        return run

    def linked(*args):
        # full float32 matmuls, as the float32 tests and the JAX package
        # expect; the caller's setting is restored on return
        matmul = torch.backends.cuda.matmul
        prev = matmul.allow_tf32
        matmul.allow_tf32 = False
        try:
            return run(*args)
        finally:
            matmul.allow_tf32 = prev

    return linked


class TorchLinker:
    """Linker selected by ``Mode(linker="torch")``."""

    required_rewrites = ("torch",)

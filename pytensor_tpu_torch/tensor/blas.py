"""BLAS-level ops: Gemm, Gemv, Ger, Dot22, Dot22Scalar, BatchedDot.

Counterpart of ``pytensor_tpu/tensor/blas.py`` (PyTensor's tensor/blas
Gemm:76, Dot22:248, Gemv, Ger, BatchedDot:18), ported whole with its two
rewrites, ``local_dot_to_gemm`` and ``local_dot22_to_dot22scalar``,
registered in specialize in the JAX package's order.  The JAX package
computes these products with ``jnp.dot`` outside any Pallas kernel, so the
torch lowerings (``link/torch/dispatch.py``) are library products:
``torch.matmul``, ``torch.mv``, ``torch.addmm``, in full float32 on the
card (TF32 off).  Inside a whole-loop scan kernel K2 emits ``Dot22``,
``Gemm`` and ``Dot22Scalar`` itself (``link/cuda/scan_kernel.py``).
"""


from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.scalar.basic import upcast
from pytensor_tpu_torch.tensor import math as tm
from pytensor_tpu_torch.tensor.basic import as_tensor_variable, cast
from pytensor_tpu_torch.tensor.math import Dot, dot, outer
from pytensor_tpu_torch.tensor.type import TensorType


class Gemm(Op):
    """out = beta * z + alpha * dot(x, y)."""

    __props__ = ("inplace",)

    def __init__(self, inplace=False):
        self.inplace = False  # the lowering writes a new tensor

    def make_node(self, z, alpha, x, y, beta):
        z, alpha, x, y, beta = (as_tensor_variable(v) for v in (z, alpha, x, y, beta))
        if x.type.ndim != 2 or y.type.ndim != 2 or z.type.ndim != 2:
            raise TypeError("Gemm works on matrices")
        dtype = upcast(z.type.dtype, x.type.dtype, y.type.dtype)
        out = TensorType(dtype, (x.type.shape[0], y.type.shape[1]))()
        return Apply(self, [z, alpha, x, y, beta], [out])

    def perform(self, node, inputs, output_storage):
        z, alpha, x, y, beta = inputs
        output_storage[0][0] = np.asarray(
            beta * z + alpha * np.dot(x, y), dtype=node.outputs[0].type.numpy_dtype
        )

    def infer_shape(self, fgraph, node, input_shapes):
        return [(input_shapes[2][0], input_shapes[3][1])]

    def L_op(self, inputs, outputs, output_grads):
        z, alpha, x, y, beta = inputs
        (gz,) = output_grads
        from pytensor_tpu_torch.tensor.basic import matrix_transpose as mt

        return [
            gz * beta,
            tm.sum(gz * dot(x, y)),
            alpha * dot(gz, mt(y)),
            alpha * dot(mt(x), gz),
            tm.sum(gz * z),
        ]


gemm = Gemm()
gemm_no_inplace = gemm


class Dot22(Op):
    """Matrix-matrix dot with both operands known 2-d (rewrite target)."""

    __props__ = ()

    def make_node(self, x, y):
        x, y = as_tensor_variable(x), as_tensor_variable(y)
        dtype = upcast(x.type.dtype, y.type.dtype)
        out = TensorType(dtype, (x.type.shape[0], y.type.shape[1]))()
        return Apply(self, [x, y], [out])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(
            np.dot(*inputs), dtype=node.outputs[0].type.numpy_dtype
        )

    def infer_shape(self, fgraph, node, input_shapes):
        return [(input_shapes[0][0], input_shapes[1][1])]

    def L_op(self, inputs, outputs, output_grads):
        x, y = inputs
        (gz,) = output_grads
        from pytensor_tpu_torch.tensor.basic import matrix_transpose as mt

        return [dot(gz, mt(y)), dot(mt(x), gz)]


_dot22 = Dot22()


class Dot22Scalar(Op):
    """alpha * dot(x, y) with 2-d operands (PyTensor's blas/gemm.py
    Dot22Scalar:298)."""

    __props__ = ()

    def make_node(self, x, y, alpha):
        x, y, alpha = (as_tensor_variable(v) for v in (x, y, alpha))
        if x.type.ndim != 2 or y.type.ndim != 2 or alpha.type.ndim != 0:
            raise TypeError("Dot22Scalar expects (matrix, matrix, scalar)")
        dtype = upcast(x.type.dtype, y.type.dtype, alpha.type.dtype)
        out = TensorType(dtype, (x.type.shape[0], y.type.shape[1]))()
        return Apply(self, [x, y, alpha], [out])

    def perform(self, node, inputs, output_storage):
        x, y, alpha = inputs
        output_storage[0][0] = np.asarray(
            alpha * np.dot(x, y), dtype=node.outputs[0].type.numpy_dtype
        )

    def infer_shape(self, fgraph, node, input_shapes):
        return [(input_shapes[0][0], input_shapes[1][1])]

    def L_op(self, inputs, outputs, output_grads):
        x, y, alpha = inputs
        (gz,) = output_grads
        from pytensor_tpu_torch.tensor.basic import matrix_transpose as mt

        return [alpha * dot(gz, mt(y)), alpha * dot(mt(x), gz),
                tm.sum(gz * dot(x, y))]


_dot22scalar = Dot22Scalar()


class Gemv(Op):
    """y_out = beta * y + alpha * dot(A, x)."""

    __props__ = ("inplace",)

    def __init__(self, inplace=False):
        self.inplace = False

    def make_node(self, y, alpha, A, x, beta):
        y, alpha, A, x, beta = (as_tensor_variable(v) for v in (y, alpha, A, x, beta))
        dtype = upcast(y.type.dtype, A.type.dtype, x.type.dtype)
        out = TensorType(dtype, y.type.shape)()
        return Apply(self, [y, alpha, A, x, beta], [out])

    def perform(self, node, inputs, output_storage):
        y, alpha, A, x, beta = inputs
        output_storage[0][0] = np.asarray(
            beta * y + alpha * np.dot(A, x), dtype=node.outputs[0].type.numpy_dtype
        )

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def L_op(self, inputs, outputs, output_grads):
        y, alpha, A, x, beta = inputs
        (gz,) = output_grads
        from pytensor_tpu_torch.tensor.basic import matrix_transpose as mt

        return [gz * beta, tm.sum(gz * dot(A, x)), alpha * outer(gz, x),
                alpha * dot(mt(A), gz), tm.sum(gz * y)]


gemv = Gemv()


class Ger(Op):
    """A_out = A + alpha * outer(x, y)."""

    __props__ = ("destructive",)

    def __init__(self, destructive=False):
        self.destructive = False

    def make_node(self, A, alpha, x, y):
        A, alpha, x, y = (as_tensor_variable(v) for v in (A, alpha, x, y))
        out = TensorType(A.type.dtype, A.type.shape)()
        return Apply(self, [A, alpha, x, y], [out])

    def perform(self, node, inputs, output_storage):
        A, alpha, x, y = inputs
        output_storage[0][0] = np.asarray(
            A + alpha * np.outer(x, y), dtype=node.outputs[0].type.numpy_dtype
        )

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def L_op(self, inputs, outputs, output_grads):
        A, alpha, x, y = inputs
        (gz,) = output_grads
        return [gz, tm.sum(gz * outer(x, y)), alpha * dot(gz, y),
                alpha * dot(x, gz)]


ger = Ger()


class BatchedDot(Op):
    """Batched matrix multiply (leading batch dim)."""

    __props__ = ()

    def make_node(self, x, y):
        x, y = as_tensor_variable(x), as_tensor_variable(y)
        if x.type.ndim != 3 or y.type.ndim != 3:
            raise TypeError("BatchedDot expects rank-3 operands")
        dtype = upcast(x.type.dtype, y.type.dtype)
        out = TensorType(dtype, (x.type.shape[0], x.type.shape[1], y.type.shape[2]))()
        return Apply(self, [x, y], [out])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(
            np.matmul(*inputs), dtype=node.outputs[0].type.numpy_dtype
        )

    def infer_shape(self, fgraph, node, input_shapes):
        return [(input_shapes[0][0], input_shapes[0][1], input_shapes[1][2])]

    def L_op(self, inputs, outputs, output_grads):
        x, y = inputs
        (gz,) = output_grads
        from pytensor_tpu_torch.tensor.basic import matrix_transpose as mt

        return [batched_dot(gz, mt(y)), batched_dot(mt(x), gz)]


_batched_dot = BatchedDot()


def batched_dot(x, y):
    x, y = as_tensor_variable(x), as_tensor_variable(y)
    if x.type.ndim == 3 and y.type.ndim == 3:
        return _batched_dot(x, y)
    return tm.matmul(x, y)


def batched_tensordot(x, y, axes=2):
    raise NotImplementedError("batched_tensordot: use matmul/tensordot")


def _register_rewrites():
    """The GemmOptimizer analog: fold beta*z + alpha*dot(x,y) into Gemm
    (PyTensor's tensor/rewriting/blas.py GemmOptimizer:437)."""
    from pytensor_tpu_torch.compile.mode import register_specialize
    from pytensor_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
    from pytensor_tpu_torch.tensor.elemwise import Elemwise

    def _as_dot(v):
        if v.owner is not None and isinstance(v.owner.op, (Dot, Dot22)):
            x, y = v.owner.inputs
            if x.type.ndim == 2 and y.type.ndim == 2:
                return x, y
        return None

    @node_rewriter([Elemwise])
    def local_dot_to_gemm(fgraph, node):
        """z + dot(x, y) -> Gemm(z, 1, x, y, 1) for 2-d operands."""
        if node.op.scalar_op.name != "add" or len(node.inputs) != 2:
            return False
        out = node.outputs[0]
        if out.type.ndim != 2:
            return False
        for z, d in (node.inputs, reversed(node.inputs)):
            xy = _as_dot(d)
            if xy is not None and z.type.ndim == 2 and \
                    len(fgraph.clients.get(d, ())) == 1:
                x, y = xy
                one = as_tensor_variable(np.asarray(1.0, dtype=out.type.dtype))
                res = gemm(z, one, x, y, one)
                if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
                    return False
                copy_stack_trace(out, res)
                return [res]
        return False

    register_specialize(local_dot_to_gemm, name="local_dot_to_gemm")

    @node_rewriter([Elemwise])
    def local_dot22_to_dot22scalar(fgraph, node):
        """alpha * dot(x, y) -> Dot22Scalar (PyTensor's rewriting/blas.py
        local_dot22_to_dot22scalar)."""
        if node.op.scalar_op.name != "mul" or len(node.inputs) != 2:
            return False
        out = node.outputs[0]
        if out.type.ndim != 2:
            return False
        for a, d in (node.inputs, reversed(node.inputs)):
            xy = _as_dot(d)
            if xy is None or len(fgraph.clients.get(d, ())) != 1:
                continue
            # alpha must be a 0-d tensor: a scalar that a DimShuffle expanded
            # is not unwrapped (the JAX package's unwrap loop reads
            # ``is_expand_dims``, which its DimShuffle lacks, and so gives
            # up at the first DimShuffle)
            av = a
            if av.type.ndim != 0:
                continue
            res = _dot22scalar(*xy, av)
            if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
                continue
            copy_stack_trace(out, res)
            return [res]
        return False

    register_specialize(local_dot22_to_dot22scalar,
                        name="local_dot22_to_dot22scalar")


_register_rewrites()

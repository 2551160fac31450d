"""Sparse ops: structured dot, its gradient, transpose.

Counterpart of ``pytensor_tpu/sparse/basic.py`` (PyTensor's
sparse/basic.py StructuredDot:1340), cut to what the sparse power
iteration and its gradient build: ``as_sparse_variable`` (``:21``),
``StructuredDot`` with its ``L_op`` (``:252-287``), ``StructuredDotGrad``
(``:290``), ``Transpose`` (``:338``), ``structured_dot`` and ``dot``.
``perform`` is scipy, what constant folding evaluates; the torch
lowerings are in ``link/torch/dispatch.py``.  Left out: ``CSM``,
``CSMProperties``, ``CSMGrad``, ``DenseFromSparse``/``SparseFromDense``,
``SpSum``, ``AddSD``/``AddSS``/``MulSS``/``MulSV``, ``HStack``/``VStack``,
``SamplingDot``, ``Usmm`` and the rest of the module.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply, Variable
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.scalar.basic import upcast
from pytensor_tpu_torch.sparse.type import SparseTensorType
from pytensor_tpu_torch.tensor.basic import as_tensor_variable
from pytensor_tpu_torch.tensor.type import TensorType


def as_sparse_variable(x):
    """A sparse graph variable, or a constant of a scipy matrix (csr or
    csc; other scipy formats become csr)."""
    if isinstance(x, Variable):
        if isinstance(x.type, SparseTensorType):
            return x
        raise TypeError(f"not a sparse variable: {x.type}")
    import scipy.sparse as sp

    if sp.issparse(x):
        fmt = x.format if x.format in ("csr", "csc") else "csr"
        return SparseTensorType(fmt, str(x.dtype), x.shape).make_constant(x)
    raise TypeError(f"cannot interpret {type(x)} as sparse")


class StructuredDot(Op):
    """sparse @ dense -> dense; the gradient wrt the sparse operand keeps
    its sparsity structure (reference StructuredDot:1340)."""

    __props__ = ()

    def make_node(self, a, b):
        a = as_sparse_variable(a)
        b = as_tensor_variable(b)
        dtype = upcast(a.type.dtype, b.type.dtype)
        if b.type.ndim == 1:
            out = TensorType(dtype, (a.type.shape[0],))()
        else:
            out = TensorType(dtype, (a.type.shape[0], b.type.shape[1]))()
        return Apply(self, [a, b], [out])

    def perform(self, node, inputs, output_storage):
        a, b = inputs
        output_storage[0][0] = np.asarray(a @ b, dtype=node.outputs[0].type.numpy_dtype)

    def infer_shape(self, fgraph, node, input_shapes):
        a, b = node.inputs
        if b.type.ndim == 1:
            return [(input_shapes[0][0],)]
        return [(input_shapes[0][0], input_shapes[1][1])]

    def L_op(self, inputs, outputs, output_grads):
        a, b = inputs
        (gz,) = output_grads
        ga = StructuredDotGrad()(a, b, gz)
        gb = StructuredDot()(transpose(a), gz)
        return [ga, gb]


structured_dot_ = StructuredDot()


class StructuredDotGrad(Op):
    """Gradient of structured_dot wrt the sparse operand: dense outer
    products evaluated only at the sparse pattern's nonzeros."""

    __props__ = ()

    def make_node(self, a, b, gz):
        a = as_sparse_variable(a)
        return Apply(self, [a, as_tensor_variable(b), as_tensor_variable(gz)], [a.type()])

    def perform(self, node, inputs, output_storage):
        import scipy.sparse as sp

        a, b, gz = inputs
        coo = a.tocoo()
        b2 = b[:, None] if b.ndim == 1 else b
        gz2 = gz[:, None] if gz.ndim == 1 else gz
        vals = np.einsum("ij,ij->i", gz2[coo.row], b2[coo.col])
        res = sp.coo_matrix((vals, (coo.row, coo.col)), shape=a.shape).asformat(a.format)
        output_storage[0][0] = res.astype(a.dtype)

    def connection_pattern(self, node):
        return [[False], [True], [True]]


def structured_dot(a, b):
    return structured_dot_(a, b)


def dot(a, b):
    """Sparse-aware dot: sparse @ dense or dense @ sparse -> dense."""
    from pytensor_tpu_torch.tensor.basic import transpose as dense_transpose

    a_sp = isinstance(getattr(a, "type", None), SparseTensorType)
    b_sp = isinstance(getattr(b, "type", None), SparseTensorType)
    if a_sp and not b_sp:
        return structured_dot_(a, b)
    if b_sp and not a_sp:
        a = as_tensor_variable(a)
        res = structured_dot_(transpose(b), dense_transpose(a) if a.type.ndim == 2 else a)
        return dense_transpose(res) if res.type.ndim == 2 else res
    raise TypeError("sparse.dot needs exactly one sparse operand")


class Transpose(Op):
    __props__ = ()

    def make_node(self, x):
        x = as_sparse_variable(x)
        fmt = {"csr": "csc", "csc": "csr"}[x.type.format]
        out = SparseTensorType(fmt, x.type.dtype, (x.type.shape[1], x.type.shape[0]))()
        return Apply(self, [x], [out])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = inputs[0].transpose()

    def L_op(self, inputs, outputs, output_grads):
        (gz,) = output_grads
        return [transpose(gz)]


transpose = Transpose()

"""Sparse linalg: block-diagonal construction.

Counterpart of ``pytensor_tpu/sparse/linalg.py`` (PyTensor's
sparse/linalg.py SparseBlockDiagonal, block_diag), whole: dense blocks
assembled into one sparse block-diagonal matrix.  Oracle =
``scipy.sparse.block_diag``, which stores every entry of a dense block;
the torch lowering (``link/torch/sparse.py``) offsets each block's
row-major entries (a static count: the sum of the blocks' sizes)."""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.sparse.type import SparseTensorType
from pytensor_tpu_torch.tensor.basic import as_tensor_variable


class SparseBlockDiagonal(Op):
    __props__ = ("format",)

    def __init__(self, format="csr"):
        if format not in ("csr", "csc"):
            raise ValueError(f"format must be csr or csc, got {format!r}")
        self.format = format

    def make_node(self, *matrices):
        matrices = [as_tensor_variable(m) for m in matrices]
        for m in matrices:
            if m.type.ndim != 2:
                raise TypeError("block_diag blocks must be matrices")
        dtype = matrices[0].type.dtype
        rows = cols = None
        if all(all(s is not None for s in m.type.shape) for m in matrices):
            rows = sum(m.type.shape[0] for m in matrices)
            cols = sum(m.type.shape[1] for m in matrices)
        out = SparseTensorType(self.format, dtype, (rows, cols))()
        return Apply(self, list(matrices), [out])

    def perform(self, node, inputs, output_storage):
        import scipy.sparse as sp

        output_storage[0][0] = sp.block_diag(inputs, format=self.format)

    def infer_shape(self, fgraph, node, input_shapes):
        r = sum(s[0] for s in input_shapes)
        c = sum(s[1] for s in input_shapes)
        return [(r, c)]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.sparse.basic import DenseFromSparse

        (gz,) = output_grads
        gd = DenseFromSparse()(gz)
        grads = []
        r0 = c0 = 0
        for m in inputs:
            r, c = m.shape[0], m.shape[1]
            grads.append(gd[r0: r0 + r, c0: c0 + c])
            r0, c0 = r0 + r, c0 + c
        return grads


def block_diag(*matrices, format="csr", name=None):
    """Assemble dense blocks into a sparse block-diagonal matrix
    (reference sparse/linalg.py block_diag)."""
    res = SparseBlockDiagonal(format)(*matrices)
    if name:
        res.name = name
    return res

"""Structured sparse indexing ops.

Counterpart of ``pytensor_tpu/sparse/structured.py`` (PyTensor's
sparse/basic.py GetItemList, GetItemListGrad, GetItem2Lists,
GetItem2ListsGrad, Diag, ConstructSparseFromList), whole.  The oracle is
scipy, as in the JAX package; where the JAX package's device path builds
one-hot selection matrices for the MXU, the torch lowerings
(``link/torch/sparse.py``) gather rows and look entries up in the sorted
keys of the stored ones:

- row selection        = a gather of the selected rows' entries
                         (its count is read back: it depends on the rows)
- its gradient         = the cotangent's entries moved to the rows
- (row, col) lookups   = a binary search of the query in the sorted keys
- diagonal             = ``index_add_`` of the entries on the diagonal
- scatter rows to rows = a stable sort of the new entries by row
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.sparse.basic import _as_sparse_variable
from pytensor_tpu_torch.sparse.type import SparseTensorType
from pytensor_tpu_torch.tensor.basic import as_tensor_variable
from pytensor_tpu_torch.tensor.type import TensorType


class GetItemList(Op):
    """Select rows of a sparse matrix by an integer vector -> sparse."""

    __props__ = ()

    def make_node(self, x, idx):
        x = _as_sparse_variable(x)
        idx = as_tensor_variable(idx)
        if idx.type.ndim != 1 or not idx.type.dtype.startswith(("int", "uint")):
            raise TypeError("index must be an integer vector")
        m = idx.type.shape[0]
        out = SparseTensorType(x.type.format, x.type.dtype,
                               (m, x.type.shape[1]))()
        return Apply(self, [x, idx], [out])

    def perform(self, node, inputs, output_storage):
        x, idx = inputs
        output_storage[0][0] = x[np.asarray(idx)].asformat(
            node.outputs[0].type.format)

    def infer_shape(self, fgraph, node, input_shapes):
        return [(input_shapes[1][0], input_shapes[0][1])]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import grad_undefined

        x, idx = inputs
        (gz,) = output_grads
        return [GetItemListGrad()(x, idx, gz),
                grad_undefined(self, 1, idx, "integer index")]


get_item_list = GetItemList()


class GetItemListGrad(Op):
    """Scatter the rows of gz back to the positions in idx (accumulating
    repeats) -> sparse with x's shape."""

    __props__ = ()

    def make_node(self, x, idx, gz):
        x = _as_sparse_variable(x)
        idx = as_tensor_variable(idx)
        gz = _as_sparse_variable(gz)
        return Apply(self, [x, idx, gz], [x.type()])

    def perform(self, node, inputs, output_storage):
        import scipy.sparse as sp

        x, idx, gz = inputs
        gz = gz.tocoo()
        rows = np.asarray(idx)[gz.row]
        out = sp.coo_matrix((gz.data, (rows, gz.col)), shape=x.shape)
        output_storage[0][0] = out.asformat(node.outputs[0].type.format)


class GetItem2Lists(Op):
    """Elementwise (rows[k], cols[k]) lookup -> dense vector."""

    __props__ = ()

    def make_node(self, x, rows, cols):
        x = _as_sparse_variable(x)
        rows = as_tensor_variable(rows)
        cols = as_tensor_variable(cols)
        out = TensorType(x.type.dtype, (rows.type.shape[0],))()
        return Apply(self, [x, rows, cols], [out])

    def perform(self, node, inputs, output_storage):
        x, rows, cols = inputs
        output_storage[0][0] = np.asarray(
            x[np.asarray(rows), np.asarray(cols)],
            dtype=node.outputs[0].type.numpy_dtype).ravel()

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[1]]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import grad_undefined

        x, rows, cols = inputs
        (gz,) = output_grads
        return [GetItem2ListsGrad()(x, rows, cols, gz),
                grad_undefined(self, 1, rows, "integer index"),
                grad_undefined(self, 2, cols, "integer index")]


get_item_2lists = GetItem2Lists()


class GetItem2ListsGrad(Op):
    """Sparse matrix with gz[k] at (rows[k], cols[k]) (x's shape)."""

    __props__ = ()

    def make_node(self, x, rows, cols, gz):
        x = _as_sparse_variable(x)
        rows = as_tensor_variable(rows)
        cols = as_tensor_variable(cols)
        gz = as_tensor_variable(gz)
        return Apply(self, [x, rows, cols, gz], [x.type()])

    def perform(self, node, inputs, output_storage):
        import scipy.sparse as sp

        x, rows, cols, gz = inputs
        out = sp.coo_matrix(
            (np.asarray(gz), (np.asarray(rows), np.asarray(cols))),
            shape=x.shape)
        output_storage[0][0] = out.asformat(node.outputs[0].type.format)


class Diag(Op):
    """Main diagonal of a square sparse matrix -> dense vector."""

    __props__ = ()

    def make_node(self, x):
        x = _as_sparse_variable(x)
        n = x.type.shape[0]
        return Apply(self, [x], [TensorType(x.type.dtype, (n,))()])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        output_storage[0][0] = np.asarray(
            x.diagonal(), dtype=node.outputs[0].type.numpy_dtype)

    def infer_shape(self, fgraph, node, input_shapes):
        return [(input_shapes[0][0],)]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.sparse.compat import square_diagonal

        (gz,) = output_grads
        return [square_diagonal(gz)]


diag = Diag()


class ConstructSparseFromList(Op):
    """Sparse matrix (x's shape) whose rows at ``ilist`` are the rows of
    dense ``values`` (repeats accumulate) — the gradient carrier for
    advanced indexing into sparse matrices (reference
    ConstructSparseFromList)."""

    __props__ = ()

    def make_node(self, x, values, ilist):
        from pytensor_tpu_torch.graph.basic import Variable

        if isinstance(x, Variable) and isinstance(x.type, SparseTensorType):
            xt = x
            fmt = x.type.format
        else:
            xt = as_tensor_variable(x)
            fmt = "csr"
        values = as_tensor_variable(values)
        ilist = as_tensor_variable(ilist)
        out = SparseTensorType(fmt, values.type.dtype,
                               (xt.type.shape[0], xt.type.shape[1]))()
        return Apply(self, [xt, values, ilist], [out])

    def perform(self, node, inputs, output_storage):
        import scipy.sparse as sp

        x, values, ilist = inputs
        m, c = values.shape
        rows = np.repeat(np.asarray(ilist), c)
        cols = np.tile(np.arange(c), m)
        out = sp.coo_matrix((values.ravel(), (rows, cols)), shape=x.shape)
        output_storage[0][0] = out.asformat(node.outputs[0].type.format)


construct_sparse_from_list = ConstructSparseFromList()

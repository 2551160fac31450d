"""Sparse ops: construction, structured dot, reductions.

Counterpart of ``pytensor_tpu/sparse/basic.py`` (PyTensor's
sparse/basic.py CSM:364, StructuredDot:1340, Dot:1839, SpSum:259,
SamplingDot:1763, Usmm:2017), whole: the ops keep the JAX package's
names, ``make_node``, ``perform`` (scipy, what constant folding
evaluates), gradients and rewrites (``local_usmm``,
``local_csm_properties_csm``, ``local_csm_grad_same_pattern``,
``local_csm_grad_of_dense``, ``local_dense_from_sparse_sparse_from_dense``
at the same databases).  The torch lowerings, in place of the JAX
package's BCOO ones, are in ``link/torch/sparse.py``; where the two JAX
paths disagree on a structure, they give the ``perform``'s.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable
from pytensor_tpu_torch.graph.null_type import DisconnectedType
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.scalar.basic import upcast
from pytensor_tpu_torch.sparse.type import SparseTensorType
from pytensor_tpu_torch.tensor.basic import as_tensor_variable
from pytensor_tpu_torch.tensor.type import TensorType


def _as_sparse_variable(x, format="csr"):
    if isinstance(x, Variable):
        if isinstance(x.type, SparseTensorType):
            return x
        raise TypeError(f"not a sparse variable: {x.type}")
    import scipy.sparse as sp

    if sp.issparse(x):
        t = SparseTensorType(x.format if x.format in ("csr", "csc") else "csr",
                             str(x.dtype), x.shape)
        return t.make_constant(x)
    raise TypeError(f"cannot interpret {type(x)} as sparse")


as_sparse_variable = _as_sparse_variable
as_sparse = _as_sparse_variable


class CSMProperties(Op):
    """Extract (data, indices, indptr, shape) from a csr/csc matrix."""

    __props__ = ()

    def make_node(self, x):
        x = _as_sparse_variable(x)
        return Apply(self, [x], [
            TensorType(x.type.dtype, (None,))(),
            TensorType("int32", (None,))(),
            TensorType("int32", (None,))(),
            TensorType("int64", (2,))(),
        ])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        output_storage[0][0] = np.asarray(x.data)
        output_storage[1][0] = np.asarray(x.indices, dtype="int32")
        output_storage[2][0] = np.asarray(x.indptr, dtype="int32")
        output_storage[3][0] = np.asarray(x.shape, dtype="int64")


    def L_op(self, inputs, outputs, output_grads):
        # only the data output is differentiable; rebuild a sparse matrix
        # carrying g_data on x's sparsity pattern
        from pytensor_tpu_torch.gradient import DisconnectedType
        from pytensor_tpu_torch.graph.null_type import NullType

        (x,) = inputs
        g_data = output_grads[0]
        if isinstance(getattr(g_data, "type", None),
                      (DisconnectedType, NullType)):
            from pytensor_tpu_torch.gradient import grad_undefined

            return [grad_undefined(self, 0, x, "only structure used")]
        data, indices, indptr, shape = self(x)
        fmt = x.type.format if x.type.format in ("csr", "csc") else "csr"
        return [CSM(fmt)(g_data, indices, indptr, shape)]


csm_properties = CSMProperties()


def csm_data(csm):
    """Data field of a sparse variable (reference sparse/basic.py:332)."""
    return csm_properties(csm)[0]


def csm_indices(csm):
    """Indices field of a sparse variable."""
    return csm_properties(csm)[1]


def csm_indptr(csm):
    """Indptr field of a sparse variable."""
    return csm_properties(csm)[2]


def csm_shape(csm):
    """Shape field of a sparse variable."""
    return csm_properties(csm)[3]


def as_sparse_or_tensor_variable(x, name=None):
    """Sparse if possible, else dense tensor (reference basic.py:161)."""
    try:
        return _as_sparse_variable(x)
    except (TypeError, ValueError):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        return as_tensor_variable(x)


as_symbolic_sparse = as_sparse_variable


class CSM(Op):
    """Build a csr/csc matrix from (data, indices, indptr, shape)."""

    __props__ = ("format",)

    def __init__(self, format):
        self.format = format

    def make_node(self, data, indices, indptr, shape):
        data = as_tensor_variable(data)
        out = SparseTensorType(self.format, data.type.dtype)()
        return Apply(self, [data, as_tensor_variable(indices),
                            as_tensor_variable(indptr), as_tensor_variable(shape)],
                     [out])

    def perform(self, node, inputs, output_storage):
        import scipy.sparse as sp

        data, indices, indptr, shape = inputs
        cls = sp.csr_matrix if self.format == "csr" else sp.csc_matrix
        output_storage[0][0] = cls((data, indices, indptr), shape=tuple(shape))

    def connection_pattern(self, node):
        return [[True], [False], [False], [False]]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import DisconnectedType, grad_undefined
        from pytensor_tpu_torch.graph.null_type import NullType

        data, indices, indptr, shape = inputs
        (gz,) = output_grads
        if isinstance(getattr(gz, "type", None), (DisconnectedType, NullType)):
            return [grad_undefined(self, 0, data, "no gradient flows"),
                    DisconnectedType()(), DisconnectedType()(),
                    DisconnectedType()()]
        gd, gi, gp, gs = CSMProperties()(gz)
        g_data = CSMGrad()(data, indices, indptr, shape, gd, gi, gp, gs)
        return [g_data, DisconnectedType()(), DisconnectedType()(),
                DisconnectedType()()]


CSR = CSM("csr")
CSC = CSM("csc")


class CSMGrad(Op):
    """Pattern-aware gradient of CSM's data vector (reference
    sparse/basic.py:508).  The cotangent gz may be sparser than x or
    carry a different index order inside each compressed row; gout_data
    re-extracts gz at x's (indices, indptr) pattern, restoring explicit
    zeros where gz dropped them."""

    __props__ = ()

    def make_node(self, x_data, x_indices, x_indptr, x_shape,
                  g_data, g_indices, g_indptr, g_shape):
        ins = [as_tensor_variable(v) for v in
               (x_data, x_indices, x_indptr, x_shape,
                g_data, g_indices, g_indptr, g_shape)]
        return Apply(self, ins, [ins[4].type()])

    def perform(self, node, inputs, output_storage):
        import scipy.sparse as sp

        (x_data, x_indices, x_indptr, x_shape,
         g_data, g_indices, g_indptr, _g_shape) = inputs
        n_compressed = len(x_indptr) - 1
        sp_dim = int(x_shape[1]) if n_compressed == int(x_shape[0]) \
            else int(x_shape[0])
        gm = sp.csr_matrix((g_data, g_indices, g_indptr),
                           shape=(n_compressed, sp_dim))
        rows = np.repeat(np.arange(n_compressed),
                         np.diff(np.asarray(x_indptr)))
        gout = np.asarray(gm[rows, x_indices]).ravel().astype(
            node.outputs[0].type.numpy_dtype)
        output_storage[0][0] = np.zeros(
            len(x_data), node.outputs[0].type.numpy_dtype) + gout

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[4]]


csm_grad = CSMGrad




class DenseFromSparse(Op):
    __props__ = ()

    def make_node(self, x):
        x = _as_sparse_variable(x)
        return Apply(self, [x], [TensorType(x.type.dtype, x.type.shape)()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(inputs[0].todense())

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def L_op(self, inputs, outputs, output_grads):
        (x,) = inputs
        (gz,) = output_grads
        return [SparseFromDense(x.type.format)(gz)]


dense_from_sparse = DenseFromSparse()


class SparseFromDense(Op):
    __props__ = ("format",)

    def __init__(self, format="csr"):
        self.format = format

    def make_node(self, x):
        x = as_tensor_variable(x)
        if x.type.ndim != 2:
            raise TypeError("SparseFromDense expects a matrix")
        out = SparseTensorType(self.format, x.type.dtype, x.type.shape)()
        return Apply(self, [x], [out])

    def perform(self, node, inputs, output_storage):
        import scipy.sparse as sp

        cls = sp.csr_matrix if self.format == "csr" else sp.csc_matrix
        output_storage[0][0] = cls(inputs[0])

    def L_op(self, inputs, outputs, output_grads):
        (gz,) = output_grads
        return [dense_from_sparse(gz)]


csr_from_dense = SparseFromDense("csr")
csc_from_dense = SparseFromDense("csc")


class StructuredDot(Op):
    """sparse @ dense -> dense; gradient wrt the sparse operand keeps the
    sparsity structure (reference StructuredDot:1340)."""

    __props__ = ()

    def make_node(self, a, b):
        a = _as_sparse_variable(a)
        b = as_tensor_variable(b)
        dtype = upcast(a.type.dtype, b.type.dtype)
        if b.type.ndim == 1:
            out = TensorType(dtype, (a.type.shape[0],))()
        else:
            out = TensorType(dtype, (a.type.shape[0], b.type.shape[1]))()
        return Apply(self, [a, b], [out])

    def perform(self, node, inputs, output_storage):
        a, b = inputs
        res = a @ b
        output_storage[0][0] = np.asarray(res, dtype=node.outputs[0].type.numpy_dtype)

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
        a = _as_sparse_variable(a)
        return Apply(self, [a, as_tensor_variable(b), as_tensor_variable(gz)],
                     [a.type()])

    def perform(self, node, inputs, output_storage):
        a, b, gz = inputs
        out = a.copy()
        coo = a.tocoo()
        b2 = np.atleast_2d(b.T).T if b.ndim == 1 else b
        gz2 = np.atleast_2d(gz.T).T if gz.ndim == 1 else gz
        vals = np.einsum("ij,ij->i", gz2[coo.row], b2[coo.col])
        import scipy.sparse as sp

        res = sp.coo_matrix((vals, (coo.row, coo.col)), shape=a.shape).asformat(
            a.format
        )
        output_storage[0][0] = res.astype(a.dtype)

    def connection_pattern(self, node):
        return [[False], [True], [True]]


def structured_dot(a, b):
    return structured_dot_(a, b)


def dot(a, b):
    """Sparse-aware dot: sparse @ dense or dense @ sparse -> dense."""
    a_sp = isinstance(getattr(a, "type", None), SparseTensorType)
    b_sp = isinstance(getattr(b, "type", None), SparseTensorType)
    if a_sp and not b_sp:
        return structured_dot_(a, b)
    if b_sp and not a_sp:
        from pytensor_tpu_torch.tensor.basic import matrix_transpose

        res = structured_dot_(transpose(b), matrix_transpose(a) if a.type.ndim == 2
                              else a)
        return matrix_transpose(res) if res.type.ndim == 2 else res
    raise TypeError("sparse.dot needs exactly one sparse operand")


class Transpose(Op):
    __props__ = ()

    def make_node(self, x):
        x = _as_sparse_variable(x)
        fmt = {"csr": "csc", "csc": "csr"}[x.type.format]
        out = SparseTensorType(fmt, x.type.dtype,
                               (x.type.shape[1], x.type.shape[0]))()
        return Apply(self, [x], [out])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = inputs[0].transpose()

    def L_op(self, inputs, outputs, output_grads):
        (gz,) = output_grads
        return [transpose(gz)]


transpose = Transpose()


class SpSum(Op):
    __props__ = ("axis",)

    def __init__(self, axis=None):
        self.axis = axis

    def make_node(self, x):
        x = _as_sparse_variable(x)
        if self.axis is None:
            out = TensorType(x.type.dtype, ())()
        else:
            out = TensorType(x.type.dtype, (None,))()
        return Apply(self, [x], [out])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        res = x.sum(axis=self.axis)
        output_storage[0][0] = np.asarray(res).reshape(
            () if self.axis is None else (-1,)
        ).astype(node.outputs[0].type.numpy_dtype)

    def L_op(self, inputs, outputs, output_grads):
        # d(sum)/dx has x's sparsity pattern: broadcast gz onto the data
        from pytensor_tpu_torch.gradient import grad_not_implemented

        (x,) = inputs
        (gz,) = output_grads
        if self.axis is not None:
            return [grad_not_implemented(
                self, 0, x, "sparse axis-sum grad (use dense)")]
        data, indices, indptr, shape = CSMProperties()(x)
        from pytensor_tpu_torch.tensor.basic import ones_like

        fmt = x.type.format if x.type.format in ("csr", "csc") else "csr"
        return [CSM(fmt)(ones_like(data) * gz, indices, indptr, shape)]


def sp_sum(x, axis=None, sparse_grad=False):
    return SpSum(axis)(x)


class AddSD(Op):
    """sparse + dense -> dense."""

    __props__ = ()

    def make_node(self, s, d):
        s = _as_sparse_variable(s)
        d = as_tensor_variable(d)
        dtype = upcast(s.type.dtype, d.type.dtype)
        return Apply(self, [s, d], [TensorType(dtype, d.type.shape)()])

    def perform(self, node, inputs, output_storage):
        s, d = inputs
        output_storage[0][0] = np.asarray(s.todense() + d,
                                          dtype=node.outputs[0].type.numpy_dtype)

    def L_op(self, inputs, outputs, output_grads):
        (gz,) = output_grads
        return [SparseFromDense(inputs[0].type.format)(gz), gz]


add_s_d = AddSD()


class AddSS(Op):
    """sparse + sparse -> sparse."""

    __props__ = ()

    def make_node(self, x, y):
        x = _as_sparse_variable(x)
        y = _as_sparse_variable(y)
        return Apply(self, [x, y], [x.type()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = (inputs[0] + inputs[1]).asformat(
            node.outputs[0].type.format
        )

    def L_op(self, inputs, outputs, output_grads):
        (gz,) = output_grads
        return [gz, gz]


add_s_s = AddSS()


def add(x, y):
    xs = isinstance(getattr(x, "type", None), SparseTensorType)
    ys = isinstance(getattr(y, "type", None), SparseTensorType)
    if xs and ys:
        return add_s_s(x, y)
    if xs:
        return add_s_d(x, y)
    if ys:
        return add_s_d(y, x)
    from pytensor_tpu_torch.tensor import math as tm

    return tm.add(x, y)


class MulSV(Op):
    """sparse * scalar/dense(broadcast) -> sparse (structure preserved)."""

    __props__ = ()

    def make_node(self, s, v):
        s = _as_sparse_variable(s)
        v = as_tensor_variable(v)
        return Apply(self, [s, v], [s.type()])

    def perform(self, node, inputs, output_storage):
        s, v = inputs
        output_storage[0][0] = (s.multiply(v)).asformat(s.format) \
            if np.ndim(v) else (s * float(v)).asformat(s.format)

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import grad_not_implemented

        s, v = inputs
        (gz,) = output_grads
        return [MulSV()(gz, v), grad_not_implemented(self, 1, v)]


mul_s_v = MulSV()


def mul(x, y):
    xs = isinstance(getattr(x, "type", None), SparseTensorType)
    ys = isinstance(getattr(y, "type", None), SparseTensorType)
    if xs and ys:
        return MulSS()(x, y)
    if xs:
        return mul_s_v(x, y)
    return mul_s_v(y, x)


class SamplingDot(Op):
    """dot(x, y.T) evaluated only at the nonzero pattern of p
    (reference SamplingDot:1763)."""

    __props__ = ()

    def make_node(self, x, y, p):
        x = as_tensor_variable(x)
        y = as_tensor_variable(y)
        p = _as_sparse_variable(p)
        return Apply(self, [x, y, p], [p.type()])

    def perform(self, node, inputs, output_storage):
        import scipy.sparse as sp

        x, y, p = inputs
        coo = p.tocoo()
        vals = np.einsum("ij,ij->i", x[coo.row], y[coo.col])
        output_storage[0][0] = sp.coo_matrix(
            (vals, (coo.row, coo.col)), shape=p.shape
        ).asformat(p.format).astype(p.dtype)


sampling_dot = SamplingDot()


class MulSS(Op):
    """Elementwise sparse*sparse (intersection structure)."""

    __props__ = ()

    def make_node(self, x, y):
        x = _as_sparse_variable(x)
        y = _as_sparse_variable(y)
        return Apply(self, [x, y], [x.type()])

    def perform(self, node, inputs, output_storage):
        x, y = inputs
        output_storage[0][0] = x.multiply(y).asformat(node.outputs[0].type.format)

    def L_op(self, inputs, outputs, output_grads):
        (gz,) = output_grads
        x, y = inputs
        return [MulSS()(gz, y), MulSS()(gz, x)]


mul_s_s = MulSS()


class HStack(Op):
    __props__ = ("format",)

    def __init__(self, format="csr"):
        self.format = format

    def make_node(self, *mats):
        mats = [_as_sparse_variable(m) for m in mats]
        out = SparseTensorType(self.format, mats[0].type.dtype)()
        return Apply(self, list(mats), [out])

    def perform(self, node, inputs, output_storage):
        import scipy.sparse as sp

        output_storage[0][0] = sp.hstack(inputs).asformat(self.format)


class VStack(HStack):
    def perform(self, node, inputs, output_storage):
        import scipy.sparse as sp

        output_storage[0][0] = sp.vstack(inputs).asformat(self.format)


def hstack(mats, format="csr"):
    return HStack(format)(*mats)


def vstack(mats, format="csr"):
    return VStack(format)(*mats)


class GetItemScalar(Op):
    __props__ = ()

    def make_node(self, x, i, j):
        x = _as_sparse_variable(x)
        i = as_tensor_variable(i)
        j = as_tensor_variable(j)
        return Apply(self, [x, i, j], [TensorType(x.type.dtype, ())()])

    def perform(self, node, inputs, output_storage):
        x, i, j = inputs
        output_storage[0][0] = np.asarray(x[int(i), int(j)],
                                          dtype=node.outputs[0].type.numpy_dtype)


get_item_scalar = GetItemScalar()


class Usmm(Op):
    """alpha * sparse @ dense + dense, fused (reference Usmm:2017)."""

    __props__ = ()

    def make_node(self, alpha, x, y, z):
        alpha = as_tensor_variable(alpha)
        x = _as_sparse_variable(x)
        y = as_tensor_variable(y)
        z = as_tensor_variable(z)
        return Apply(self, [alpha, x, y, z], [z.type()])

    def perform(self, node, inputs, output_storage):
        alpha, x, y, z = inputs
        output_storage[0][0] = np.asarray(alpha * (x @ y) + z,
                                          dtype=node.outputs[0].type.numpy_dtype)

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import grad_not_implemented
        from pytensor_tpu_torch.tensor import math as tm

        alpha, x, y, z = inputs
        (gz,) = output_grads
        gy = alpha * StructuredDot()(transpose(x), gz)
        galpha = tm.sum(gz * StructuredDot()(x, y))
        gx = StructuredDotGrad()(x, y, alpha * gz)
        return [galpha, gx, gy, gz]


usmm = Usmm()


def _register_sparse_rewrites():
    """Reference sparse/rewriting.py analog: fuse alpha*dot(sp,d)+d -> Usmm."""
    from pytensor_tpu_torch.compile.mode import register_specialize
    from pytensor_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
    from pytensor_tpu_torch.tensor.elemwise import Elemwise

    @node_rewriter([Elemwise])
    def local_usmm(fgraph, node):
        if not (isinstance(node.op, Elemwise)
                and node.op.scalar_op.name == "add" and len(node.inputs) == 2):
            return False
        out = node.outputs[0]
        for d, z in (node.inputs, reversed(node.inputs)):
            if d.owner is not None and isinstance(d.owner.op, StructuredDot) \
                    and len(fgraph.clients.get(d, ())) == 1:
                x, y = d.owner.inputs
                one = as_tensor_variable(np.asarray(1.0, dtype=out.type.dtype))
                res = usmm(one, x, y, z)
                if out.type.is_super(res.type):
                    copy_stack_trace(out, res)
                    return [res]
        return False

    register_specialize(local_usmm, name="local_usmm")

    from pytensor_tpu_torch.compile.mode import register_canonicalize

    @node_rewriter([CSMProperties])
    def local_csm_properties_csm(fgraph, node):
        """csm_properties(CSM(data, ind, ptr, shp)) -> the raw inputs
        (reference sparse/rewriting.py:32)."""
        (x,) = node.inputs
        if x.owner is None or not isinstance(x.owner.op, CSM):
            return False
        return dict(zip(node.outputs, x.owner.inputs))

    register_canonicalize(local_csm_properties_csm,
                          name="local_csm_properties_csm")
    register_specialize(local_csm_properties_csm,
                        name="local_csm_properties_csm")

    @node_rewriter([CSMGrad])
    def local_csm_grad_same_pattern(fgraph, node):
        """CSMGrad where gz provably shares x's (indices, indptr): the
        data vector IS the gradient — no re-extraction needed."""
        xd, xi, xp, xsh, gd, gi, gp, gsh = node.inputs
        if xi is not gi or xp is not gp:
            return False
        from pytensor_tpu_torch.tensor.basic import cast as t_cast

        g_data = gd
        if g_data.type.dtype != node.outputs[0].type.dtype:
            g_data = t_cast(g_data, node.outputs[0].type.dtype)
        if not node.outputs[0].type.is_super(g_data.type):
            return False
        copy_stack_trace(node.outputs[0], g_data)
        return [g_data]

    register_canonicalize(local_csm_grad_same_pattern,
                          name="local_csm_grad_same_pattern")
    register_specialize(local_csm_grad_same_pattern,
                        name="local_csm_grad_same_pattern")

    @node_rewriter([CSMGrad])
    def local_csm_grad_of_dense(fgraph, node):
        """CSMGrad whose cotangent is SparseFromDense(d) -> gather d at
        x's (indices, indptr) pattern: one static AdvancedSubtensor, no
        value-dependent nse (XLA needs static shapes; the general
        CSMGrad path keeps the reference's dynamic semantics for the
        oracle)."""
        xd, xi, xp, xsh, gd, gi, gp, gsh = node.inputs
        o = gd.owner
        if o is None or not isinstance(o.op, CSMProperties):
            return False
        if gi.owner is not o or gp.owner is not o:
            return False
        (gz,) = o.inputs
        if gz.owner is None or not isinstance(gz.owner.op, SparseFromDense):
            return False
        (d,) = gz.owner.inputs
        from pytensor_tpu_torch.tensor.basic import arange, cast as t_cast
        from pytensor_tpu_torch.tensor.extra_ops import searchsorted

        nnz = xd.shape[0]
        comp = searchsorted(xp, arange(nnz), side="right") - 1
        if gz.owner.op.format == "csc":
            g_data = d[xi, comp]
        else:
            g_data = d[comp, xi]
        if g_data.type.dtype != node.outputs[0].type.dtype:
            g_data = t_cast(g_data, node.outputs[0].type.dtype)
        copy_stack_trace(node.outputs[0], g_data)
        return [g_data]

    register_specialize(local_csm_grad_of_dense,
                        name="local_csm_grad_of_dense")

    @node_rewriter([DenseFromSparse])
    def local_dense_from_sparse_sparse_from_dense(fgraph, node):
        """dense_from_sparse(sparse_from_dense(x)) -> x (reference
        sparse/rewriting.py:213)."""
        (s,) = node.inputs
        if s.owner is None or not isinstance(s.owner.op, SparseFromDense):
            return False
        (x,) = s.owner.inputs
        if not node.outputs[0].type.is_super(x.type):
            from pytensor_tpu_torch.tensor.basic import cast as t_cast

            x = t_cast(x, node.outputs[0].type.dtype)
            if not node.outputs[0].type.is_super(x.type):
                return False
        copy_stack_trace(node.outputs[0], x)
        return [x]

    register_canonicalize(local_dense_from_sparse_sparse_from_dense,
                          name="local_dense_from_sparse_sparse_from_dense")
    register_specialize(local_dense_from_sparse_sparse_from_dense,
                        name="local_dense_from_sparse_sparse_from_dense")


_register_sparse_rewrites()

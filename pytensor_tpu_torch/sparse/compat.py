"""Sparse functional surface (reference pytensor/sparse/basic.py exports).

Counterpart of ``pytensor_tpu/sparse/compat.py``, whole.  The
reference's ~200 sparse exports are mostly thin functional wrappers over
a handful of structural primitives:

- *structured* unary ops transform only the stored data (the reference
  semantics, even for f(0) != 0), through CSMProperties -> CSM;
- comparisons densify: their results are dense, as the reference's;
- the structural cleanups ``remove0``, ``ensure_sorted_indices`` and
  ``clean`` give scipy's structure: ``Remove0``'s count is read back from
  the device (``link/torch/sparse.py``), where the JAX package's device
  path keeps the zeros.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.sparse.basic import (
    CSC,
    CSM,
    CSR,
    add,
    as_sparse_variable,
    csm_properties,
    dense_from_sparse,
    dot,
    mul,
    sp_sum,
    structured_dot,
)
from pytensor_tpu_torch.sparse.type import SparseTensorType
from pytensor_tpu_torch.graph.basic import Apply as _Apply
from pytensor_tpu_torch.graph.op import Op as _Op

sparse_formats = ["csr", "csc"]
all_dtypes = ("float32", "float64", "int8", "int16", "int32", "int64",
              "uint8", "uint16", "uint32", "uint64", "complex64",
              "complex128")
float_dtypes = ("float32", "float64")
complex_dtypes = ("complex64", "complex128")
int_dtypes = ("int8", "int16", "int32", "int64")
uint_dtypes = ("uint8", "uint16", "uint32", "uint64")
integer_dtypes = int_dtypes + uint_dtypes
continuous_dtypes = float_dtypes + complex_dtypes
discrete_dtypes = integer_dtypes + ("bool",)


def _rebuild(x, new_data):
    data, indices, indptr, shape = csm_properties(x)
    fmt = x.type.format if x.type.format in ("csr", "csc") else "csr"
    return CSM(fmt)(new_data, indices, indptr, shape)


def structured_elemwise(fn, x):
    """Apply a dense elemwise callable to the stored data only."""
    x = as_sparse_variable(x)
    data, indices, indptr, shape = csm_properties(x)
    return CSM(x.type.format if x.type.format in ("csr", "csc") else "csr")(
        fn(data), indices, indptr, shape)


def _structured(name, tm_name=None):
    def f(x):
        from pytensor_tpu_torch.tensor import math as tm

        return structured_elemwise(getattr(tm, tm_name or name), x)

    f.__name__ = name
    return f


# data-only unary ops (f(0)=0 family keeps exact semantics; the
# structured_* family is data-only BY DEFINITION in the reference)
sin = _structured("sin")
tan = _structured("tan")
arcsin = _structured("arcsin")
arcsinh = _structured("arcsinh")
arctan = _structured("arctan")
arctanh = _structured("arctanh")
sinh = _structured("sinh")
tanh = _structured("tanh")
ceil = _structured("ceil")
floor = _structured("floor")
rint = _structured("rint", "round")
sign = _structured("sign")
sgn = sign
sqr = _structured("sqr")
sqrt = _structured("sqrt")
log1p = _structured("log1p")
expm1 = _structured("expm1")
deg2rad = _structured("deg2rad")
rad2deg = _structured("rad2deg")
trunc = _structured("trunc")
neg = _structured("neg")
abs = _structured("abs")
conj = _structured("conj")
conjugate = conj
structured_exp = _structured("structured_exp", "exp")
structured_log = _structured("structured_log", "log")
structured_sigmoid = _structured("structured_sigmoid", "sigmoid")
structured_conjugate = conj


def structured_pow(x, y):
    return structured_elemwise(lambda d: d ** y, x)


def structured_minimum(x, y):
    from pytensor_tpu_torch.tensor import math as tm

    return structured_elemwise(lambda d: tm.minimum(d, y), x)


def structured_maximum(x, y):
    from pytensor_tpu_torch.tensor import math as tm

    return structured_elemwise(lambda d: tm.maximum(d, y), x)


def structured_add(x, y):
    return structured_elemwise(lambda d: d + y, x)


def structured_add_s_v(x, v):
    """Add a vector to the nonzero entries, row-broadcast (reference
    StructuredAddSV): data[k] += v[col(k)] for csr."""
    x = as_sparse_variable(x)
    data, indices, indptr, shape = csm_properties(x)
    return CSM(x.type.format)(data + v[indices], indices, indptr, shape)


def cast(x, dtype):
    return structured_elemwise(lambda d: d.astype(dtype), x)


def _cast_to(dtype):
    def f(x):
        return cast(x, dtype)

    f.__name__ = f"{dtype}_cast"
    return f


bcast = _cast_to("int8")
wcast = _cast_to("int16")
icast = _cast_to("int32")
lcast = _cast_to("int64")
fcast = _cast_to("float32")
dcast = _cast_to("float64")
ccast = _cast_to("complex64")
zcast = _cast_to("complex128")


def sp_ones_like(x):
    from pytensor_tpu_torch.tensor.basic import ones_like

    return structured_elemwise(ones_like, x)


def sp_zeros_like(x):
    from pytensor_tpu_torch.tensor.basic import zeros_like

    return structured_elemwise(zeros_like, x)


# --- comparisons: densify (the device story has no CSR kernels) ----------

def _cmp(name):
    def f(x, y):
        from pytensor_tpu_torch.tensor import math as tm

        from pytensor_tpu_torch.graph.basic import Variable

        def densify(v):
            if isinstance(v, Variable) and isinstance(v.type, SparseTensorType):
                return dense_from_sparse(v)
            return v

        return getattr(tm, name)(densify(x), densify(y))

    f.__name__ = name
    return f


eq = _cmp("eq")
neq = _cmp("neq")
lt = _cmp("lt")
le = _cmp("le")
gt = _cmp("gt")
ge = _cmp("ge")
equal_s_s = equal_s_d = eq
not_equal_s_s = not_equal_s_d = neq
less_than_s_s = less_than_s_d = lt
less_equal_s_s = less_equal_s_d = le
greater_than_s_s = greater_than_s_d = gt
greater_equal_s_s = greater_equal_s_d = ge
minimum = _cmp("minimum")


def sub(x, y):
    from pytensor_tpu_torch.sparse.basic import add as _add

    return _add(x, neg(y) if isinstance(getattr(y, "type", None),
                                        SparseTensorType) else -y)


subtract = sub
multiply = mul
mul_s_d = mul
true_dot = dot


class _MajorIds:
    """Per-nnz major-axis id (row id for csr, col id for csc): expand the
    indptr run lengths.  The count is the data's, so the expansion stays
    on the device (``link/torch/sparse.py``, whose lowering also gives the
    host the ids' bounds, so ``v[ids]`` reads nothing back).  ``build()``
    gives the one op."""

    class MajorIds(_Op):
        __props__ = ()

        def make_node(self, indptr, data):
            from pytensor_tpu_torch.tensor.basic import as_tensor_variable
            from pytensor_tpu_torch.tensor.type import TensorType

            indptr = as_tensor_variable(indptr)
            data = as_tensor_variable(data)
            return _Apply(self, [indptr, data], [TensorType("int32", (None,))()])

        def perform(self, node, inputs, output_storage):
            indptr, data = inputs
            counts = np.diff(np.asarray(indptr))
            output_storage[0][0] = np.repeat(np.arange(len(counts)), counts).astype("int32")

        def infer_shape(self, fgraph, node, input_shapes):
            return [input_shapes[1]]

        def L_op(self, inputs, outputs, output_grads):
            from pytensor_tpu_torch.gradient import grad_undefined

            return [grad_undefined(self, k, inputs[k], "integer op") for k in range(2)]

    _op = MajorIds()

    @classmethod
    def build(cls):
        return cls._op


def _major_scale(x, v):
    data, indices, indptr, shape = csm_properties(x)
    ids = _MajorIds.build()(indptr, data)
    return CSM(x.type.format)(data * v[ids], indices, indptr, shape)


def _minor_scale(x, v):
    data, indices, indptr, shape = csm_properties(x)
    return CSM(x.type.format)(data * v[indices], indices, indptr, shape)


def row_scale(x, v):
    """Scale row i of x by v[i] (structure-preserving)."""
    x = as_sparse_variable(x)
    return _major_scale(x, v) if x.type.format == "csr" else _minor_scale(x, v)


def col_scale(x, v):
    """Scale column j of x by v[j] (structure-preserving)."""
    x = as_sparse_variable(x)
    return _minor_scale(x, v) if x.type.format == "csr" else _major_scale(x, v)


# --- structural cleanups --------------------------------------------------

class Remove0(_Op):
    """Drop stored zeros (reference sparse/basic.py Remove0:1763).  nnz
    is value-dependent, so on the static-shape device path this is the
    identity; the scipy oracle eliminates zeros."""

    __props__ = ()

    def make_node(self, x):
        x = as_sparse_variable(x)
        return _Apply(self, [x], [x.type()])

    def perform(self, node, inputs, output_storage):
        out = inputs[0].copy()
        out.eliminate_zeros()
        output_storage[0][0] = out

    def L_op(self, inputs, outputs, output_grads):
        return [output_grads[0]]


class EnsureSortedIndices(_Op):
    """Canonicalize index order (reference sparse/basic.py:1467)."""

    __props__ = ()

    def make_node(self, x):
        x = as_sparse_variable(x)
        return _Apply(self, [x], [x.type()])

    def perform(self, node, inputs, output_storage):
        out = inputs[0].copy()
        out.sort_indices()
        output_storage[0][0] = out

    def L_op(self, inputs, outputs, output_grads):
        return [output_grads[0]]


def remove0(x):
    return Remove0()(x)


def ensure_sorted_indices(x):
    return EnsureSortedIndices()(x)


def clean(x):
    return ensure_sorted_indices(remove0(x))


# --- indexing helpers (structured; see sparse/structured.py) --------------

def get_item_list(x, idx):
    """Select rows by an integer list/vector -> sparse (reference
    GetItemList semantics; repeats allowed)."""
    from pytensor_tpu_torch.sparse.structured import get_item_list as _gil

    return _gil(x, idx)


def get_item_2d(x, i, j):
    """Scalar (i, j) lookup."""
    from pytensor_tpu_torch.sparse.basic import get_item_scalar

    return get_item_scalar(x, i, j)


def get_item_2lists(x, rows, cols):
    """Elementwise (rows[k], cols[k]) lookup -> dense vector."""
    from pytensor_tpu_torch.sparse.structured import get_item_2lists as _gi2

    return _gi2(x, rows, cols)


def diag(x):
    """Main diagonal of a square sparse matrix -> dense vector."""
    from pytensor_tpu_torch.sparse.structured import diag as _diag

    return _diag(x)


def square_diagonal(v):
    """Dense vector -> sparse diagonal matrix."""
    from pytensor_tpu_torch.tensor.basic import arange, stack
    from pytensor_tpu_torch.tensor.shape import shape

    n = shape(v)[0]
    idx = arange(n).astype("int32")
    indptr = arange(n + 1).astype("int32")
    shp = stack([n.astype("int64") if hasattr(n, "astype") else n,
                 n.astype("int64") if hasattr(n, "astype") else n])
    return CSR(v, idx, indptr, shp)


def csr_dmatrix(name=None):
    return SparseTensorType("csr", "float64")(name)


def csc_dmatrix(name=None):
    return SparseTensorType("csc", "float64")(name)


def csr_fmatrix(name=None):
    return SparseTensorType("csr", "float32")(name)


def csc_fmatrix(name=None):
    return SparseTensorType("csc", "float32")(name)


def add_s_s_data(x, y):
    """Add the data vectors of two sparse matrices with IDENTICAL
    sparsity patterns (reference sparse/basic.py AddSSData); the result
    keeps the shared pattern."""
    from pytensor_tpu_torch.sparse.basic import CSM, csm_properties

    xd, xi, xp, xs = csm_properties(x)
    yd = csm_properties(y)[0]
    fmt = x.type.format if x.type.format in ("csr", "csc") else "csr"
    return CSM(fmt)(xd + yd, xi, xp, xs)


def structured_dot_grad(sparse_A, dense_B, grad_on_dense):
    """Gradient of structured_dot wrt the sparse operand (reference
    sparse/basic.py sdg_csc/sdg_csr): dense cotangent masked to A's
    sparsity pattern."""
    from pytensor_tpu_torch.sparse.basic import StructuredDotGrad

    return StructuredDotGrad()(sparse_A, dense_B, grad_on_dense)


sdg_csr = structured_dot_grad
sdg_csc = structured_dot_grad


# --- reference class-name surface ------------------------------------------
# Ops this build expresses compositionally (structured elemwise /
# CSM-rebuild graphs; PARITY.md §2.6) keep reference-constructor compat
# classes: instantiating and calling one builds the same graph as the
# matching function.

class _SparseCompositionalCtor:
    _builder = None

    def __init__(self, *args, **kwargs):
        self._args = args
        self._kwargs = kwargs

    def __call__(self, *inputs):
        return type(self)._builder(*inputs, *self._args, **self._kwargs)


class Cast(_SparseCompositionalCtor):
    """Reference sparse/basic.py Cast:595; builds cast(x, out_type)."""

    def __init__(self, out_type):
        super().__init__(out_type)
        self.out_type = out_type

    _builder = staticmethod(cast)


class ColScaleCSC(_SparseCompositionalCtor):
    """Reference sparse/basic.py ColScaleCSC:1259 -> col_scale graph."""

    _builder = staticmethod(col_scale)


class RowScaleCSC(_SparseCompositionalCtor):
    """Reference sparse/basic.py RowScaleCSC:1305 -> row_scale graph."""

    _builder = staticmethod(row_scale)


class GetItem2d(_SparseCompositionalCtor):
    """Reference sparse/basic.py GetItem2d:1002 -> get_item_2d graph."""

    _builder = staticmethod(get_item_2d)


class TrueDot(_SparseCompositionalCtor):
    """Reference sparse/math.py TrueDot:1200 -> dot (sparse output)."""

    def __init__(self, grad_preserves_dense=True):
        super().__init__()
        self.grad_preserves_dense = grad_preserves_dense

    _builder = staticmethod(dot)


class Dot(_SparseCompositionalCtor):
    """Reference sparse/math.py Dot:1839 -> dot (dense output)."""

    _builder = staticmethod(dot)


class AddSSData(_SparseCompositionalCtor):
    """Reference sparse/math.py AddSSData:416 -> add_s_s_data graph."""

    _builder = staticmethod(add_s_s_data)


class StructuredAddSV(_SparseCompositionalCtor):
    """Reference sparse/math.py StructuredAddSV:519."""

    _builder = staticmethod(structured_add_s_v)


class SparseDenseMultiply(_SparseCompositionalCtor):
    """Reference sparse/math.py SparseDenseMultiply:709 (mul_s_d)."""

    _builder = staticmethod(mul_s_d)


def _cmp_ctor(fn, refname):
    cls = type(refname, (_SparseCompositionalCtor,), {
        "_builder": staticmethod(fn),
        "__doc__": f"Reference sparse/math.py {refname} -> {fn.__name__} "
                   "(densifying comparison graph).",
    })
    return cls


EqualSS = _cmp_ctor(eq, "EqualSS")
EqualSD = _cmp_ctor(eq, "EqualSD")
NotEqualSS = _cmp_ctor(neq, "NotEqualSS")
NotEqualSD = _cmp_ctor(neq, "NotEqualSD")
LessThanSS = _cmp_ctor(lt, "LessThanSS")
LessThanSD = _cmp_ctor(lt, "LessThanSD")
LessEqualSS = _cmp_ctor(le, "LessEqualSS")
LessEqualSD = _cmp_ctor(le, "LessEqualSD")
GreaterThanSS = _cmp_ctor(gt, "GreaterThanSS")
GreaterThanSD = _cmp_ctor(gt, "GreaterThanSD")
GreaterEqualSS = _cmp_ctor(ge, "GreaterEqualSS")
GreaterEqualSD = _cmp_ctor(ge, "GreaterEqualSD")


class StructuredDotGradCSC(_SparseCompositionalCtor):
    """Reference sparse/math.py StructuredDotGradCSC:1471."""

    _builder = staticmethod(sdg_csc)


class StructuredDotGradCSR(_SparseCompositionalCtor):
    """Reference sparse/math.py StructuredDotGradCSR."""

    _builder = staticmethod(sdg_csr)


# names the reference re-exports into its sparse namespace
from pytensor_tpu_torch.sparse.basic import HStack as Stack  # noqa: E402,F401
from pytensor_tpu_torch.tensor.basic import Split  # noqa: E402,F401

"""Routed SpMV: the constant-pattern CSR matvec, and the rewrite to it.

Counterpart of ``pytensor_tpu/sparse/spmv.py``.  There the rewrite
``local_structured_dot_to_routed`` puts ``RoutedSpMV`` in place of
``StructuredDot(A_const, b)`` and the op runs as one-hot MXU matmuls and
Mosaic lane gathers (``link/pallas/route.py:194 lane_gather``) through a
Clos routing plan, because a gather along the lanes is the only
data-dependent move a TPU kernel has.  On Hopper a gather is a load: the
port's ``RoutedSpMV`` runs as K4, one CUDA kernel that gathers
``x[indices[k]]``, multiplies by ``data[k]`` and sums each row
(``csrc/spmv_csr.cu``, wrapper ``link/cuda/spmv_kernel.py``).

So the op keeps its name, output type, ``infer_shape`` and ``L_op``, but
its constant inputs are the canonical CSR of A (``indptr``, ``indices``,
``data``, from ``link/torch/convert.py canonical_csr``) where the JAX op
takes eight routing tables.  The rewrite keeps the JAX package's gates:
``config.sparse__routed_spmv``, a constant scipy A, a float32 or bfloat16
output, a ``(N,)`` or ``(N, 1)`` operand, at least 4,096 nonzeros, and the
plan's own refusals (no nonzeros, a row longer than 128, a padded ``K``
above 16,384), computed by the plan's numpy arithmetic without its
tables, so that both packages rewrite the same graphs.  Left out: the
routing plan (``plan_grid_permutation``, the edge colouring),
``build_spmv`` and ``spmv_np``.

A bfloat16 ``structured_dot`` of a scipy constant runs in neither
package: scipy refuses an ``ml_dtypes.bfloat16`` matrix ("scipy.sparse
does not support dtype bfloat16"), in the JAX package when the function
converts the constant (``tocoo``), here when the rewrite or the linker
makes its canonical CSR.  So the JAX package's bfloat16 branch of the
routed matvec is unreachable, and K4 has no bfloat16 form.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.compile.mode import register_specialize
from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.graph.basic import Apply, Constant
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from pytensor_tpu_torch.sparse.basic import StructuredDot, as_sparse_variable, structured_dot
from pytensor_tpu_torch.tensor.basic import as_tensor_variable, constant
from pytensor_tpu_torch.tensor.type import TensorType

LANES = 128
_MAX_K = 16384
# below this many nonzeros the JAX package keeps StructuredDot
MIN_NNZ = 4096


def _pow2_rows(n):
    """Smallest K = 128 * 2^j >= n (or None if > _MAX_K)."""
    K = LANES
    while K < n:
        K *= 2
    return K if K <= _MAX_K else None


def plan_spmv(A):
    """The sizes of the JAX package's routed plan (``spmv.py:51-101``) for
    scipy matrix ``A``, or None where that plan refuses it: ``M``, ``N``,
    ``nnz``, ``D2`` (the longest row), ``Kg`` (the rows packed by column
    segment), ``K2`` and the padded ``K``."""
    import scipy.sparse as sp

    if not sp.issparse(A):
        return None
    A = A.tocoo()
    M, N = A.shape
    nnz = A.nnz
    if nnz == 0:
        return None
    rows = A.row.astype(np.int64)
    cols = A.col.astype(np.int64)
    S = -(-N // LANES)
    nc = -(-M // LANES)
    r_sorted = np.sort(rows, kind="stable")
    row_starts = np.searchsorted(r_sorted, np.arange(M + 1))
    D2 = int((np.arange(nnz) - row_starts[r_sorted]).max()) + 1
    seg_starts = np.searchsorted(np.sort(cols // LANES, kind="stable"), np.arange(S + 1))
    Kg = int((-(-np.diff(seg_starts) // LANES)).sum())
    K2 = nc * D2
    K = _pow2_rows(max(Kg, K2, 1))
    if K is None or D2 > LANES:
        return None
    return {"M": M, "N": N, "nnz": nnz, "D2": D2, "Kg": Kg, "K2": K2, "K": K}


class RoutedSpMV(Op):
    """``y = A @ x`` for a constant CSR ``A`` given as the inputs
    ``(x, indptr, indices, data)``; runs as K4 on a CUDA device.  Created
    by ``local_structured_dot_to_routed``; reference parity:
    PyTensor's sparse/basic.py:1340 StructuredDot."""

    __props__ = ("meta_key",)

    def __init__(self, meta, a_sparse=None):
        self.meta = dict(meta)
        self.meta_key = tuple(sorted(self.meta.items()))
        # kept for L_op only (not part of equality)
        self.a_sparse = a_sparse

    def make_node(self, b, indptr, indices, data):
        b = as_tensor_variable(b)
        out = TensorType(data.type.dtype, (self.meta["M"],))()
        return Apply(self, [b, indptr, indices, data], [out])

    def perform(self, node, inputs, output_storage):
        import scipy.sparse as sp

        b, indptr, indices, data = inputs
        x = b[:, 0] if b.ndim == 2 else b
        A = sp.csr_matrix((data, indices, indptr), shape=(self.meta["M"], self.meta["N"]))
        output_storage[0][0] = np.asarray(A @ x, dtype=node.outputs[0].type.numpy_dtype)

    def infer_shape(self, fgraph, node, input_shapes):
        return [(self.meta["M"],)]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import grad_not_implemented

        (gz,) = output_grads
        b = inputs[0]
        if self.a_sparse is not None:
            gb = structured_dot(as_sparse_variable(self.a_sparse.T.tocsr()), gz)
            if b.type.ndim == 2:
                from pytensor_tpu_torch.tensor.shape import reshape

                gb = reshape(gb, (self.meta["N"], 1))
            grads = [gb]
        else:
            grads = [grad_not_implemented(self, 0, b)]
        return grads + [grad_not_implemented(self, i + 1, t)
                        for i, t in enumerate(inputs[1:])]


def routed_spmv_graph(A, b_var):
    """The RoutedSpMV apply of scipy matrix ``A`` to the dense graph
    variable ``b_var`` ((N,) or (N, 1)); None where the plan refuses A."""
    from pytensor_tpu_torch.link.torch.convert import canonical_csr

    plan = plan_spmv(A)
    if plan is None:
        return None
    indptr, indices, data = canonical_csr(A, str(b_var.type.dtype))
    tables = [constant(indptr, name="spmv_indptr"), constant(indices, name="spmv_indices"),
              constant(data, name="spmv_data")]
    return RoutedSpMV(plan, a_sparse=A.tocsr())(b_var, *tables)


@node_rewriter([StructuredDot])
def local_structured_dot_to_routed(fgraph, node):
    """StructuredDot(A_const, b) -> RoutedSpMV for a float32 (or, as the
    JAX package's gate reads, bfloat16) matvec with a constant pattern of
    at least 4,096 nonzeros."""
    import scipy.sparse as sp

    if not config.sparse__routed_spmv:
        return False
    a, b = node.inputs
    if not isinstance(a, Constant) or not sp.issparse(a.data):
        return False
    if str(node.outputs[0].type.dtype) not in ("float32", "bfloat16"):
        return False
    if b.type.ndim == 2:
        if b.type.shape[1] != 1:
            return False
    elif b.type.ndim != 1:
        return False
    if a.data.nnz < MIN_NNZ:
        return False  # small: the segment-sum path is already fine
    out = routed_spmv_graph(a.data, b)
    if out is None:
        return False
    if node.outputs[0].type.ndim == 2:
        from pytensor_tpu_torch.tensor.shape import reshape

        out = reshape(out, (out.type.shape[0], 1))
    if not node.outputs[0].type.is_super(out.type):
        return False
    copy_stack_trace(node.outputs[0], out)
    return [out]


register_specialize(local_structured_dot_to_routed, name="local_structured_dot_to_routed")

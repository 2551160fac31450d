"""Linalg rewrites.

Counterpart of ``pytensor_tpu/tensor/rewriting/linalg.py`` (PyTensor's
tensor/rewriting/linalg/: solvers.py:703 generic->structured solves,
which live with the assumptions engine, inverse.py:149, summary.py:258
det/logdet rules), in the JAX package's databases and order.  Left with
their ops (ROADMAP.md Queue 1 item 17): ``local_schur_of_diagonal``,
``local_qz_of_diagonal``, ``local_generalized_eigvalsh_of_diagonal`` and
``local_lu_factor_of_diagonal``.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.compile.mode import register_canonicalize, register_specialize, register_stabilize
from pytensor_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from pytensor_tpu_torch.tensor.elemwise import Elemwise
from pytensor_tpu_torch.tensor.linalg import (
    Cholesky,
    Det,
    MatrixInverse,
    SLogDet,
    Solve,
    slogdet,
    solve,
)
from pytensor_tpu_torch.tensor.math import Dot


def _is_ew(node, name):
    return isinstance(node.op, Elemwise) and node.op.scalar_op.name == name


@node_rewriter([MatrixInverse])
def local_inv_inv(fgraph, node):
    """inv(inv(x)) -> x."""
    inner = node.inputs[0].owner
    if inner is not None and isinstance(inner.op, MatrixInverse):
        x = inner.inputs[0]
        if node.outputs[0].type.is_super(x.type):
            return [x]
    return False


register_canonicalize(local_inv_inv, name="local_inv_inv")


@node_rewriter([Dot])
def local_inv_as_solve(fgraph, node):
    """dot(inv(A), b) -> solve(A, b); dot(b, inv(A)) -> solve(A^T, b^T)^T.

    A direct solve is one triangular-factor pass instead of a full inverse
    followed by a matmul (reference inverse.py:149 analog).
    """
    from pytensor_tpu_torch.tensor.basic import matrix_transpose

    x, y = node.inputs
    out = node.outputs[0]
    if x.owner is not None and isinstance(x.owner.op, MatrixInverse) \
            and len(fgraph.clients.get(x, ())) == 1:
        A = x.owner.inputs[0]
        res = solve(A, y, b_ndim=y.type.ndim)
        if out.type.is_super(res.type):
            copy_stack_trace(out, res)
            return [res]
    if y.owner is not None and isinstance(y.owner.op, MatrixInverse) \
            and len(fgraph.clients.get(y, ())) == 1 and x.type.ndim == 2:
        A = y.owner.inputs[0]
        res = matrix_transpose(
            solve(matrix_transpose(A), matrix_transpose(x), b_ndim=2)
        )
        if out.type.is_super(res.type):
            copy_stack_trace(out, res)
            return [res]
    return False


register_specialize(local_inv_as_solve, name="local_inv_as_solve")


@node_rewriter([Elemwise])
def local_log_det_to_slogdet(fgraph, node):
    """log(abs(det(A))) -> slogdet(A)[1]  (stable; avoids det overflow)."""
    if node.op.scalar_op.name != "log":
        return False
    arg = node.inputs[0].owner
    if arg is None:
        return False
    if _is_ew(arg, "abs"):
        inner = arg.inputs[0].owner
        if inner is not None and isinstance(inner.op, Det):
            res = slogdet(inner.inputs[0])[1]
            out = node.outputs[0]
            if out.type.is_super(res.type):
                copy_stack_trace(out, res)
                return [res]
    if isinstance(arg.op, Det):
        from pytensor_tpu_torch.assumptions import FactState, holds

        if holds(arg.inputs[0], "positive_definite") == FactState.TRUE:
            res = slogdet(arg.inputs[0])[1]
            out = node.outputs[0]
            if out.type.is_super(res.type):
                copy_stack_trace(out, res)
                return [res]
    return False


register_stabilize(local_log_det_to_slogdet, name="local_log_det_to_slogdet")


# ---------------------------------------------------------------------------
# assumption-driven specializations (reference tensor/rewriting/linalg/
# solvers.py:703, decomposition.py:494, summary.py:258)
# ---------------------------------------------------------------------------

def _holds(v, fact):
    from pytensor_tpu_torch.assumptions import FactState, holds

    return holds(v, fact) == FactState.TRUE


@node_rewriter([Solve])
def local_solve_of_gram_to_cho_solve(fgraph, node):
    """solve(L @ L.T, b) with L a Cholesky factor (or assumed lower
    triangular) -> cho_solve((L, True), b): skips the refactorization,
    two triangular solves instead of an LU (reference solvers.py psd
    path). The flagship GP-marginal-likelihood pattern."""
    from pytensor_tpu_torch.assumptions import gram_factor
    from pytensor_tpu_torch.tensor.linalg import CholeskySolve

    if node.op.assume_a not in ("gen", "pos", "sym"):
        return False
    A, b = node.inputs
    if A.owner is None:
        return False
    from pytensor_tpu_torch.tensor.blas import Dot22
    from pytensor_tpu_torch.tensor.math import Dot

    if not isinstance(A.owner.op, (Dot, Dot22)):
        return False
    L = gram_factor(A.owner)
    if L is None:
        return False
    # L must be the *left* factor (A = L L^T) and triangular
    if A.owner.inputs[0] is not L:
        return False
    if _holds(L, "lower_triangular"):
        res = CholeskySolve(b_ndim=node.op.b_ndim, lower=True)(L, b)
    elif _holds(L, "upper_triangular"):
        # A = U U^T with U upper: cho_solve expects the factor of A = c c^T
        res = CholeskySolve(b_ndim=node.op.b_ndim, lower=False)(
            _mT_var(L), b)
    else:
        return False
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


def _mT_var(v):
    from pytensor_tpu_torch.tensor.basic import matrix_transpose

    return matrix_transpose(v)


register_specialize(local_solve_of_gram_to_cho_solve,
                    name="local_solve_of_gram_to_cho_solve")


@node_rewriter([Solve])
def local_solve_of_diagonal(fgraph, node):
    """solve(D, b) with D known diagonal -> b / diag(D) (broadcast)."""
    from pytensor_tpu_torch.tensor.basic import diagonal

    A, b = node.inputs
    if node.op.assume_a != "gen" or not _holds(A, "diagonal"):
        return False
    d = diagonal(A)
    res = b / (d if node.op.b_ndim == 1 else d[:, None])
    out = node.outputs[0]
    from pytensor_tpu_torch.tensor.basic import cast as t_cast

    if res.type.dtype != out.type.dtype:
        res = t_cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_solve_of_diagonal, name="local_solve_of_diagonal")


@node_rewriter([Det])
def local_det_of_triangular(fgraph, node):
    """det(T) for triangular/diagonal T -> prod(diag(T)): O(n) instead of
    O(n^3) (reference summary.py det rules)."""
    from pytensor_tpu_torch.tensor.basic import diagonal
    from pytensor_tpu_torch.tensor.math import prod

    (A,) = node.inputs
    if not (_holds(A, "lower_triangular") or _holds(A, "upper_triangular")
            or _holds(A, "diagonal")):
        return False
    res = prod(diagonal(A), axis=-1)
    out = node.outputs[0]
    from pytensor_tpu_torch.tensor.basic import cast as t_cast

    if res.type.dtype != out.type.dtype:
        res = t_cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_det_of_triangular, name="local_det_of_triangular")


@node_rewriter([MatrixInverse])
def local_inv_of_orthogonal(fgraph, node):
    """inv(Q) for orthogonal Q -> Q^T: free."""
    (A,) = node.inputs
    if not _holds(A, "orthogonal"):
        return False
    res = _mT_var(A)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_inv_of_orthogonal, name="local_inv_of_orthogonal")


@node_rewriter(None)
def local_cholesky_of_diagonal(fgraph, node):
    """cholesky(D) for diagonal D -> diag(sqrt(diag(D))): O(n)."""
    from pytensor_tpu_torch.tensor.basic import alloc_diag, diagonal
    from pytensor_tpu_torch.tensor.linalg import Cholesky
    from pytensor_tpu_torch.tensor.math import sqrt

    if not isinstance(node.op, Cholesky):
        return False
    (A,) = node.inputs
    if not _holds(A, "diagonal"):
        return False
    res = alloc_diag(sqrt(diagonal(A)))
    out = node.outputs[0]
    from pytensor_tpu_torch.tensor.basic import cast as t_cast

    if res.type.dtype != out.type.dtype:
        res = t_cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_cholesky_of_diagonal, name="local_cholesky_of_diagonal")


@node_rewriter(None)
def local_slogdet_of_gram(fgraph, node):
    """slogdet(L @ L.T) with L a Cholesky factor -> (1, 2*sum(log(diag(L)))):
    no determinant at all (the GP logdet path)."""
    from pytensor_tpu_torch.assumptions import gram_factor
    from pytensor_tpu_torch.tensor.basic import diagonal, ones_like
    from pytensor_tpu_torch.tensor.blas import Dot22
    from pytensor_tpu_torch.tensor.linalg import SLogDet
    from pytensor_tpu_torch.tensor.math import Dot, log, sum as t_sum

    if not isinstance(node.op, SLogDet):
        return False
    (A,) = node.inputs
    if A.owner is None or not isinstance(A.owner.op, (Dot, Dot22)):
        return False
    L = gram_factor(A.owner)
    if L is None:
        return False
    if not (_holds(L, "lower_triangular") or _holds(L, "upper_triangular")):
        return False
    logdet = 2.0 * t_sum(log(diagonal(L)), axis=-1)
    sign_out, logdet_out = node.outputs
    from pytensor_tpu_torch.tensor.basic import cast as t_cast

    sign = ones_like(logdet)
    if sign.type.dtype != sign_out.type.dtype:
        sign = t_cast(sign, sign_out.type.dtype)
    if logdet.type.dtype != logdet_out.type.dtype:
        logdet = t_cast(logdet, logdet_out.type.dtype)
    if not (sign_out.type.is_super(sign.type)
            and logdet_out.type.is_super(logdet.type)):
        return False
    copy_stack_trace(logdet_out, logdet)
    return [sign, logdet]


register_specialize(local_slogdet_of_gram, name="local_slogdet_of_gram")


@node_rewriter(None)
def local_diagonal_of_diag(fgraph, node):
    """diagonal(diag(v)) -> v.

    Matches both diag constructions: the eye-mask elemwise form
    (eye(n) * v broadcast — the current ctor) and the legacy
    set_subtensor(zeros[ar, ar], v) scatter form."""
    from pytensor_tpu_torch.tensor.basic import ExtractDiag, Eye, NotScalarConstantError, get_scalar_constant_value
    from pytensor_tpu_torch.tensor.elemwise import DimShuffle, Elemwise
    from pytensor_tpu_torch.tensor.subtensor import AdvancedIncSubtensor

    if not isinstance(node.op, ExtractDiag) or node.op.offset != 0:
        return False
    (A,) = node.inputs
    if A.owner is None:
        return False
    out = node.outputs[0]

    def _accept(y):
        if y.type.dtype != out.type.dtype or not out.type.is_super(y.type):
            return False
        copy_stack_trace(out, y)
        return [y]

    def _is_eye0(m):
        if m.owner is None or not isinstance(m.owner.op, Eye):
            return False
        try:
            return int(get_scalar_constant_value(m.owner.inputs[2])) == 0
        except NotScalarConstantError:
            return False

    def _vec_of_row_bcast(w):
        """Return v when w is v.dimshuffle('x', 0) (or ... column bcast)."""
        if w.owner is not None and isinstance(w.owner.op, DimShuffle) \
                and not w.owner.op.drop and w.owner.op.shuffle == (0,) \
                and w.owner.inputs[0].type.ndim == 1:
            return w.owner.inputs[0]
        return None

    def _is_zero_const(v):
        from pytensor_tpu_torch.graph.basic import Constant

        while v.owner is not None and isinstance(v.owner.op, DimShuffle):
            v = v.owner.inputs[0]
        return isinstance(v, Constant) and np.all(np.asarray(v.data) == 0)

    # current ctor: switch(eye(n, bool), v.dimshuffle('x', 0), 0)
    if isinstance(A.owner.op, Elemwise) \
            and getattr(A.owner.op.scalar_op, "name", "") == "switch" \
            and len(A.owner.inputs) == 3:
        cond, tval, fval = A.owner.inputs
        if _is_eye0(cond) and _is_zero_const(fval):
            v = _vec_of_row_bcast(tval)
            if v is not None:
                return _accept(v)
        return False

    if isinstance(A.owner.op, Elemwise) \
            and getattr(A.owner.op.scalar_op, "name", "") == "mul" \
            and len(A.owner.inputs) == 2:
        for a, b in (A.owner.inputs, A.owner.inputs[::-1]):
            if a.owner is None or not isinstance(a.owner.op, Eye):
                continue
            try:
                if int(get_scalar_constant_value(a.owner.inputs[2])) != 0:
                    continue
            except NotScalarConstantError:
                continue
            if b.owner is not None and isinstance(b.owner.op, DimShuffle) \
                    and not b.owner.op.drop \
                    and b.owner.op.shuffle in ((0,),) \
                    and b.owner.inputs[0].type.ndim == 1:
                return _accept(b.owner.inputs[0])
        return False

    if not isinstance(A.owner.op, AdvancedIncSubtensor):
        return False
    if not A.owner.op.set_instead_of_inc:
        return False
    from pytensor_tpu_torch.assumptions import FactState, holds

    x, y, *indices = A.owner.inputs
    if holds(x, "zero") != FactState.TRUE or len(indices) != 2:
        return False
    r, c = indices
    if r is not c:
        return False
    return _accept(y)


register_canonicalize(local_diagonal_of_diag, name="local_diagonal_of_diag")


# ---------------------------------------------------------------------------
# the long tail (PyTensor's tensor/rewriting/linalg/{inverse,solvers,
# summary,decomposition}.py, where the rule is graph-semantic)
# ---------------------------------------------------------------------------

def _is_matrix_transpose(v):
    """Return the pre-transpose variable when v = matrix_transpose(u)."""
    from pytensor_tpu_torch.tensor.elemwise import DimShuffle

    if v.owner is None or not isinstance(v.owner.op, DimShuffle):
        return None
    nd = v.type.ndim
    if nd < 2:
        return None
    order = v.owner.op.new_order
    want = tuple(range(nd - 2)) + (nd - 1, nd - 2)
    if tuple(order) == want:
        return v.owner.inputs[0]
    return None


@node_rewriter(None)
def local_transpose_of_inv(fgraph, node):
    """inv(A)^T -> inv(A^T): canonical form groups the transpose inward
    so downstream solve/det rules see the raw operand
    (reference inverse.py transpose_of_inv)."""
    from pytensor_tpu_torch.tensor.elemwise import DimShuffle

    if not isinstance(node.op, DimShuffle):
        return False
    out = node.outputs[0]
    inner = _is_matrix_transpose(out)
    if inner is None or inner.owner is None \
            or not isinstance(inner.owner.op, MatrixInverse):
        return False
    from pytensor_tpu_torch.tensor.linalg import inv

    res = inv(_mT_var(inner.owner.inputs[0]))
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_transpose_of_inv, name="local_transpose_of_inv")


@node_rewriter([Det])
def local_det_of_inv(fgraph, node):
    """det(inv(A)) -> 1 / det(A): one factorization instead of an inverse
    plus a factorization (reference summary.py det_of_inv)."""
    (A,) = node.inputs
    if A.owner is None or not isinstance(A.owner.op, MatrixInverse):
        return False
    from pytensor_tpu_torch.tensor.linalg import det

    res = 1.0 / det(A.owner.inputs[0])
    out = node.outputs[0]
    from pytensor_tpu_torch.tensor.basic import cast as t_cast

    if res.type.dtype != out.type.dtype:
        res = t_cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_det_of_inv, name="local_det_of_inv")


@node_rewriter([Solve])
def local_scalar_solve_to_division(fgraph, node):
    """solve(A, b) with static (1, 1) A -> b / A[0, 0]
    (reference solvers.py scalar_solve_to_division)."""
    A, b = node.inputs
    if A.type.shape != (1, 1) or node.op.assume_a == "tridiagonal":
        return False
    d = A[0, 0]
    res = b / (d if node.op.b_ndim == 1 else d)
    out = node.outputs[0]
    from pytensor_tpu_torch.tensor.basic import cast as t_cast

    if res.type.dtype != out.type.dtype:
        res = t_cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_scalar_solve_to_division,
                    name="local_scalar_solve_to_division")


@node_rewriter([Solve])
def local_solve_of_inv_to_matmul(fgraph, node):
    """solve(inv(A), b) -> A @ b (reference solvers.py
    solve_of_inv_to_matmul)."""
    from pytensor_tpu_torch.tensor.math import dot

    A, b = node.inputs
    if A.owner is None or not isinstance(A.owner.op, MatrixInverse):
        return False
    res = dot(A.owner.inputs[0], b)
    out = node.outputs[0]
    from pytensor_tpu_torch.tensor.basic import cast as t_cast

    if res.type.dtype != out.type.dtype:
        res = t_cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_solve_of_inv_to_matmul,
                    name="local_solve_of_inv_to_matmul")


@node_rewriter(None)
def local_paired_triangular_solves_to_cho_solve(fgraph, node):
    """solve_triangular(L^T, solve_triangular(L, b, lower=True),
    lower=False) -> cho_solve((L, True), b) — the hand-written Cholesky
    solve collapses to one op (reference solvers.py
    paired_triangular_solves_to_cho_solve)."""
    from pytensor_tpu_torch.tensor.linalg import CholeskySolve, SolveTriangular

    if not isinstance(node.op, SolveTriangular) or node.op.lower:
        return False
    Au, inner_v = node.inputs
    if inner_v.owner is None \
            or not isinstance(inner_v.owner.op, SolveTriangular) \
            or not inner_v.owner.op.lower:
        return False
    L, b = inner_v.owner.inputs
    LT = _is_matrix_transpose(Au)
    if LT is not L:
        return False
    res = CholeskySolve(b_ndim=node.op.b_ndim, lower=True)(L, b)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_paired_triangular_solves_to_cho_solve,
                    name="local_paired_triangular_solves_to_cho_solve")


@node_rewriter([Solve])
def local_orthogonal_solve_to_transpose_matmul(fgraph, node):
    """solve(Q, b) with Q orthogonal -> Q^T @ b (reference solvers.py
    orthogonal_solve_to_transpose_matmul)."""
    from pytensor_tpu_torch.tensor.math import dot

    A, b = node.inputs
    if not _holds(A, "orthogonal"):
        return False
    res = dot(_mT_var(A), b)
    out = node.outputs[0]
    from pytensor_tpu_torch.tensor.basic import cast as t_cast

    if res.type.dtype != out.type.dtype:
        res = t_cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_orthogonal_solve_to_transpose_matmul,
                    name="local_orthogonal_solve_to_transpose_matmul")


@node_rewriter([MatrixInverse])
def local_inv_of_diag_to_reciprocal(fgraph, node):
    """inv(D) for diagonal D -> diag(1/diag(D)): O(n)
    (reference inverse.py inv_of_diag_to_diag_reciprocal)."""
    from pytensor_tpu_torch.tensor.basic import alloc_diag, diagonal

    (A,) = node.inputs
    if not _holds(A, "diagonal"):
        return False
    res = alloc_diag(1.0 / diagonal(A))
    out = node.outputs[0]
    from pytensor_tpu_torch.tensor.basic import cast as t_cast

    if res.type.dtype != out.type.dtype:
        res = t_cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_inv_of_diag_to_reciprocal,
                    name="local_inv_of_diag_to_reciprocal")


@node_rewriter(None)
def local_cholesky_of_gram(fgraph, node):
    """cholesky(L @ L^T) with L assumed lower triangular (positive
    diagonal) -> L (reference decomposition.py cholesky_ldotlt)."""
    from pytensor_tpu_torch.assumptions import gram_factor
    from pytensor_tpu_torch.tensor.blas import Dot22
    from pytensor_tpu_torch.tensor.linalg import Cholesky
    from pytensor_tpu_torch.tensor.math import Dot

    if not isinstance(node.op, Cholesky) or not node.op.lower:
        return False
    (A,) = node.inputs
    if A.owner is None or not isinstance(A.owner.op, (Dot, Dot22)):
        return False
    L = gram_factor(A.owner)
    if L is None or A.owner.inputs[0] is not L:
        return False
    # sound only for a factor with a non-negative diagonal: either L
    # literally comes from a Cholesky, or the user asserted positivity
    is_chol = L.owner is not None and isinstance(L.owner.op, Cholesky) \
        and L.owner.op.lower
    if not is_chol and not (_holds(L, "lower_triangular")
                            and _holds(L, "positive")):
        return False
    out = node.outputs[0]
    if L.type.dtype != out.type.dtype or not out.type.is_super(L.type):
        return False
    copy_stack_trace(out, L)
    return [L]


register_specialize(local_cholesky_of_gram, name="local_cholesky_of_gram")


@node_rewriter(None)
def local_svd_uv_merge(fgraph, node):
    """Two SVDs of the same operand where one discards U/V: reuse the
    singular values of the full one (reference decomposition.py
    svd_uv_merge)."""
    from pytensor_tpu_torch.tensor.linalg import SVD

    if not isinstance(node.op, SVD) or node.op.compute_uv:
        return False
    (A,) = node.inputs
    for client, _idx in fgraph.clients.get(A, ()):
        if client == "output" or client is node:
            continue
        if isinstance(client.op, SVD) and client.op.compute_uv \
                and client.op.full_matrices == node.op.full_matrices \
                and client.inputs[0] is A:
            s = client.outputs[1]
            out = node.outputs[0]
            if out.type.is_super(s.type):
                copy_stack_trace(out, s)
                return [s]
    return False


register_specialize(local_svd_uv_merge, name="local_svd_uv_merge")


@node_rewriter([Elemwise])
def local_log_prod_to_sum_log(fgraph, node):
    """log(prod(x)) with x assumed positive -> sum(log(x)): stable and
    fusable (reference summary.py local_log_prod_to_sum_log)."""
    from pytensor_tpu_torch.tensor.elemwise import CAReduce
    from pytensor_tpu_torch.tensor.math import log, sum as t_sum

    if node.op.scalar_op.name != "log":
        return False
    arg = node.inputs[0]
    if arg.owner is None or not isinstance(arg.owner.op, CAReduce):
        return False
    red = arg.owner.op
    if getattr(red.scalar_op, "name", None) != "mul":
        return False
    x = arg.owner.inputs[0]
    if not _holds(x, "positive"):
        return False
    res = t_sum(log(x), axis=red.axis)
    out = node.outputs[0]
    from pytensor_tpu_torch.tensor.basic import cast as t_cast

    if res.type.dtype != out.type.dtype:
        res = t_cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_stabilize(local_log_prod_to_sum_log,
                   name="local_log_prod_to_sum_log")


# ---------------------------------------------------------------------------
# diagonal-operand closed forms (PyTensor's tensor/rewriting/linalg/
# decomposition.py:136-479 svd/eigh/lu/qr _of_diag, products.py:194
# expm_of_diag, products.py:343 det_of_permutation, solvers.py orthogonal
# rules).  Each replaces an O(n^3) factorization with O(n)/O(n log n)
# work when the operand is known diagonal / permutation / orthogonal.
# ---------------------------------------------------------------------------

def _unit_sign(d):
    """sign(d) but +1 where d == 0, so unit-magnitude everywhere."""
    from pytensor_tpu_torch.tensor.math import eq, sign, switch

    one = np.asarray(1, dtype=d.type.dtype)
    return switch(eq(d, 0), one, sign(d))


def _holds_in(fgraph, v, fact):
    from pytensor_tpu_torch.assumptions import FactState, holds_in

    return holds_in(fgraph, v, fact) == FactState.TRUE


def _match_out(res, out):
    """Cast ``res`` to ``out``'s dtype; None when the type cannot match."""
    from pytensor_tpu_torch.tensor.basic import cast as t_cast

    if res.type.dtype != out.type.dtype:
        res = t_cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return None
    copy_stack_trace(out, res)
    return res


def _replace_all(node, results):
    matched = [_match_out(r, o) for r, o in zip(results, node.outputs)]
    if any(m is None for m in matched):
        return False
    return matched


def _static_n(A):
    """Symbolic-or-static trailing dim of a square matrix variable."""
    n = A.type.shape[0]
    if n is None:
        n = A.type.shape[1]
    if n is not None:
        return n
    return A.shape[0]


@node_rewriter(None)
def local_eigh_of_diagonal(fgraph, node):
    """eigh(D) for diagonal D -> (sort(diag(D)), I[:, argsort])."""
    from pytensor_tpu_torch.tensor.basic import diagonal, eye
    from pytensor_tpu_torch.tensor.linalg import Eigh
    from pytensor_tpu_torch.tensor.sort import argsort

    if not isinstance(node.op, Eigh):
        return False
    (A,) = node.inputs
    if not _holds_in(fgraph, A, "diagonal"):
        return False
    d = diagonal(A)
    idx = argsort(d)
    w = d[idx]
    out_dt = node.outputs[1].type.dtype
    v = _mT_var(eye(_static_n(A), dtype=out_dt)[idx])
    return _replace_all(node, [w, v])


register_specialize(local_eigh_of_diagonal, name="local_eigh_of_diagonal")


@node_rewriter(None)
def local_svd_of_diagonal(fgraph, node):
    """svd(D) for diagonal D: s = |d| sorted descending; U = I[:, idx];
    Vh rows are sign(d[idx]) * I[idx]."""
    from pytensor_tpu_torch.tensor.basic import diagonal, eye
    from pytensor_tpu_torch.tensor.linalg import SVD
    from pytensor_tpu_torch.tensor.math import abs as t_abs, sign
    from pytensor_tpu_torch.tensor.sort import argsort

    if not isinstance(node.op, SVD):
        return False
    (A,) = node.inputs
    if not _holds_in(fgraph, A, "diagonal"):
        return False
    d = diagonal(A)
    ad = t_abs(d)
    idx = argsort(-ad)
    s = ad[idx]
    if not node.op.compute_uv:
        return _replace_all(node, [s])
    out_dt = node.outputs[0].type.dtype
    I = eye(_static_n(A), dtype=out_dt)
    U = _mT_var(I[idx])
    # _unit_sign: keep Vh orthogonal when d has zeros (sign(0)=0 would
    # zero the row); A = U diag(s) Vh is unchanged since s=0 there
    Vh = _unit_sign(d[idx])[:, None] * I[idx]
    return _replace_all(node, [U, s, Vh])


register_specialize(local_svd_of_diagonal, name="local_svd_of_diagonal")


@node_rewriter(None)
def local_lu_of_diagonal(fgraph, node):
    """lu(D) for diagonal D -> (I, I, D) (or (I, D) with permute_l)."""
    from pytensor_tpu_torch.tensor.basic import eye
    from pytensor_tpu_torch.tensor.linalg import Lu

    if not isinstance(node.op, Lu) or getattr(node.op, "p_indices", False):
        return False
    (A,) = node.inputs
    if not _holds_in(fgraph, A, "diagonal"):
        return False
    out_dt = node.outputs[-1].type.dtype
    I = eye(_static_n(A), dtype=out_dt)
    if node.op.permute_l:
        return _replace_all(node, [I, A])
    return _replace_all(node, [I, I, A])


register_specialize(local_lu_of_diagonal, name="local_lu_of_diagonal")


@node_rewriter(None)
def local_qr_of_diagonal(fgraph, node):
    """qr(D) for diagonal D -> Q = diag(sign(d)), R = diag(|d|)."""
    from pytensor_tpu_torch.tensor.basic import alloc_diag, diagonal
    from pytensor_tpu_torch.tensor.linalg import QR
    from pytensor_tpu_torch.tensor.math import abs as t_abs, sign

    if not isinstance(node.op, QR):
        return False
    (A,) = node.inputs
    if not _holds_in(fgraph, A, "diagonal"):
        return False
    d = diagonal(A)
    R = alloc_diag(t_abs(d))
    if node.op.mode == "r":
        return _replace_all(node, [R])
    if node.op.mode not in ("reduced", "complete"):
        return False
    # zero diagonal entries: sign(0)=0 would zero a Q column and break
    # orthogonality — pick +1 there (any unit works, Q@R is unchanged)
    Q = alloc_diag(_unit_sign(d))
    return _replace_all(node, [Q, R])


register_specialize(local_qr_of_diagonal, name="local_qr_of_diagonal")


@node_rewriter(None)
def local_expm_of_diagonal(fgraph, node):
    """expm(D) for diagonal D -> diag(exp(diag(D)))."""
    from pytensor_tpu_torch.tensor.basic import alloc_diag, diagonal
    from pytensor_tpu_torch.tensor.linalg import Expm
    from pytensor_tpu_torch.tensor.math import exp as t_exp

    if not isinstance(node.op, Expm):
        return False
    (A,) = node.inputs
    if not _holds_in(fgraph, A, "diagonal"):
        return False
    return _replace_all(node, [alloc_diag(t_exp(diagonal(A)))])


register_specialize(local_expm_of_diagonal, name="local_expm_of_diagonal")


@node_rewriter([Det])
def local_det_of_permutation(fgraph, node):
    """det(P) for a permutation matrix P -> the permutation's sign,
    recovered from the column index vector argmax(P, axis=0): (-1)^k
    with k the number of inversions (reference products.py
    det_of_permutation)."""
    from pytensor_tpu_torch.tensor.basic import triu
    from pytensor_tpu_torch.tensor.math import argmax, sum as t_sum

    (A,) = node.inputs
    if A.type.ndim != 2 or not _holds_in(fgraph, A, "permutation"):
        return False
    idx = argmax(A, axis=0)
    inversions = t_sum(
        triu((idx[:, None] > idx[None, :]).astype("int64"), 1))
    sign = 1 - 2 * (inversions % 2)
    return _replace_all(node, [sign])


register_specialize(local_det_of_permutation,
                    name="local_det_of_permutation")


@node_rewriter([Dot])
def local_orthogonal_gram_to_eye(fgraph, node):
    """Q @ Q^T (or Q^T @ Q) for orthogonal square Q -> I (reference
    products.py orthogonal_dot_transpose_to_eye)."""
    from pytensor_tpu_torch.assumptions import gram_factor
    from pytensor_tpu_torch.tensor.basic import eye

    base = gram_factor(node)
    if base is None or base.type.ndim != 2:
        return False
    if base.type.shape[0] != base.type.shape[1] and None not in (
            base.type.shape[0], base.type.shape[1]):
        return False
    if not _holds_in(fgraph, base, "orthogonal"):
        return False
    out = node.outputs[0]
    return _replace_all(node, [eye(_static_n(base), dtype=out.type.dtype)])


register_specialize(local_orthogonal_gram_to_eye,
                    name="local_orthogonal_gram_to_eye")

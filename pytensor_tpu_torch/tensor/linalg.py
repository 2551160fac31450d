"""Linear algebra ops: decompositions, solvers, their gradients.

Counterpart of ``pytensor_tpu/tensor/linalg.py``: ``Cholesky`` (with its
mask-based pullback and ``_sym_tril_grad``), ``Solve``,
``SolveTriangular`` and ``CholeskySolve``, ``MatrixInverse``, ``Det``,
``SLogDet``, ``Eigh``, ``QR``, ``SVD``, ``Lu``, ``Expm`` and
``TridiagonalSolve``, each with ``make_node``, ``infer_shape``, ``L_op``
and a numpy ``perform`` (the oracle constant folding evaluates), and the
graph-level functions built on them (``pinv``, ``kron``,
``matrix_power``, ``lstsq``, the Lyapunov and Sylvester solvers, ...).
Every core op carries a gufunc signature, so ``_core2`` wraps it in a
``Blockwise`` when its operands are batched.

The torch lowerings live in ``link/torch/dispatch.py`` (``torch.linalg``,
cuSOLVER and cuBLAS on a card, as the JAX package's run ``jnp.linalg``
and ``jax.scipy.linalg``); each takes leading batch dimensions itself, so
a ``Blockwise`` of one is one call.  A Cholesky factorisation that fails
gives NaN there, in the factor's lower triangle, as XLA's does; the
oracle raises.

Not ported (ROADMAP.md Queue 1 item 17): the ops the JAX package runs on
the host through ``jax.pure_callback`` (``Eig``, ``Schur``, ``QZ``,
``OrdQZ``, ``SolveDiscreteARE``, ``SolveContinuousARE``,
``GeneralizedEigvalsh``, ``LUFactor``, ``LUSolve``,
``PivotToPermutation``).  Each raises ``NotImplementedError`` when it is
made, and so do the functions built on them.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.null_type import DisconnectedType
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.scalar.basic import upcast, upcast_float
from pytensor_tpu_torch.tensor import math as tm
from pytensor_tpu_torch.tensor.basic import (
    as_tensor_variable,
    cast,
    eye,
    identity_like,
    tril,
    triu,
    zeros_like,
)
from pytensor_tpu_torch.tensor.blockwise import Blockwise
from pytensor_tpu_torch.tensor.math import dot, matmul, outer, sum as pt_sum
from pytensor_tpu_torch.tensor.type import TensorType


def _mT(x):
    from pytensor_tpu_torch.tensor.basic import matrix_transpose

    return matrix_transpose(x) if x.type.ndim >= 2 else x


def _core2(op, *inputs, out_ndims=None):
    """Apply a core linalg op, Blockwise-wrapping when batched."""
    inputs = [as_tensor_variable(i) for i in inputs]
    core_ndims = op.core_in_ndims
    if any(i.type.ndim > c for i, c in zip(inputs, core_ndims)):
        return Blockwise(op, signature=op.gufunc_signature)(*inputs)
    return op(*inputs)


class MatrixOp(Op):
    """Base for square-matrix core ops."""

    core_in_ndims = (2,)

    def _check_matrix(self, x):
        x = as_tensor_variable(x)
        if x.type.ndim != 2:
            raise TypeError(f"{self} expects a matrix, got ndim={x.type.ndim}")
        return x

    def _float_type(self, x, square=True):
        dtype = upcast_float(x.type.dtype)
        n, m = x.type.shape
        return TensorType(dtype, (n, m))


class Cholesky(MatrixOp):
    """Lower/upper Cholesky factor (reference decomposition/cholesky.py:18)."""

    __props__ = ("lower", "on_error", "check_finite")
    gufunc_signature = "(n,n)->(n,n)"

    def __init__(self, lower=True, on_error="raise", check_finite=False):
        self.lower = bool(lower)
        self.on_error = on_error
        # honoured by the oracle path; the linked path skips it, as the JAX
        # package's XLA path does: a raise that depends on the data would
        # read the device on the host every call
        self.check_finite = bool(check_finite)

    def make_node(self, x):
        x = self._check_matrix(x)
        return Apply(self, [x], [self._float_type(x)()])

    def perform(self, node, inputs, output_storage):
        (x,) = inputs
        if self.check_finite and not np.all(np.isfinite(x)):
            raise ValueError("array must not contain infs or NaNs")
        try:
            L = np.linalg.cholesky(np.asarray(x, dtype=node.outputs[0].type.numpy_dtype))
            if not self.lower:
                L = L.T.conj()
        except np.linalg.LinAlgError:
            if self.on_error == "raise":
                raise
            L = np.full_like(np.asarray(x), np.nan)
        output_storage[0][0] = L.astype(node.outputs[0].type.numpy_dtype)

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def L_op(self, inputs, outputs, output_grads):
        # Cholesky pullback (Murray 2016): with L lower and only tril(A)
        # read by the factorization,
        #   G = L^-T phi*(L^T Lbar) L^-1,  phi*(M) = tril(M) - diag(M)/2
        #   Abar = tril(G + G^T) - diag(G)
        # Both masking steps are CONSTANT elementwise masks (tri/eye), not
        # diag-scatters, as in the JAX package (where a scatter broke XLA's
        # fusion), so that the two packages' graphs are the same.
        (x,) = inputs
        (L,) = outputs
        (Lbar,) = output_grads
        if not self.lower:
            # U = L^T: reduce to the lower case
            L = _mT(L)
            Lbar = _mT(Lbar)
        from pytensor_tpu_torch.tensor.basic import eye as _eye, tri as _tri

        n = L.type.shape[-1]
        if n is None:
            from pytensor_tpu_torch.tensor.shape import shape as _shape

            n = _shape(L)[-1]
        dt = L.type.dtype
        I = _eye(n, n, 0, dtype=dt)
        M = matmul(_mT(L), Lbar)
        # tril(M) - diag(M)/2  ==  M * (tril_ones - I/2)
        phi = M * (_tri(n, n, 0, dtype=dt) - 0.5 * I)
        solve_ut = SolveTriangular(lower=False)
        X1 = _core2(solve_ut, _mT(L), phi)          # L^-T phi
        G = _mT(_core2(solve_ut, _mT(L), _mT(X1)))  # X1 L^-1
        return [_sym_tril_grad(G)]

    def __str__(self):
        return f"Cholesky{{lower={self.lower}}}"


def _sym_tril_grad(G):
    """Gradient wrt A when only tril(A) is read as a symmetric matrix.

    tril(G + G^T) - diag(diagonal(G)) as CONSTANT elementwise masks
    ((G+G^T) * strict_tril + G * I), as the JAX package builds it."""
    from pytensor_tpu_torch.tensor.basic import eye as _eye, tri as _tri
    from pytensor_tpu_torch.tensor.shape import shape as _shape

    n = G.type.shape[-1]
    if n is None:
        n = _shape(G)[-1]
    dt = G.type.dtype
    return (G + _mT(G)) * _tri(n, n, -1, dtype=dt) + G * _eye(n, n, 0, dtype=dt)


def cholesky(x, lower=True, on_error="raise", check_finite=False):
    return _core2(
        Cholesky(lower=lower, on_error=on_error, check_finite=check_finite), x
    )


class SolveBase(MatrixOp):
    core_in_ndims = (2, None)  # b ndim set per call

    def __init__(self, b_ndim=2, **kwargs):
        self.b_ndim = int(b_ndim)

    @property
    def gufunc_signature(self):
        if self.b_ndim == 1:
            return "(n,n),(n)->(n)"
        return "(n,n),(n,m)->(n,m)"

    @property
    def core_in_ndims(self):
        return (2, self.b_ndim)

    def make_node(self, a, b):
        a = self._check_matrix(a)
        b = as_tensor_variable(b)
        if b.type.ndim != self.b_ndim:
            raise TypeError(f"b must have ndim={self.b_ndim}")
        dtype = upcast_float(a.type.dtype, b.type.dtype)
        out = TensorType(dtype, b.type.shape)()
        return Apply(self, [a, b], [out])

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[1]]

    def _solve_mat(self, a, b):
        raise NotImplementedError

    def perform(self, node, inputs, output_storage):
        a, b = inputs
        dt = node.outputs[0].type.numpy_dtype
        output_storage[0][0] = np.asarray(self._solve_mat(a, b), dtype=dt)

    def _transpose_op(self):
        """Op solving with A^T (for the gradient)."""
        raise NotImplementedError

    def L_op(self, inputs, outputs, output_grads):
        a, b = inputs
        (c,) = outputs
        (cbar,) = output_grads
        bbar = self._transpose_op()(_mT(a) if self.transpose_uses_a_T else a, cbar)
        if self.b_ndim == 1:
            abar = -outer(bbar, c)
        else:
            abar = -matmul(bbar, _mT(c))
        abar = self._restrict_abar(abar)
        return [abar, bbar]

    transpose_uses_a_T = True

    def _restrict_abar(self, abar):
        return abar


class Solve(SolveBase):
    __props__ = ("b_ndim", "assume_a")

    def __init__(self, b_ndim=2, assume_a="gen", **kwargs):
        super().__init__(b_ndim)
        self.assume_a = assume_a

    def _solve_mat(self, a, b):
        import scipy.linalg as sla

        return sla.solve(a, b, assume_a=self.assume_a)

    def _transpose_op(self):
        return Solve(b_ndim=self.b_ndim, assume_a=self.assume_a)


class SolveTriangular(SolveBase):
    __props__ = ("b_ndim", "lower", "unit_diagonal", "trans")

    def __init__(self, b_ndim=2, lower=True, unit_diagonal=False, trans=0, **kwargs):
        super().__init__(b_ndim)
        self.lower = bool(lower)
        self.unit_diagonal = bool(unit_diagonal)
        self.trans = trans

    def _solve_mat(self, a, b):
        import scipy.linalg as sla

        return sla.solve_triangular(a, b, lower=self.lower, trans=self.trans,
                                    unit_diagonal=self.unit_diagonal)

    def _transpose_op(self):
        # solving with A^T flips triangularity only if we pass A^T explicitly
        return SolveTriangular(b_ndim=self.b_ndim, lower=not self.lower,
                               unit_diagonal=self.unit_diagonal)

    def _restrict_abar(self, abar):
        return tril(abar) if self.lower else triu(abar)


class CholeskySolve(SolveBase):
    """Solve A x = b given the Cholesky factor of A (reference psd.py:14)."""

    __props__ = ("b_ndim", "lower")

    def __init__(self, b_ndim=2, lower=True, **kwargs):
        super().__init__(b_ndim)
        self.lower = bool(lower)

    def _solve_mat(self, c, b):
        import scipy.linalg as sla

        return sla.cho_solve((c, self.lower), b)

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import grad_not_implemented

        c, b = inputs
        (x,) = outputs
        (xbar,) = output_grads
        bbar = CholeskySolve(b_ndim=self.b_ndim, lower=self.lower)(c, xbar)
        if self.b_ndim == 1:
            cbar_full = -outer(bbar, x)
        else:
            cbar_full = -matmul(bbar, _mT(x))
        # d/dc of cho_solve: route through A = c c^T
        cbar = matmul(cbar_full + _mT(cbar_full), c)
        cbar = tril(cbar) if self.lower else triu(cbar)
        return [cbar, bbar]


def solve(a, b, assume_a="gen", lower=True, b_ndim=None, **kwargs):
    a = as_tensor_variable(a)
    b = as_tensor_variable(b)
    if b_ndim is None:
        b_ndim = min(b.type.ndim, 2) if b.type.ndim else 1
    if assume_a in ("sym", "her", "pos") and kwargs.get("use_cholesky"):
        pass
    return _core2(Solve(b_ndim=b_ndim, assume_a=assume_a), a, b)


def solve_triangular(a, b, lower=True, trans=0, unit_diagonal=False, b_ndim=None,
                     **kwargs):
    a = as_tensor_variable(a)
    b = as_tensor_variable(b)
    if trans in (1, "T", True):
        a = _mT(a)
        lower = not lower
    if b_ndim is None:
        b_ndim = min(b.type.ndim, 2) if b.type.ndim else 1
    return _core2(SolveTriangular(b_ndim=b_ndim, lower=lower,
                                  unit_diagonal=unit_diagonal), a, b)


def cho_solve(c_and_lower, b, b_ndim=None, **kwargs):
    c, lower = c_and_lower if isinstance(c_and_lower, tuple) else (c_and_lower, True)
    c = as_tensor_variable(c)
    b = as_tensor_variable(b)
    if b_ndim is None:
        b_ndim = min(b.type.ndim, 2) if b.type.ndim else 1
    return _core2(CholeskySolve(b_ndim=b_ndim, lower=lower), c, b)


class MatrixInverse(MatrixOp):
    __props__ = ()
    gufunc_signature = "(n,n)->(n,n)"

    def make_node(self, x):
        x = self._check_matrix(x)
        return Apply(self, [x], [self._float_type(x)()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.linalg.inv(inputs[0]).astype(
            node.outputs[0].type.numpy_dtype
        )

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def L_op(self, inputs, outputs, output_grads):
        (xi,) = outputs
        (gz,) = output_grads
        return [-matmul(matmul(_mT(xi), gz), _mT(xi))]

    def R_op(self, inputs, eval_points):
        (xi,) = [self(inputs[0])]
        (ev,) = eval_points
        if ev is None:
            return [None]
        return [-matmul(matmul(xi, ev), xi)]


matrix_inverse_op = MatrixInverse()


def inv(x):
    return _core2(matrix_inverse_op, x)


matrix_inverse = inv


def pinv(x, hermitian=False, rcond=None):
    """Moore-Penrose pseudoinverse (np.linalg.pinv semantics, incl.
    rank-deficient inputs): SVD-based with numpy's singular-value
    cutoff; hermitian=True uses the cheaper eigendecomposition.
    Reference MatrixPinv (nlinalg.py) wraps np.linalg.pinv; this is the
    same algorithm composed in-graph (differentiable end to end)."""
    from pytensor_tpu_torch.tensor.math import maximum
    from pytensor_tpu_torch.tensor.shape import shape

    x = as_tensor_variable(x)
    if rcond is None:
        eps = np.finfo(np.dtype(upcast_float(x.type.dtype))).eps
        m = shape(x)[-2]
        n = shape(x)[-1]
        rcond_v = cast(maximum(m, n), upcast_float(x.type.dtype)) * eps
    else:
        rcond_v = as_tensor_variable(rcond)
    if hermitian:
        w, v = eigh(x)
        cutoff = rcond_v * tm.max(tm.abs(w))
        keep = tm.abs(w) > cutoff
        w_inv = tm.switch(keep, 1.0 / w, zeros_like(w))
        return matmul(v * w_inv[..., None, :], _mT(v))
    u, s, vt = svd(x, full_matrices=False)
    cutoff = rcond_v * tm.max(s)
    keep = s > cutoff
    s_inv = tm.switch(keep, 1.0 / s, zeros_like(s))
    return matmul(_mT(vt) * s_inv[..., None, :], _mT(u))


class Det(MatrixOp):
    __props__ = ()
    gufunc_signature = "(n,n)->()"

    def make_node(self, x):
        x = self._check_matrix(x)
        dtype = upcast_float(x.type.dtype)
        return Apply(self, [x], [TensorType(dtype, ())()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(
            np.linalg.det(inputs[0]), dtype=node.outputs[0].type.numpy_dtype
        )

    def infer_shape(self, fgraph, node, input_shapes):
        return [()]

    def L_op(self, inputs, outputs, output_grads):
        (x,) = inputs
        (d,) = outputs
        (gz,) = output_grads
        return [gz * d * _mT(inv(x))]


det_op = Det()


def det(x):
    return _core2(det_op, x)


class SLogDet(MatrixOp):
    __props__ = ()
    gufunc_signature = "(n,n)->(),()"

    def make_node(self, x):
        x = self._check_matrix(x)
        dtype = upcast_float(x.type.dtype)
        return Apply(self, [x], [TensorType(dtype, ())(), TensorType(dtype, ())()])

    def perform(self, node, inputs, output_storage):
        sign, logdet = np.linalg.slogdet(inputs[0])
        dt = node.outputs[0].type.numpy_dtype
        output_storage[0][0] = np.asarray(sign, dtype=dt)
        output_storage[1][0] = np.asarray(logdet, dtype=dt)

    def infer_shape(self, fgraph, node, input_shapes):
        return [(), ()]

    def L_op(self, inputs, outputs, output_grads):
        (x,) = inputs
        sign, logdet = outputs
        gsign, glogdet = output_grads
        return [glogdet * _mT(inv(x))]


slogdet_op = SLogDet()


def slogdet(x):
    return _core2(slogdet_op, x)


def logdet(x):
    return slogdet(x)[1]


class Eigh(MatrixOp):
    __props__ = ("UPLO",)
    gufunc_signature = "(n,n)->(n),(n,n)"

    def __init__(self, UPLO="L"):
        self.UPLO = UPLO

    def make_node(self, x):
        x = self._check_matrix(x)
        dtype = upcast_float(x.type.dtype)
        n = x.type.shape[0] or x.type.shape[1]
        w = TensorType(dtype, (n,))()
        v = TensorType(dtype, (n, n))()
        return Apply(self, [x], [w, v])

    def perform(self, node, inputs, output_storage):
        w, v = np.linalg.eigh(inputs[0], self.UPLO)
        dt = node.outputs[0].type.numpy_dtype
        output_storage[0][0] = w.astype(dt)
        output_storage[1][0] = v.astype(dt)

    def infer_shape(self, fgraph, node, input_shapes):
        (xshp,) = input_shapes
        return [(xshp[0],), tuple(xshp)]

    def L_op(self, inputs, outputs, output_grads):
        # standard eigh pullback with degenerate-safe F matrix
        from pytensor_tpu_torch.graph.null_type import DisconnectedType as _D

        (x,) = inputs
        w, v = outputs
        wbar, vbar = output_grads
        W = w.dimshuffle("x", 0) - w.dimshuffle(0, "x")
        F = tm.switch(tm.eq(W, 0.0), zeros_like(W),
                      1.0 / tm.switch(tm.eq(W, 0.0), zeros_like(W) + 1.0, W))
        vtvbar = matmul(_mT(v), vbar)
        # diag(wbar) as an elementwise mask (I * wbar-row), not a scatter
        from pytensor_tpu_torch.tensor.basic import eye as _eye

        n_ = w.type.shape[0]
        if n_ is None:
            from pytensor_tpu_torch.tensor.shape import shape as _shape

            n_ = _shape(w)[0]
        inner = _eye(n_, n_, 0, dtype=w.type.dtype) * wbar.dimshuffle("x", 0) \
            + F * vtvbar
        G = matmul(matmul(v, inner), _mT(v))
        # eigh reads only one triangle of A (UPLO); map back accordingly
        if self.UPLO == "L":
            return [_sym_tril_grad(G)]
        return [_mT(_sym_tril_grad(_mT(G)))]


def eigh(x, UPLO="L"):
    return _core2(Eigh(UPLO), x)


class _HostLapackOp(MatrixOp):
    """An op the JAX package runs on the host, through ``jax.pure_callback``
    (``pytensor_tpu/tensor/linalg.py:1320-1380, 1641-1690``); not ported."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} is not ported: ROADMAP.md Queue 1 item 17 "
            "(the host-LAPACK linalg ops)")


class Eig(_HostLapackOp):
    pass


def eig(x):
    return Eig()(x)


class QR(MatrixOp):
    __props__ = ("mode",)

    def __init__(self, mode="reduced"):
        self.mode = mode

    @property
    def gufunc_signature(self):
        if self.mode == "reduced":
            return "(m,n)->(m,k),(k,n)"
        if self.mode == "r":
            return "(m,n)->(k,n)"
        return "(m,n)->(m,m),(m,n)"

    def make_node(self, x):
        x = self._check_matrix(x)
        dtype = upcast_float(x.type.dtype)
        m, n = x.type.shape
        k = None if (m is None or n is None) else min(m, n)
        if self.mode == "r":
            outs = [TensorType(dtype, (k, n))()]
        elif self.mode == "reduced":
            outs = [TensorType(dtype, (m, k))(), TensorType(dtype, (k, n))()]
        else:
            outs = [TensorType(dtype, (m, m))(), TensorType(dtype, (m, n))()]
        return Apply(self, [x], outs)

    def perform(self, node, inputs, output_storage):
        res = np.linalg.qr(inputs[0], mode=self.mode)
        if not isinstance(res, tuple):
            res = (res,)
        dt = node.outputs[0].type.numpy_dtype
        for s, r in zip(output_storage, res):
            s[0] = np.asarray(r, dtype=dt)

    def L_op(self, inputs, outputs, output_grads):
        # QR pullback (Townsend 2016; Liao et al. 2019 for m < n), covering
        # modes reduced / r / complete — the same coverage as the reference
        # decomposition/qr.py:230-319 (mode=raw and complete-with-m>n have
        # no defined gradient there either)
        from pytensor_tpu_torch.gradient import DisconnectedType, grad_not_implemented
        from pytensor_tpu_torch.graph.null_type import NullType
        from pytensor_tpu_torch.tensor.basic import concatenate, zeros_like

        if self.mode == "raw":
            return [grad_not_implemented(self, 0, inputs[0], "qr mode=raw")]
        (x,) = inputs
        m_s, n_s = x.type.shape
        if self.mode == "r":
            # recompute the reduced factorization: the R-pullback needs Q
            q, r = _core2(QR(mode="reduced"), x)
            (rbar,) = output_grads
            qbar = zeros_like(q)
        else:
            q, r = outputs
            qbar, rbar = output_grads
            if isinstance(getattr(qbar, "type", None), (DisconnectedType, NullType)):
                qbar = zeros_like(q)
            if isinstance(getattr(rbar, "type", None), (DisconnectedType, NullType)):
                rbar = zeros_like(r)
        if m_s is None or n_s is None:
            return [grad_not_implemented(
                self, 0, x, "qr gradient needs static (m, n) to pick the "
                "m>=n / m<n formula")]

        def copyltu(M):
            # tril(M,-1) + tril(M,-1)^T + diag(diagonal(M)) as constant
            # elementwise masks (diag-of-diagonal lowers to scatter+pad)
            from pytensor_tpu_torch.tensor.basic import eye as _eye, tri as _tri

            n_ = M.type.shape[-1]
            if n_ is None:
                from pytensor_tpu_torch.tensor.shape import shape as _shape

                n_ = _shape(M)[-1]
            dt = M.type.dtype
            low = M * _tri(n_, n_, -1, dtype=dt)
            return low + _mT(low) + M * _eye(n_, n_, 0, dtype=dt)

        solve_ut = SolveTriangular(lower=False)
        if self.mode == "complete" and m_s > n_s:
            return [grad_not_implemented(
                self, 0, x, "qr mode=complete with m > n: the extra Q "
                "columns are gauge freedom (reference raises too)")]
        if m_s >= n_s:
            M = matmul(r, _mT(rbar)) - matmul(_mT(qbar), q)
            K = qbar + matmul(q, copyltu(M))
            xbar = _mT(_core2(solve_ut, _conj_r(r), _mT(K)))
            return [xbar]
        # m < n (wide): split A = [X | Y] with X (m, m)
        Y = x[:, m_s:]
        U = r[:, :m_s]
        dU = rbar[:, :m_s]
        dV = rbar[:, m_s:]
        dQ2 = qbar + matmul(Y, _mT(dV))
        M = matmul(U, _mT(dU)) - matmul(_mT(dQ2), q)
        Xbar = _mT(_core2(solve_ut, _conj_r(U),
                          _mT(dQ2 + matmul(q, copyltu(M)))))
        Ybar = matmul(q, dV)
        return [concatenate([Xbar, Ybar], axis=1)]


def _conj_r(r):
    return r


def qr(x, mode="reduced"):
    out_ndims = (2,) if mode == "r" else (2, 2)
    return _core2(QR(mode), x, out_ndims=out_ndims)


class SVD(MatrixOp):
    __props__ = ("full_matrices", "compute_uv")

    def __init__(self, full_matrices=True, compute_uv=True):
        self.full_matrices = bool(full_matrices)
        self.compute_uv = bool(compute_uv)

    @property
    def gufunc_signature(self):
        if not self.compute_uv:
            return "(m,n)->(k)"
        if self.full_matrices:
            return "(m,n)->(m,m),(k),(n,n)"
        return "(m,n)->(m,k),(k),(k,n)"

    def make_node(self, x):
        x = self._check_matrix(x)
        dtype = upcast_float(x.type.dtype)
        m, n = x.type.shape
        k = None if (m is None or n is None) else min(m, n)
        s = TensorType(dtype, (k,))()
        if not self.compute_uv:
            return Apply(self, [x], [s])
        if self.full_matrices:
            u = TensorType(dtype, (m, m))()
            vt = TensorType(dtype, (n, n))()
        else:
            u = TensorType(dtype, (m, k))()
            vt = TensorType(dtype, (k, n))()
        return Apply(self, [x], [u, s, vt])

    def perform(self, node, inputs, output_storage):
        dt = node.outputs[0].type.numpy_dtype
        if self.compute_uv:
            u, s, vt = np.linalg.svd(inputs[0], full_matrices=self.full_matrices)
            output_storage[0][0] = u.astype(dt)
            output_storage[1][0] = s.astype(dt)
            output_storage[2][0] = vt.astype(dt)
        else:
            s = np.linalg.svd(inputs[0], compute_uv=False)
            output_storage[0][0] = s.astype(dt)

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import grad_not_implemented

        (x,) = inputs
        if not self.compute_uv:
            (s,) = outputs
            (sbar,) = output_grads
            # d s_k = u_k^T dX v_k: xbar = U diag(sbar) V^T, with the
            # diagonal factor applied as a column scale (no scatter, one
            # fewer matmul)
            u, s2, vt = SVD(full_matrices=False, compute_uv=True)(x)
            return [matmul(u * sbar.dimshuffle("x", 0), vt)]
        return [grad_not_implemented(self, 0, x, "svd grad with compute_uv")]


def svd(x, full_matrices=True, compute_uv=True):
    return _core2(SVD(full_matrices, compute_uv), x)


class Lu(MatrixOp):
    """PLU decomposition (scipy.linalg.lu with permute_l=False)."""

    __props__ = ("permute_l", "p_indices")

    @property
    def gufunc_signature(self):
        if self.permute_l:
            return "(n,n)->(n,n),(n,n)"
        return "(n,n)->(n,n),(n,n),(n,n)"

    def __init__(self, permute_l=False, p_indices=False):
        self.permute_l = bool(permute_l)
        self.p_indices = bool(p_indices)

    def make_node(self, x):
        x = self._check_matrix(x)
        dtype = upcast_float(x.type.dtype)
        n = x.type.shape[0]
        t = TensorType(dtype, (n, n))
        if self.permute_l:
            return Apply(self, [x], [t(), t()])
        return Apply(self, [x], [t(), t(), t()])

    def perform(self, node, inputs, output_storage):
        import scipy.linalg as sla

        dt = node.outputs[0].type.numpy_dtype
        res = sla.lu(inputs[0], permute_l=self.permute_l)
        for s, r in zip(output_storage, res):
            s[0] = np.asarray(r, dtype=dt)

    def L_op(self, inputs, outputs, output_grads):
        # PLU pullback (standard result, e.g. jax's lu vjp):
        #   F = tril(L^T Lbar, -1) + triu(U bar{U}^T ... ) — concretely
        #   Abar = P L^{-T} (tril(L^T Lbar, -1) + triu(Ubar U^T)) U^{-T}
        from pytensor_tpu_torch.gradient import DisconnectedType, grad_not_implemented
        from pytensor_tpu_torch.graph.null_type import NullType
        from pytensor_tpu_torch.tensor.basic import zeros_like

        (x,) = inputs
        if self.permute_l:
            return [grad_not_implemented(self, 0, x, "permute_l lu grad")]
        P, L, U = outputs
        Pbar, Lbar, Ubar = output_grads
        if isinstance(getattr(Lbar, "type", None), (DisconnectedType, NullType)):
            Lbar = zeros_like(L)
        if isinstance(getattr(Ubar, "type", None), (DisconnectedType, NullType)):
            Ubar = zeros_like(U)
        F = tril(matmul(_mT(L), Lbar), -1) + triu(matmul(Ubar, _mT(U)))
        # Y = L^{-T} F: solve L^T Y = F (L^T upper, unit diagonal)
        Y = _core2(SolveTriangular(lower=False, unit_diagonal=True),
                   _mT(L), F)
        # Z = Y U^{-T} = (U^{-1} Y^T)^T: solve U W = Y^T (U upper)
        Z = _mT(_core2(SolveTriangular(lower=False), U, _mT(Y)))
        return [matmul(P, Z)]


def lu(x, permute_l=False, **kwargs):
    out_ndims = (2, 2) if permute_l else (2, 2, 2)
    return _core2(Lu(permute_l=permute_l), x, out_ndims=out_ndims)


class Expm(MatrixOp):
    __props__ = ()
    gufunc_signature = "(n,n)->(n,n)"

    def make_node(self, x):
        x = self._check_matrix(x)
        return Apply(self, [x], [self._float_type(x)()])

    def perform(self, node, inputs, output_storage):
        import scipy.linalg as sla

        output_storage[0][0] = np.asarray(
            sla.expm(inputs[0]), dtype=node.outputs[0].type.numpy_dtype
        )

    def L_op(self, inputs, outputs, output_grads):
        # Frechet-adjoint via the augmented-matrix identity:
        #   expm([[A^T, Gbar], [0, A^T]]) = [[expm(A^T), L], [0, expm(A^T)]]
        # with L = the adjoint directional derivative -> Abar
        from pytensor_tpu_torch.tensor.basic import concatenate, zeros
        from pytensor_tpu_torch.tensor.shape import shape

        (x,) = inputs
        (gz,) = output_grads
        n = shape(x)[0]
        z = zeros((n, n), dtype=x.type.dtype)
        top = concatenate([_mT(x), gz], axis=1)
        bot = concatenate([z, _mT(x)], axis=1)
        big = concatenate([top, bot], axis=0)
        E = Expm()(big)
        return [E[:n, n:]]


def expm(x):
    return _core2(Expm(), x)


def kron(a, b):
    """Kronecker product built from reshape/transpose."""
    from pytensor_tpu_torch.tensor.shape import reshape, shape

    a = as_tensor_variable(a)
    b = as_tensor_variable(b)
    if a.type.ndim != 2 or b.type.ndim != 2:
        raise TypeError("kron expects matrices")
    sa, sb = shape(a), shape(b)
    out = a.dimshuffle(0, "x", 1, "x") * b.dimshuffle("x", 0, "x", 1)
    return reshape(out, [sa[0] * sb[0], sa[1] * sb[1]], ndim=2)


def matrix_power(m, n):
    m = as_tensor_variable(m)
    n = int(n)
    if n < 0:
        m = inv(m)
        n = -n
    if n == 0:
        return identity_like(m)
    result = None
    z = m
    while n > 0:
        if n % 2:
            result = z if result is None else matmul(result, z)
        n //= 2
        if n:
            z = matmul(z, z)
    return result


def matrix_dot(*args):
    res = args[0]
    for a in args[1:]:
        res = dot(res, a)
    return res


def trace(x, offset=0, axis1=0, axis2=1):
    from pytensor_tpu_torch.tensor.basic import trace as _trace

    return _trace(x, offset, axis1, axis2)


def norm(x, ord=None, axis=None, keepdims=False):
    """np.linalg.norm semantics: matrix norms for 2-d inputs with
    axis=None (max/min column/row sums, spectral, nuclear), vector norms
    otherwise (reference tensor/linalg/summary.py:34)."""
    x = as_tensor_variable(x)
    if axis is None and x.type.ndim == 2:
        absx = tm.abs(x)
        if ord in (None, "fro"):
            return tm.sqrt(pt_sum(tm.sqr(x)))
        if ord == 1:
            return tm.max(pt_sum(absx, axis=0))
        if ord == -1:
            return tm.min(pt_sum(absx, axis=0))
        if ord == np.inf:
            return tm.max(pt_sum(absx, axis=1))
        if ord == -np.inf:
            return tm.min(pt_sum(absx, axis=1))
        if ord == 2:
            return tm.max(svd(x, compute_uv=False))
        if ord == -2:
            return tm.min(svd(x, compute_uv=False))
        if ord == "nuc":
            return pt_sum(svd(x, compute_uv=False))
        raise ValueError(f"invalid matrix norm order {ord!r}")
    if ord is None:
        ord = 2
    return tm.norm(x, ord, axis=axis, keepdims=keepdims)


def solve_discrete_lyapunov(A, Q, method="bilinear"):
    """X - A X A^T = Q via the vectorized (kron) direct method."""
    from pytensor_tpu_torch.tensor.shape import reshape, shape

    A = as_tensor_variable(A)
    Q = as_tensor_variable(Q)
    n = shape(A)[0]
    I = eye(n * n, n * n, 0, dtype=A.type.dtype)
    vecQ = Q.flatten()
    X = solve(I - kron(A, A), vecQ, b_ndim=1)
    return reshape(X, [n, n], ndim=2)


def solve_sylvester(A, B, Q):
    """A X + X B = Q via the Bartels-Stewart vectorized direct method."""
    from pytensor_tpu_torch.tensor.shape import reshape, shape

    A = as_tensor_variable(A)
    B = as_tensor_variable(B)
    Q = as_tensor_variable(Q)
    n = shape(A)[0]
    m = shape(B)[0]
    In = eye(m, m, 0, dtype=A.type.dtype)
    Im = eye(n, n, 0, dtype=A.type.dtype)
    X = solve(kron(In, A) + kron(_mT(B), Im), Q.flatten(), b_ndim=1)
    return reshape(X, [n, m], ndim=2)


class Schur(_HostLapackOp):
    pass


def schur(a, output="real"):
    return Schur(output=output)(a)


class QZ(_HostLapackOp):
    pass


def qz(a, b, output="real"):
    return QZ(output=output)(a, b)


class OrdQZ(_HostLapackOp):
    pass


def ordqz(A, B, sort="lhp", output="real"):
    return OrdQZ(sort=sort, output=output)(A, B)


class SolveDiscreteARE(_HostLapackOp):
    pass


def solve_discrete_are(A, B, Q, R):
    return SolveDiscreteARE()(A, B, Q, R)


class SolveContinuousARE(_HostLapackOp):
    pass


def solve_continuous_are(A, B, Q, R):
    return SolveContinuousARE()(A, B, Q, R)


class GeneralizedEigvalsh(_HostLapackOp):
    pass


class LUFactor(_HostLapackOp):
    pass


def lu_factor(a):
    return LUFactor()(a)


class LUSolve(_HostLapackOp):
    pass


def lu_solve(lu_and_piv, b, trans=0, b_ndim=None):
    return LUSolve(trans=trans, b_ndim=b_ndim)(*lu_and_piv, b)


class PivotToPermutation(_HostLapackOp):
    pass


def pivot_to_permutation(piv):
    return PivotToPermutation()(piv)


class TridiagonalSolve(MatrixOp):
    """Solve tridiag(dl, d, du) x = b.

    Diagonals follow the lax.linalg convention: each has length n with
    ``dl[0]`` and ``du[-1]`` ignored.  PyTensor's
    tensor/linalg/solvers/tridiagonal.py; the JAX package lowers it to
    ``lax.linalg.tridiagonal_solve``, the port to an LU solve of the dense
    tridiagonal matrix (``link/torch/dispatch.py``).
    """

    __props__ = ("b_ndim",)
    core_in_ndims = (1, 1, 1, None)

    def __init__(self, b_ndim=1):
        if b_ndim not in (1, 2):
            raise ValueError("b_ndim must be 1 or 2")
        self.b_ndim = b_ndim
        self.core_in_ndims = (1, 1, 1, b_ndim)
        self.gufunc_signature = ("(n),(n),(n),(n)->(n)" if b_ndim == 1
                                 else "(n),(n),(n),(n,k)->(n,k)")

    def make_node(self, dl, d, du, b):
        dl, d, du, b = map(as_tensor_variable, (dl, d, du, b))
        if b.type.ndim != self.b_ndim:
            raise TypeError(f"b must have ndim={self.b_ndim}")
        dtype = upcast_float(upcast(dl.type.dtype, d.type.dtype,
                                    du.type.dtype, b.type.dtype))
        return Apply(self, [dl, d, du, b], [TensorType(dtype, b.type.shape)()])

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[3]]

    def perform(self, node, inputs, output_storage):
        import scipy.linalg as sla

        dl, d, du, b = (np.asarray(v, dtype=node.outputs[0].type.numpy_dtype)
                        for v in inputs)
        n = d.shape[0]
        ab = np.zeros((3, n), dtype=d.dtype)
        ab[0, 1:] = du[:-1]
        ab[1, :] = d
        ab[2, :-1] = dl[1:]
        output_storage[0][0] = sla.solve_banded((1, 1), ab, b)

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.tensor.basic import concatenate, zeros

        dl, d, du, b = inputs
        (x,) = outputs
        (xbar,) = output_grads
        z1 = zeros((1,), dtype=d.type.dtype)
        # A^T is tridiagonal with dl_T = shift-right(du), du_T = shift-left(dl)
        dl_T = concatenate([z1, du[:-1]])
        du_T = concatenate([dl[1:], z1])
        bbar = tridiagonal_solve(dl_T, d, du_T, xbar, b_ndim=self.b_ndim)
        if self.b_ndim == 1:
            prod = bbar * x
            lo = bbar[1:] * x[:-1]
            hi = bbar[:-1] * x[1:]
        else:
            prod = (bbar * x).sum(axis=-1)
            lo = (bbar[1:] * x[:-1]).sum(axis=-1)
            hi = (bbar[:-1] * x[1:]).sum(axis=-1)
        dbar = -prod
        dlbar = concatenate([z1, -lo])
        dubar = concatenate([-hi, z1])
        return [dlbar, dbar, dubar, bbar]


def tridiagonal_solve(dl, d, du, b, b_ndim=None):
    b = as_tensor_variable(b)
    if b_ndim is None:
        b_ndim = min(b.type.ndim, 2)
    op = TridiagonalSolve(b_ndim=b_ndim)
    return _core2(op, dl, d, du, b)


def lstsq(a, b, rcond=None):
    """Least squares via SVD, composed in-graph (differentiable;
    PyTensor's lstsq wraps LAPACK gelsd).

    Returns (x, residuals, rank, singular_values) like np.linalg.lstsq,
    except ``residuals`` is always the per-column squared residual sum
    (a static shape, where numpy returns an empty array for
    rank-deficient cases).
    """
    from pytensor_tpu_torch.tensor.math import maximum, sum as pt_sum
    from pytensor_tpu_torch.tensor.shape import shape

    a = as_tensor_variable(a)
    b = as_tensor_variable(b)
    u, s, vt = svd(a, full_matrices=False)
    m = shape(a)[-2]
    n = shape(a)[-1]
    if rcond is None:
        from pytensor_tpu_torch.tensor.basic import cast

        eps = np.finfo(np.dtype(upcast_float(a.type.dtype))).eps
        rcond_v = cast(maximum(m, n), s.type.dtype) * eps
    else:
        rcond_v = as_tensor_variable(rcond)
    cutoff = rcond_v * s.max()
    keep = s > cutoff
    s_inv = tm.switch(keep, 1.0 / s, zeros_like(s))
    utb = dot(_mT(u), b)
    if b.type.ndim == 1:
        x = dot(_mT(vt), utb * s_inv)
    else:
        x = dot(_mT(vt), utb * s_inv[:, None])
    r = dot(a, x) - b
    residuals = pt_sum(r * r, axis=0)
    rank = keep.sum().astype("int64")
    return x, residuals, rank, s


def block_diag(*matrices):
    """Block-diagonal assembly (PyTensor's BlockDiagonal op; here a graph
    composition of zeros and concatenations)."""
    from pytensor_tpu_torch.tensor.basic import concatenate, zeros
    from pytensor_tpu_torch.tensor.shape import shape

    mats = [as_tensor_variable(m) for m in matrices]
    if any(m.type.ndim != 2 for m in mats):
        raise TypeError("block_diag expects matrices")
    dtype = upcast(*[m.type.dtype for m in mats])
    mats = [m.astype(dtype) for m in mats]
    rows = []
    for i, m in enumerate(mats):
        row = []
        for j, other in enumerate(mats):
            if i == j:
                row.append(m)
            else:
                row.append(zeros((shape(m)[0], shape(other)[1]), dtype=dtype))
        rows.append(concatenate(row, axis=1))
    return concatenate(rows, axis=0)


def eigvalsh(a, b=None, lower=True):
    """Eigenvalues of a symmetric/hermitian (pencil) matrix."""
    if b is None:
        return eigh(a, UPLO="L" if lower else "U")[0]
    return GeneralizedEigvalsh(lower=lower)(a, b)


def solve_continuous_lyapunov(A, Q):
    """A X + X A^T = Q via the Sylvester direct method."""
    A = as_tensor_variable(A)
    return solve_sylvester(A, _mT(A), Q)


def tensorsolve(a, b, axes=None):
    """np.linalg.tensorsolve semantics via reshape + solve."""
    from pytensor_tpu_torch.tensor.basic import moveaxis

    a = as_tensor_variable(a)
    b = as_tensor_variable(b)
    if axes is not None:
        a = moveaxis(a, list(axes), list(range(-len(axes), 0)))
    rest_nd = a.type.ndim - b.type.ndim
    if None in a.type.shape:
        raise ValueError("tensorsolve needs static shapes")
    prod_rest = int(np.prod(a.type.shape[b.type.ndim:]))
    A2 = a.reshape((-1, prod_rest))
    bv = b.flatten()
    x = solve(A2, bv, b_ndim=1)
    return x.reshape(a.type.shape[b.type.ndim:])


def tensorinv(a, ind=2):
    """np.linalg.tensorinv via reshape + inv."""
    a = as_tensor_variable(a)
    if None in a.type.shape:
        raise ValueError("tensorinv needs static shapes")
    lead = int(np.prod(a.type.shape[:ind]))
    trail = int(np.prod(a.type.shape[ind:]))
    if lead != trail:
        raise ValueError("tensorinv: leading/trailing dims must multiply equal")
    inv2 = inv(a.reshape((lead, trail)))
    return inv2.reshape(a.type.shape[ind:] + a.type.shape[:ind])


# --- reference class-name surface ------------------------------------------
# Real-op aliases (the reference uses these class names; ours differ):
LU = Lu                                  # slinalg.LU
PivotToPermutations = PivotToPermutation  # slinalg.PivotToPermutations
Eigvalsh = GeneralizedEigvalsh           # slinalg.Eigvalsh (pencil eigvals)


class _CompositionalCtor:
    """Reference-constructor compat for capabilities this build lowers
    compositionally instead of as dedicated Ops (PARITY.md §2.5: the
    compositional graphs expose their structure to the generic rewrite
    packs, which the monolithic reference Ops cannot).  Instantiating
    and calling one of these builds exactly the graph of the matching
    function API."""

    _fn = None

    def __init__(self, **kwargs):
        self._kwargs = kwargs

    def __call__(self, *args):
        return type(self)._builder(*args, **self._kwargs)


class KroneckerProduct(_CompositionalCtor):
    """Reference slinalg.KroneckerProduct; builds kron(a, b)."""

    _builder = staticmethod(kron)


class BaseBlockDiagonal(_CompositionalCtor):
    """Reference slinalg.BaseBlockDiagonal."""

    def __init__(self, n_inputs=None, **kwargs):
        super().__init__(**kwargs)
        self.n_inputs = n_inputs


class BlockDiagonal(BaseBlockDiagonal):
    """Reference slinalg.BlockDiagonal; builds block_diag(*mats)."""

    _builder = staticmethod(block_diag)

    def __call__(self, *mats):
        if self.n_inputs is not None and len(mats) != self.n_inputs:
            raise ValueError(
                f"BlockDiagonal expected {self.n_inputs} inputs, "
                f"got {len(mats)}")
        return block_diag(*mats)


class MatrixPinv(_CompositionalCtor):
    """Reference nlinalg.MatrixPinv; builds the SVD/eigh pinv graph."""

    def __init__(self, hermitian=False):
        super().__init__(hermitian=hermitian)
        self.hermitian = hermitian

    _builder = staticmethod(pinv)


class Lstsq(_CompositionalCtor):
    """Reference nlinalg.Lstsq; builds the SVD lstsq graph (4 outputs)."""

    _builder = staticmethod(lstsq)


class TensorInv(_CompositionalCtor):
    """Reference nlinalg.TensorInv; builds the reshape+inv graph."""

    def __init__(self, ind=2):
        super().__init__(ind=ind)
        self.ind = ind

    _builder = staticmethod(tensorinv)


class TensorSolve(_CompositionalCtor):
    """Reference nlinalg.TensorSolve; builds the reshape+solve graph."""

    def __init__(self, axes=None):
        super().__init__(axes=axes)
        self.axes = axes

    _builder = staticmethod(tensorsolve)

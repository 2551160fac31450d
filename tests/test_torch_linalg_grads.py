"""The gradients of the port's linalg ops against the JAX package's, on
the CPU.

For each differentiable op of ``tensor/linalg.py`` (float64, 5 x 5
inputs from ``default_rng(0)``, one matrix and, for the ops the batched
paths run, a batch of three through ``Blockwise``): the port's
``verify_grad`` (central differences of a random projection, the JAX
package's tolerances ``1e-4``), and the port's ``grad`` of ``sum(out * W)``
for a fixed random ``W`` against the JAX package's on its XLA path,
within ``1e-9`` over ``max(1, |want|)`` (both in float64; the two LAPACK
builds round differently).  The outputs are taken in a sign-invariant
form where a factor is unique up to signs (``v ** 2`` of ``eigh``, ``q ** 2``
and ``r ** 2`` of ``qr``); ``eigh``'s vectors take a step of ``1e-6`` in
``verify_grad`` (``EPS``).  An input that the op reads as symmetric
positive definite comes from a parameter ``M`` as ``M M^T + 5 I``, so that
every perturbation keeps it so.
"""

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
import pytensor_tpu.tensor.linalg as jptl

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
import pytensor_tpu_torch.tensor.linalg as tptl

RTOL = 1e-9
N = 5
PKGS = {"jax": (jptt, jpt, jptl), "torch": (tptt, tpt, tptl)}


def _spd(pt, M):
    return pt.dot(M, M.T) + 5.0 * pt.eye(N) if M.type.ndim == 2 else \
        M @ pt.swapaxes(M, -1, -2) + 5.0 * pt.eye(N)


# name -> (input shapes, fun(pt, ptl, *inputs) -> one output)
CASES = {
    "cholesky": ([(N, N)], lambda pt, l, M: l.cholesky(_spd(pt, M))),
    "cholesky_direct": ([(N, N)], None),  # verify_grad on A itself: see below
    "cholesky_upper": ([(N, N)], lambda pt, l, M: l.cholesky(_spd(pt, M), lower=False)),
    "solve_gen": ([(N, N), (N, 3)], lambda pt, l, G, X: l.solve(G + 3.0 * pt.eye(N), X)),
    "solve_pos": ([(N, N), (N,)], lambda pt, l, M, x: l.solve(_spd(pt, M), x, assume_a="pos",
                                                               b_ndim=1)),
    "solve_triangular": ([(N, N), (N, 3)], lambda pt, l, L, X: l.solve_triangular(
        pt.tril(L) + 3.0 * pt.eye(N), X)),
    "solve_triangular_upper_vector": ([(N, N), (N,)], lambda pt, l, L, x: l.solve_triangular(
        pt.triu(L) + 3.0 * pt.eye(N), x, lower=False, b_ndim=1)),
    "cho_solve": ([(N, N), (N, 3)], lambda pt, l, M, X: l.cho_solve(
        (l.cholesky(_spd(pt, M)), True), X)),
    "inv": ([(N, N)], lambda pt, l, G: l.inv(G + 3.0 * pt.eye(N))),
    "det": ([(N, N)], lambda pt, l, G: l.det(G + 3.0 * pt.eye(N))),
    "logdet": ([(N, N)], lambda pt, l, M: l.slogdet(_spd(pt, M))[1]),
    "eigh_values": ([(N, N)], lambda pt, l, M: l.eigh(_spd(pt, M))[0]),
    "eigh_vectors": ([(N, N)], lambda pt, l, M: l.eigh(_spd(pt, M))[1] ** 2),
    "qr_tall": ([(6, 4)], lambda pt, l, R: l.qr(R)[0] ** 2 + pt.sum(l.qr(R)[1] ** 2)),
    "qr_wide": ([(4, 6)], lambda pt, l, W: l.qr(W)[1] ** 2 + pt.sum(l.qr(W)[0] ** 2)),
    "qr_r": ([(6, 4)], lambda pt, l, R: l.qr(R, mode="r") ** 2),
    "svd_values": ([(N, 3)], lambda pt, l, R: l.svd(R, compute_uv=False)),
    "lu": ([(N, N)], lambda pt, l, G: l.lu(G + 3.0 * pt.eye(N))[1]
           + l.lu(G + 3.0 * pt.eye(N))[2]),
    "expm": ([(N, N)], lambda pt, l, G: l.expm(G * 0.2)),
    "tridiagonal": ([(N,), (N,), (N,), (N, 2)], lambda pt, l, a, d, c, X: l.tridiagonal_solve(
        a, d + 4.0, c, X)),
    "batched_cholesky": ([(3, N, N)], lambda pt, l, M: l.cholesky(_spd(pt, M))),
    "batched_solve_triangular": ([(3, N, N), (3, N, 2)], lambda pt, l, L, X:
                                 l.solve_triangular(pt.tril(L) + 3.0 * pt.eye(N), X)),
}
CASES["cholesky_direct"] = ([(N, N)], lambda pt, l, A: l.cholesky(A))
# the step of the differences where the default's truncation error shows:
# the eigenvectors' curvature at the default step gives 1.6e-4 in both
# packages' verify_grad
EPS = {"eigh_vectors": 1e-6}


def _values(shapes, name):
    rng = np.random.default_rng(0)
    vals = [rng.standard_normal(s) for s in shapes]
    if name == "cholesky_direct":
        vals[0] = vals[0] @ vals[0].T + N * np.eye(N)
    return vals


@pytest.mark.parametrize("case", sorted(CASES))
def test_verify_grad(case):
    shapes, fun = CASES[case]
    tptt.verify_grad(lambda *xs: fun(tpt, tptl, *xs), _values(shapes, case),
                     rng=np.random.default_rng(7), eps=EPS.get(case), device="cpu")


@pytest.mark.parametrize("case", sorted(CASES))
def test_grad_matches_jax(case):
    shapes, fun = CASES[case]
    vals = _values(shapes, case)
    res = {}
    for pkg, (ptt, pt, ptl) in PKGS.items():
        xs = [pt.tensor(f"x{k}", dtype="float64", shape=s) for k, s in enumerate(shapes)]
        out = fun(pt, ptl, *xs)
        W = np.random.default_rng(3).standard_normal(out.type.shape)
        grads = ptt.grad(pt.sum(out * W), xs)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        f = ptt.function(xs, [out, *grads], **kw)
        res[pkg] = [o.numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
                    for o in f(*vals)]
    for k, (g, w) in enumerate(zip(res["torch"], res["jax"])):
        assert g.shape == w.shape and g.dtype == w.dtype, (case, k)
        err = np.abs(g - w) / np.maximum(1.0, np.abs(w))
        assert float(err.max(initial=0.0)) <= RTOL, (case, k, float(err.max()))

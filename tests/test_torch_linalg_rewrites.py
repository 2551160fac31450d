"""The port's linalg rewrites against the JAX package's, on the CPU.

Each rewrite of ``tensor/rewriting/linalg.py`` and of the assumptions
engine that the port has, and ``local_useless_dimshuffle``, one of the two
rewrites of ``tensor/rewriting/basic.py`` that the linalg paths added,
fires on a graph built the same way in both packages (``function``, FAST_RUN), as
many times in the port as in the JAX package, and the two rewritten
graphs hold the same ops and give the same values (within ``1e-10`` over
``max(1, |want|)``, float64).  A rewrite is counted where its function
returns a change (``FromFunctionNodeRewriter.transform``, wrapped in each
package for the test).

Then the functions of the slice's three paths at small sizes (the GP SGD
step at n 32 through ``function()`` and as a 3-step ``train_loop``, the GP
marginal likelihood in float64, the Kalman log-likelihood and gradient
over 16 steps, the Kalman SGD step and its 3-step loop, the batched
Cholesky step at batch 4, n 8, and its 3-step loop) rewrite to the JAX
package's graphs op for op: the outer graph and every scan's inner graph,
nested ones too, by op type and scalar op, ``FusedElemwise`` nodes by
their inner ops and ``Blockwise`` nodes by their core op; and the same
rewrites return a change on the way, as many times in both (among them
``local_makevector_cast_fold``, in the batched Cholesky's loop).
"""

import re
from collections import Counter
from contextlib import contextmanager

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.graph.rewriting.basic as jrb
import pytensor_tpu.tensor as jpt
import pytensor_tpu.tensor.linalg as jptl
from pytensor_tpu.assumptions import assume as jassume

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.graph.rewriting.basic as trb
import pytensor_tpu_torch.tensor as tpt
import pytensor_tpu_torch.tensor.linalg as tptl
from pytensor_tpu_torch.assumptions import assume as tassume

PKGS = {"jax": (jptt, jpt, jptl, jassume, jrb), "torch": (tptt, tpt, tptl, tassume, trb)}
RTOL = 1e-10
N = 4


@contextmanager
def _fired(rb):
    """Counts the rewrites that return a change while it is open."""
    counts = Counter()
    orig = rb.FromFunctionNodeRewriter.transform

    def transform(self, fgraph, node):
        res = orig(self, fgraph, node)
        if res:
            counts[self.name] += 1
        return res

    rb.FromFunctionNodeRewriter.transform = transform
    try:
        yield counts
    finally:
        rb.FromFunctionNodeRewriter.transform = orig


def _ops(fgraph, prefix=""):
    c = Counter()
    for node in fgraph.apply_nodes:
        name = type(node.op).__name__
        if name == "Blockwise":
            name = f"Blockwise{{{node.op.core_op}}}"
        elif name in ("Elemwise", "FusedElemwise"):
            name = str(node.op)
        c[prefix + name] += 1
        if type(node.op).__name__ == "Scan":
            c.update(_ops(node.op.fgraph, prefix + "Scan/"))
    return c


def _fgraph(f):
    return f.maker.fgraph if hasattr(f, "maker") else f.fgraph


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _mat(pt, name):
    return pt.tensor(name, dtype="float64", shape=(N, N))


def _vec(pt, name):
    return pt.tensor(name, dtype="float64", shape=(N,))


def _spd(pt, ptl, M):
    return pt.dot(M, M.T) + 4.0 * pt.eye(N)


# rewrite -> build(pt, ptl, assume) -> (inputs, outputs); inputs are
# (N, N) matrices and (N,) vectors named by their first letter
GRAPHS = {
    "local_inv_inv": lambda pt, l, a: _io(pt, "M", lambda M: [l.inv(l.inv(M))]),
    "local_inv_as_solve": lambda pt, l, a: _io(pt, "Mb", lambda M, b: [pt.dot(l.inv(M), b)]),
    "local_log_det_to_slogdet": lambda pt, l, a: _io(
        pt, "M", lambda M: [pt.log(pt.abs(l.det(M)))]),
    "local_solve_of_gram_to_cho_solve": lambda pt, l, a: _io(pt, "Mb", lambda M, b: [
        l.solve(pt.dot(l.cholesky(_spd(pt, l, M)), l.cholesky(_spd(pt, l, M)).T), b,
                b_ndim=1)]),
    "local_solve_of_diagonal": lambda pt, l, a: _io(pt, "Db", lambda D, b: [
        l.solve(a(D, "diagonal"), b, b_ndim=1)]),
    "local_det_of_triangular": lambda pt, l, a: _io(pt, "L", lambda L: [
        l.det(a(L, "lower_triangular"))]),
    "local_inv_of_orthogonal": lambda pt, l, a: _io(pt, "Q", lambda Q: [
        l.inv(a(Q, "orthogonal"))]),
    "local_cholesky_of_diagonal": lambda pt, l, a: _io(pt, "D", lambda D: [
        l.cholesky(a(D, "diagonal"))]),
    "local_slogdet_of_gram": lambda pt, l, a: _io(pt, "M", lambda M: list(l.slogdet(
        pt.dot(l.cholesky(_spd(pt, l, M)), l.cholesky(_spd(pt, l, M)).T)))),
    "local_diagonal_of_diag": lambda pt, l, a: _io(pt, "u", lambda u: [
        pt.diagonal(pt.diag(u)) * 2.0]),
    "local_transpose_of_inv": lambda pt, l, a: _io(pt, "Mb", lambda M, b: [
        pt.dot(l.inv(M).T, b) + 1.0]),
    "local_det_of_inv": lambda pt, l, a: _io(pt, "M", lambda M: [l.det(l.inv(M))]),
    "local_solve_of_inv_to_matmul": lambda pt, l, a: _io(pt, "Mb", lambda M, b: [
        l.solve(l.inv(M), b, b_ndim=1)]),
    "local_paired_triangular_solves_to_cho_solve": lambda pt, l, a: _io(pt, "Mb", lambda M, b: [
        l.solve_triangular(l.cholesky(_spd(pt, l, M)).T, l.solve_triangular(
            l.cholesky(_spd(pt, l, M)), b, lower=True, b_ndim=1), lower=False, b_ndim=1)]),
    "local_orthogonal_solve_to_transpose_matmul": lambda pt, l, a: _io(pt, "Qb", lambda Q, b: [
        l.solve(a(Q, "orthogonal"), b, b_ndim=1)]),
    "local_inv_of_diag_to_reciprocal": lambda pt, l, a: _io(pt, "D", lambda D: [
        l.inv(a(D, "diagonal"))]),
    "local_cholesky_of_gram": lambda pt, l, a: _io(pt, "M", lambda M: [l.cholesky(
        pt.dot(l.cholesky(_spd(pt, l, M)), l.cholesky(_spd(pt, l, M)).T))]),
    "local_svd_uv_merge": lambda pt, l, a: _io(pt, "M", lambda M: [
        l.svd(M, compute_uv=False), l.svd(M)[0] ** 2]),
    "local_log_prod_to_sum_log": lambda pt, l, a: _io(pt, "v", lambda v: [
        pt.log(pt.prod(pt.exp(v)))]),
    "local_eigh_of_diagonal": lambda pt, l, a: _io(pt, "D", lambda D: list(
        l.eigh(a(D, "diagonal")))),
    "local_svd_of_diagonal": lambda pt, l, a: _io(pt, "D", lambda D: list(
        l.svd(a(D, "diagonal")))),
    "local_lu_of_diagonal": lambda pt, l, a: _io(pt, "D", lambda D: list(
        l.lu(a(D, "diagonal")))),
    "local_qr_of_diagonal": lambda pt, l, a: _io(pt, "D", lambda D: list(
        l.qr(a(D, "diagonal")))),
    "local_expm_of_diagonal": lambda pt, l, a: _io(pt, "D", lambda D: [
        l.expm(a(D, "diagonal"))]),
    "local_det_of_permutation": lambda pt, l, a: _io(pt, "P", lambda P: [
        l.det(a(P, "permutation"))]),
    "local_orthogonal_gram_to_eye": lambda pt, l, a: _io(pt, "Qb", lambda Q, b: [
        pt.dot(pt.dot(a(Q, "orthogonal"), Q.T), b)]),
    "local_solve_to_triangular": lambda pt, l, a: _io(pt, "Lb", lambda L, b: [
        l.solve(a(L, "lower_triangular"), b, b_ndim=1)]),
    "local_solve_to_cholesky": lambda pt, l, a: _io(pt, "Ab", lambda A, b: [
        l.solve(a(A, "positive_definite"), b, b_ndim=1)]),
    "local_useless_dimshuffle": lambda pt, l, a: _io(pt, "A", lambda M: [
        l.cholesky(M).dimshuffle(0, 1) * 2.0]),
}


def _io(pt, names, build):
    """Inputs by name: a capital is an (N, N) matrix, ``u`` a vector of
    unknown length, any other an (N,) vector."""
    ins = [_mat(pt, n) if n.isupper() else pt.dvector(n) if n == "u" else _vec(pt, n)
           for n in names]
    return ins, build(*ins)


def _values(names):
    rng = np.random.default_rng(0)
    vals = []
    for n in names:
        if n == "D":
            vals.append(np.diag(rng.random(N) + 1.0))
        elif n == "L":
            vals.append(np.tril(rng.standard_normal((N, N))) + 3 * np.eye(N))
        elif n == "Q":
            vals.append(np.linalg.qr(rng.standard_normal((N, N)))[0])
        elif n == "P":
            vals.append(np.eye(N)[[2, 0, 3, 1]])
        elif n == "A":
            m = rng.standard_normal((N, N))
            vals.append(m @ m.T + N * np.eye(N))
        elif n.isupper():
            vals.append(rng.standard_normal((N, N)) + 3 * np.eye(N))
        else:
            vals.append(rng.standard_normal(N))
    return vals


@pytest.mark.parametrize("rewrite", sorted(GRAPHS))
def test_rewrite_fires_as_in_jax(rewrite):
    res = {}
    for pkg, (ptt, pt, ptl, assume, rb) in PKGS.items():
        def a(v, fact, assume=assume):
            assume(v, fact)
            return v

        with _fired(rb) as fired:
            ins, outs = GRAPHS[rewrite](pt, ptl, a)
            kw = {} if pkg == "jax" else {"device": "cpu"}
            f = ptt.function(ins, outs, **kw)
        names = [i.name for i in ins]
        res[pkg] = (fired, _ops(_fgraph(f)), [_np(o) for o in f(*_values(names))])
    (jfired, jops, jvals), (tfired, tops, tvals) = res["jax"], res["torch"]
    assert jfired[rewrite] >= 1, f"{rewrite} does not fire on this graph in the JAX package"
    assert tfired[rewrite] == jfired[rewrite]
    assert tops == jops
    for g, w in zip(tvals, jvals):
        assert g.shape == w.shape and g.dtype == w.dtype
        err = np.abs(g - w) / np.maximum(1.0, np.abs(w))
        assert float(err.max(initial=0.0)) <= RTOL, (rewrite, float(err.max()))


# --- the slice's functions op for op -------------------------------------------------------

def _functions(pkg):
    """The functions of paths (a)-(c) at small sizes in package ``pkg``."""
    if pkg == "jax":
        import benchsuite
        from pytensor_tpu.compile.sharedvalue import shared
        from pytensor_tpu.models import gp, kalman

        def chol(steps):
            rng = np.random.default_rng(0)
            a = rng.standard_normal((4, 8, 8)).astype("float32")
            A = shared((a @ a.transpose(0, 2, 1) + 8 * np.eye(8, dtype="float32")).astype(
                "float32"), name="A")
            loss = jpt.sum(jptl.cholesky(A) ** 2)
            g = jptt.grad(loss, A)
            scale = np.float32(1.0) + np.float32(1e-7) * jpt.tanh(jpt.mean(g))
            if steps == 1:
                return jptt.function([], loss, updates=[(A, A * scale)])
            return jptt.train_loop([], loss, [(A, A * scale)], n_steps=steps)

        def kal(steps):
            ys, T_true, Z = benchsuite._kalman_sim(16, 4, 2)
            T = shared(T_true.copy(), name="T")
            ll = kalman.kalman_loglike(
                jpt.as_tensor_variable(ys), T, jpt.as_tensor_variable(Z),
                jpt.as_tensor_variable((0.09 * np.eye(4)).astype("float32")),
                jpt.as_tensor_variable((0.04 * np.eye(2)).astype("float32")),
                jpt.as_tensor_variable(np.zeros(4, "float32")),
                jpt.as_tensor_variable(np.eye(4, dtype="float32")))
            upd = [(T, T + np.float32(1e-5) * jptt.grad(ll, T))]
            if steps == 1:
                return jptt.function([], ll, updates=upd)
            return jptt.train_loop([], ll, upd, n_steps=steps)

        return {"gp step": lambda: gp.make_gp_sgd_step(32, dtype="float32")[0],
                "gp loop": lambda: gp.make_gp_sgd_step(32, dtype="float32",
                                                       n_steps_per_call=3)[0],
                "gp mll": lambda: gp.make_gp_marginal_likelihood(32)[0],
                "kalman": lambda: kalman.make_kalman_loglike_and_grad(16, dtype="float32")[0],
                "kalman step": lambda: kal(1), "kalman loop": lambda: kal(3),
                "chol step": lambda: chol(1), "chol loop": lambda: chol(3)}
    from pytensor_tpu_torch.models import batched_cholesky as bc, gp, kalman

    return {"gp step": lambda: gp.make_gp_sgd_step(32, dtype="float32", device="cpu")[0],
            "gp loop": lambda: gp.make_gp_sgd_step(32, dtype="float32", n_steps_per_call=3,
                                                   device="cpu")[0],
            "gp mll": lambda: gp.make_gp_marginal_likelihood(32, device="cpu")[0],
            "kalman": lambda: kalman.make_kalman_loglike_and_grad(16, dtype="float32",
                                                                  device="cpu")[0],
            "kalman step": lambda: kalman.make_kalman_sgd_step(16, device="cpu")[0],
            "kalman loop": lambda: kalman.make_kalman_sgd_step(16, n_steps_per_call=3,
                                                               device="cpu")[0],
            "chol step": lambda: bc.make_batched_cholesky_step(4, 8, device="cpu")[0],
            "chol loop": lambda: bc.make_batched_cholesky_step(4, 8, n_steps_per_call=3,
                                                               device="cpu")[0]}


@pytest.mark.parametrize("path", ["gp step", "gp loop", "gp mll", "kalman", "kalman step",
                                  "kalman loop", "chol step", "chol loop"])
def test_path_rewrites_to_the_jax_packages_graph(path):
    with _fired(jrb) as jfired:
        jf = _functions("jax")[path]()
    with _fired(trb) as tfired:
        tf = _functions("torch")[path]()
    assert _ops(_fgraph(tf)) == _ops(_fgraph(jf))
    assert tfired == jfired
    assert tf.linked.host_reads == []
    if path == "kalman":
        # the forward body's two triangular solves became one CholeskySolve,
        # and the gradient's factorisations and solves left the reverse
        # scan as Blockwise nodes
        ops = _ops(_fgraph(tf))
        assert ops["Scan/CholeskySolve"] == 1
        assert ops["Blockwise{Cholesky{lower=True}}"] == 1
        assert sum(n for k, n in ops.items()
                   if re.match(r"Blockwise\{SolveTriangular", k)) == 4

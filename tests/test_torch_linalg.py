"""The port's linalg ops against the JAX package's, on the CPU.

Each ported op of ``tensor/linalg.py`` (``Cholesky``, ``Solve``,
``SolveTriangular``, ``CholeskySolve``, ``MatrixInverse``, ``Det``,
``SLogDet``, ``Eigh``, ``QR``, ``SVD``, ``Lu``, ``Expm``,
``TridiagonalSolve``), in float32 and float64, on one matrix and on a
batch of three (through ``Blockwise``, which the port runs as one call of
the batched lowering), and each graph-level function (``pinv``, ``kron``,
``matrix_power``, ``norm``, ``lstsq``, the Lyapunov and Sylvester solvers,
...) goes through the JAX package's XLA path and the port's
``function`` on the same numpy inputs (``default_rng(0)``).  Where a
factorisation is unique only up to signs (the eigenvectors, QR's and
SVD's factors) both sides are brought to one sign first.  Tolerance: the
error over ``max(1, |want|)`` within ``1e-5`` in float32 and ``1e-10`` in
float64: the two packages call different LAPACK builds on these
well-conditioned 5 x 5 inputs, which round differently.

Then the contracts: a Cholesky of a matrix that is not positive definite
is NaN in its whole lower triangle on the linked path under both
``on_error`` values, as on XLA's, while the oracle raises; only the lower triangle is
read (Cholesky, Eigh); the per-element ``Blockwise`` route and the
batched one agree; the host-LAPACK ops raise ``NotImplementedError``.
The gradients are in ``test_torch_linalg_grads.py``.
"""

import warnings

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
import pytensor_tpu.tensor.linalg as jptl

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
import pytensor_tpu_torch.tensor.linalg as tptl
from pytensor_tpu_torch.link.torch.dispatch import torch_funcify

RTOL = {"float32": 1e-5, "float64": 1e-10}
N, BATCH = 5, 3
PKGS = {"jax": (jptt, jpt, jptl), "torch": (tptt, tpt, tptl)}


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _spd(rng, *lead):
    a = rng.standard_normal((*lead, N, N))
    return a @ np.swapaxes(a, -1, -2) + N * np.eye(N)


def _general(rng, *lead):
    return rng.standard_normal((*lead, N, N)) + 3 * np.eye(N)


def _lower(rng, *lead):
    return np.tril(rng.standard_normal((*lead, N, N))) + 3 * np.eye(N)


def _values(rng):
    """The named inputs, one of each and a batch of each."""
    v = {}
    for tag, lead in (("", ()), ("b", (BATCH,))):
        v["A" + tag] = _spd(rng, *lead)
        v["G" + tag] = _general(rng, *lead)
        v["L" + tag] = _lower(rng, *lead)
        v["x" + tag] = rng.standard_normal((*lead, N))
        v["X" + tag] = rng.standard_normal((*lead, N, 3))
        v["R" + tag] = rng.standard_normal((*lead, 6, 4))
        v["W" + tag] = rng.standard_normal((*lead, 3, 6))
    return v


def _colsign(m, axis=-2):
    """Each column (axis -2 vectors) times the sign of its largest entry."""
    idx = np.argmax(np.abs(m), axis=axis)
    s = np.sign(np.take_along_axis(m, np.expand_dims(idx, axis), axis))
    return m * s


def _qr_canon(q, r):
    s = np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., None, :]
    return [q * s, r * np.swapaxes(s, -1, -2)]


def _svd_canon(u, s, vt):
    """U's columns to the sign of their largest entry, and the rows of
    V^T that pair with them to the same signs."""
    idx = np.argmax(np.abs(u), axis=-2)[..., None, :]
    sign = np.sign(np.take_along_axis(u, idx, -2))
    k = s.shape[-1]
    vt = vt.copy()
    vt[..., :k, :] *= np.swapaxes(sign[..., :k], -1, -2)
    return [u * sign, s, vt]


# name -> (the inputs it reads, build(pt, ptl, *inputs) -> outputs, the outputs'
# sign-canonical form); a right-hand side that is a vector says so (``b_ndim=1``), as
# a batch of vectors would otherwise be read as one matrix
CORE = {
    "cholesky": ("A", lambda pt, l, A: [l.cholesky(A)], None),
    "cholesky_upper": ("A", lambda pt, l, A: [l.cholesky(A, lower=False)], None),
    "solve_gen_vector": ("Gx", lambda pt, l, G, x: [l.solve(G, x, b_ndim=1)], None),
    "solve_gen_matrix": ("GX", lambda pt, l, G, X: [l.solve(G, X)], None),
    "solve_pos": ("AX", lambda pt, l, A, X: [l.solve(A, X, assume_a="pos")], None),
    "solve_sym": ("Ax", lambda pt, l, A, x: [l.solve(A, x, assume_a="sym", b_ndim=1)], None),
    "solve_triangular_lower": ("Lx", lambda pt, l, L, x: [l.solve_triangular(L, x, b_ndim=1)], None),
    "solve_triangular_upper": ("LX", lambda pt, l, L, X: [
        l.solve_triangular(pt.swapaxes(L, -1, -2), X, lower=False)], None),
    "solve_triangular_trans": ("LX", lambda pt, l, L, X: [
        l.solve_triangular(L, X, trans=1)], None),
    "solve_triangular_unit": ("Lx", lambda pt, l, L, x: [
        l.solve_triangular(L, x, unit_diagonal=True, b_ndim=1)], None),
    "cho_solve_lower": ("LX", lambda pt, l, L, X: [l.cho_solve((L, True), X)], None),
    "cho_solve_upper": ("Lx", lambda pt, l, L, x: [
        l.cho_solve((pt.swapaxes(L, -1, -2), False), x, b_ndim=1)], None),
    "inv": ("G", lambda pt, l, G: [l.inv(G)], None),
    "det": ("G", lambda pt, l, G: [l.det(G)], None),
    "slogdet": ("G", lambda pt, l, G: list(l.slogdet(G)), None),
    "eigh": ("A", lambda pt, l, A: list(l.eigh(A)), lambda w, v: [w, _colsign(v)]),
    "eigh_upper": ("A", lambda pt, l, A: list(l.eigh(A, UPLO="U")),
                   lambda w, v: [w, _colsign(v)]),
    "qr_reduced": ("R", lambda pt, l, R: list(l.qr(R)), _qr_canon),
    "qr_complete_square": ("G", lambda pt, l, G: list(l.qr(G, mode="complete")), _qr_canon),
    "qr_r": ("R", lambda pt, l, R: [l.qr(R, mode="r")],
             lambda r: [r * np.sign(np.diagonal(r, axis1=-2, axis2=-1))[..., :, None]]),
    "svd_full": ("G", lambda pt, l, G: list(l.svd(G)), _svd_canon),
    "svd_reduced": ("R", lambda pt, l, R: list(l.svd(R, full_matrices=False)), _svd_canon),
    "svd_values": ("W", lambda pt, l, W: [l.svd(W, compute_uv=False)], None),
    "lu": ("G", lambda pt, l, G: list(l.lu(G)), None),
    "lu_permute_l": ("G", lambda pt, l, G: list(l.lu(G, permute_l=True)), None),
    "expm": ("G", lambda pt, l, G: [l.expm(G * 0.2)], None),
    "tridiagonal_vector": ("Gx", lambda pt, l, G, x: [l.tridiagonal_solve(
        G[..., 0, :], G[..., 1, :], G[..., 2, :], x, b_ndim=1)], None),
    "tridiagonal_matrix": ("GX", lambda pt, l, G, X: [l.tridiagonal_solve(
        G[..., 0, :], G[..., 1, :] + 4.0, G[..., 2, :], X, b_ndim=2)], None),
}


def _compile(build, names, dtype, batched):
    fns = {}
    for pkg, (ptt, pt, ptl) in PKGS.items():
        ins = [pt.tensor(n, dtype=dtype, shape=((BATCH,) if batched else ()) + SHAPES[n])
               for n in names]
        outs = build(pt, ptl, *ins)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        fns[pkg] = ptt.function(ins, outs, **kw)
    return fns


SHAPES = {"A": (N, N), "G": (N, N), "L": (N, N), "x": (N,), "X": (N, 3), "R": (6, 4),
          "W": (3, 6)}


def _held(got, want, dtype, what):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert str(got.dtype) == str(want.dtype), (what, got.dtype, want.dtype)
    err = np.abs(got.astype("float64") - want.astype("float64")) / np.maximum(
        1.0, np.abs(want.astype("float64")))
    assert float(err.max(initial=0.0)) <= RTOL[dtype], (what, float(err.max()))


@pytest.mark.parametrize("batched", [False, True], ids=["one", "blockwise"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(CORE))
def test_op_matches_jax(case, dtype, batched):
    names, build, canon = CORE[case]
    vals = _values(np.random.default_rng(0))
    args = [vals[n + ("b" if batched else "")].astype(dtype) for n in names]
    fns = _compile(build, names, dtype, batched)
    want = [_np(w) for w in fns["jax"](*args)]
    got = [_np(g) for g in fns["torch"](*args)]
    if batched:
        assert any(type(n.op).__name__ == "Blockwise" for n in fns["torch"].fgraph.apply_nodes)
    if canon is not None:
        want, got = canon(*want), canon(*got)
    for k, (g, w) in enumerate(zip(got, want)):
        _held(g, w, dtype, f"{case} output {k}")


# --- the graph-level functions ----------------------------------------------------------

def _tensors(pt, dtype, **shapes):
    return {k: pt.tensor(k, dtype=dtype, shape=s) for k, s in shapes.items()}


FUNCTIONS = {
    "pinv": (dict(R=(6, 4)), lambda pt, l, v: [l.pinv(v["R"])]),
    "pinv_hermitian": (dict(A=(N, N)), lambda pt, l, v: [l.pinv(v["A"], hermitian=True)]),
    "kron": (dict(G=(N, N), R=(6, 4)), lambda pt, l, v: [l.kron(v["G"], v["R"])]),
    "matrix_power_3": (dict(G=(N, N)), lambda pt, l, v: [l.matrix_power(v["G"], 3)]),
    "matrix_power_-2": (dict(G=(N, N)), lambda pt, l, v: [l.matrix_power(v["G"], -2)]),
    "matrix_power_0": (dict(G=(N, N)), lambda pt, l, v: [l.matrix_power(v["G"], 0)]),
    "matrix_dot": (dict(G=(N, N), A=(N, N), X=(N, 3)),
                   lambda pt, l, v: [l.matrix_dot(v["G"], v["A"], v["X"])]),
    "trace": (dict(G=(N, N)), lambda pt, l, v: [l.trace(v["G"])]),
    "norms": (dict(G=(N, N), x=(N,)), lambda pt, l, v: [
        l.norm(v["G"], o) for o in (None, "fro", 1, -1, np.inf, -np.inf, 2, -2, "nuc")]
        + [l.norm(v["x"]), l.norm(v["x"], 1), l.norm(v["G"], axis=0)]),
    "block_diag": (dict(G=(N, N), R=(6, 4)),
                   lambda pt, l, v: [l.block_diag(v["G"], v["R"]), l.BlockDiagonal(2)(v["G"],
                                                                                     v["R"])]),
    "lstsq": (dict(R=(6, 4), y=(6,)), lambda pt, l, v: list(l.lstsq(v["R"], v["y"]))
              + [l.Lstsq()(v["R"], v["y"])[0]]),
    "tensorsolve": (dict(T=(2, 3, 6), Y=(2, 3)), lambda pt, l, v: [
        l.tensorsolve(v["T"], v["Y"]), l.TensorSolve()(v["T"], v["Y"])]),
    "tensorinv": (dict(T=(2, 3, 6)), lambda pt, l, v: [
        l.tensorinv(v["T"], ind=2), l.TensorInv(ind=2)(v["T"])]),
    "lyapunov_sylvester": (dict(G=(N, N), A=(N, N)), lambda pt, l, v: [
        l.solve_discrete_lyapunov(v["G"] * 0.2, v["A"]),
        l.solve_sylvester(v["G"], v["A"], v["A"] - v["G"]),
        l.solve_continuous_lyapunov(v["G"], v["A"])]),
    "compositional": (dict(G=(N, N), R=(6, 4)), lambda pt, l, v: [
        l.KroneckerProduct()(v["G"], v["R"]), l.MatrixPinv()(v["R"]),
        l.MatrixPinv(hermitian=True)(v["G"] + v["G"].T + 6.0 * pt.eye(N)), l.logdet(v["G"] @ v["G"].T)]),
    "sort": (dict(x=(N,), G=(N, N)), lambda pt, l, v: [
        pt.sort(v["x"]), pt.argsort(v["x"]), pt.sort(v["G"], axis=0), pt.argsort(v["G"], axis=None),
        v["G"].sort(axis=1), v["x"].argsort()]),
}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(FUNCTIONS))
def test_function_matches_jax(case, dtype):
    shapes, build = FUNCTIONS[case]
    rng = np.random.default_rng(1)
    vals = {k: (rng.standard_normal(s) + (3 * np.eye(*s) if len(s) == 2 and s[0] == s[1] else 0))
            .astype(dtype) for k, s in shapes.items()}
    if "A" in vals:
        vals["A"] = (vals["A"] @ vals["A"].T).astype(dtype)
    if case == "tensorinv":
        vals["T"] = (vals["T"] + 3 * np.eye(6).reshape(2, 3, 6)).astype(dtype)
    if case == "tensorsolve":
        vals["T"] = (rng.standard_normal((2, 3, 6)) + 3 * np.eye(6).reshape(2, 3, 6)).astype(dtype)
    got_want = []
    for pkg, (ptt, pt, ptl) in PKGS.items():
        v = _tensors(pt, dtype, **shapes)
        outs = build(pt, ptl, v)
        kw = {} if pkg == "jax" else {"device": "cpu"}
        f = ptt.function(list(v.values()), outs, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            got_want.append([_np(o) for o in f(*vals.values())])
    want, got = got_want
    for k, (g, w) in enumerate(zip(got, want)):
        if w.dtype.kind in "iub":
            np.testing.assert_array_equal(g, w, err_msg=f"{case} output {k}")
        else:
            _held(g, w, str(w.dtype), f"{case} output {k}")


# --- the contracts ------------------------------------------------------------------------

@pytest.mark.parametrize("on_error", ["raise", "nan"])
def test_cholesky_of_a_matrix_not_positive_definite_is_nan(on_error):
    """The linked path gives NaN in the lower triangle of the failing
    matrix (zeros above), as XLA's Cholesky does (a raise on the card would
    read ``info`` on the host every call); in a batch only the failing
    matrix, and a solve through it is NaN.  The oracle raises."""
    bad = np.array([[1.0, 2.0], [2.0, 1.0]])
    good = np.array([[4.0, 2.0], [2.0, 3.0]])
    outs = {}
    for pkg, (ptt, pt, ptl) in PKGS.items():
        A = pt.tensor("A", dtype="float64", shape=(None, 2, 2))
        kw = {} if pkg == "jax" else {"device": "cpu"}
        f = ptt.function([A], ptl.cholesky(A, on_error=on_error), **kw)
        outs[pkg] = _np(f(np.stack([good, bad])))
    np.testing.assert_array_equal(outs["torch"], outs["jax"])
    assert np.isnan(np.tril(outs["torch"][1])[np.tril_indices(2)]).all()
    assert (np.triu(outs["torch"][1], 1) == 0).all()
    np.testing.assert_allclose(outs["torch"][0], np.linalg.cholesky(good), rtol=1e-12)
    M = tpt.dmatrix("M")
    single = tptt.function([M], [tptl.cholesky(M, on_error=on_error),
                                 tptl.solve(M, tpt.ones(2), assume_a="pos", b_ndim=1)],
                           device="cpu")
    L, x = (_np(o) for o in single(bad))
    np.testing.assert_array_equal(L, outs["torch"][1])
    assert np.isnan(x).all()
    J = jpt.dmatrix("J")
    oracle = jptt.function([J], jptl.cholesky(J), mode="FAST_COMPILE")
    with pytest.raises(np.linalg.LinAlgError):
        oracle(bad)
    node = tptl.cholesky(tpt.dmatrix("C")).owner
    with pytest.raises(np.linalg.LinAlgError):
        node.op.perform(node, [bad], [[None]])


@pytest.mark.parametrize("op", ["cholesky", "eigh"])
def test_only_the_lower_triangle_is_read(op):
    rng = np.random.default_rng(3)
    A = _spd(rng)
    garbage = np.tril(A) + np.triu(rng.standard_normal((N, N)) * 100, 1)
    res = {}
    for pkg, (ptt, pt, ptl) in PKGS.items():
        M = pt.dmatrix("M")
        out = ptl.cholesky(M) if op == "cholesky" else ptl.eigh(M)[0]
        kw = {} if pkg == "jax" else {"device": "cpu"}
        f = ptt.function([M], out, **kw)
        res[pkg] = (_np(f(A)), _np(f(garbage)))
    np.testing.assert_array_equal(res["torch"][0], res["torch"][1])
    np.testing.assert_allclose(res["torch"][1], res["jax"][1], rtol=1e-10)


def _batched_off(core_op_type):
    """The lowering of ``core_op_type`` with its ``batched`` declaration
    turned off, so that a ``Blockwise`` of it runs once per element."""
    lowering = torch_funcify.dispatch(core_op_type)
    saved = dict(lowering.ports)
    lowering.ports["batched"] = False
    return lowering, saved


@pytest.mark.parametrize("case", ["cholesky", "solve_pos", "solve_triangular_trans",
                                  "cho_solve_lower", "inv", "slogdet", "qr_reduced", "lu",
                                  "tridiagonal_matrix"])
def test_per_element_route_matches_the_batched_one(case):
    from pytensor_tpu_torch.tensor.blockwise import Blockwise

    names, build, canon = CORE[case]
    vals = _values(np.random.default_rng(2))
    args = [vals[n + "b"] for n in names]
    f = _compile(build, names, "float64", True)["torch"]
    batched = [_np(o) for o in f(*args)]
    cores = {type(n.op.core_op) for n in f.fgraph.apply_nodes if isinstance(n.op, Blockwise)}
    saved = [_batched_off(t) for t in cores]
    try:
        per_element = [_np(o) for o in _compile(build, names, "float64", True)["torch"](*args)]
    finally:
        for lowering, ports in saved:
            lowering.ports = ports
    for b, p in zip(batched, per_element):
        np.testing.assert_allclose(b, p, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("name", ["eig", "schur", "qz", "ordqz", "solve_discrete_are",
                                  "solve_continuous_are", "lu_factor", "lu_solve",
                                  "pivot_to_permutation", "eigvalsh_pencil"])
def test_host_lapack_ops_raise(name):
    A = tpt.dmatrix("A")
    calls = {"eig": lambda: tptl.eig(A), "schur": lambda: tptl.schur(A),
             "qz": lambda: tptl.qz(A, A), "ordqz": lambda: tptl.ordqz(A, A),
             "solve_discrete_are": lambda: tptl.solve_discrete_are(A, A, A, A),
             "solve_continuous_are": lambda: tptl.solve_continuous_are(A, A, A, A),
             "lu_factor": lambda: tptl.lu_factor(A),
             "lu_solve": lambda: tptl.lu_solve((A, tpt.lvector("p")), tpt.dvector("b")),
             "pivot_to_permutation": lambda: tptl.pivot_to_permutation(tpt.ivector("p")),
             "eigvalsh_pencil": lambda: tptl.eigvalsh(A, A)}
    with pytest.raises(NotImplementedError, match="ROADMAP.md Queue 1 item 17"):
        calls[name]()

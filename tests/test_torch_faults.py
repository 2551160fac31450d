"""Thirteen faults once found in the port, each held against the JAX
package (the eleventh against numpy: the JAX package has it too).

The same numpy inputs go through ``function()`` of both packages on the
CPU (FAST_RUN in both), and the port must give what the JAX package gives:

1. an output never shares memory with a shared variable, so a later
   update by another function does not change it in the caller's hands,
   while an output that shares memory with nothing is not copied;
2. and 3. ``sqr`` and ``abs`` of a bool tensor are bool, alone and fused;
4. ``sigmoid`` of an integer tensor builds a graph and is refused with a
   ``TypeError`` when its function is built or run;
5. ``grad(sum(sqrt(sqr(x))), x)`` rewrites to ``sign(x)`` op for op, so
   it is finite at 0 and keeps the sign of -0.0;

and the five of ROADMAP Queue 3 (repaired together):

6. the rewrites that change a value: the identities at NaN and inf
   (``x == x``, ``x % x``, ``0 / x``) and the stabilisations (``log(1 +
   x)``, ``log(sum(exp(x)))``, ``log(1 + exp(x))`` and its gradient,
   ...), each at the reference's value;
7. ``sum``, ``mean`` and ``.shape`` of ``x[x > 0]``, their gradients and
   ``set_``/``inc_subtensor`` of ``x[x > 0]`` (a bare ``x[x > 0]`` still
   raises, in both packages);
8. an advanced index beside a negative-step slice, read and written;
9. ``uint16``, ``uint32`` and ``uint64``: held in int64, compared,
   divided and converted as unsigned (``sum`` of three uint8 200s is 600,
   uint64);
10. ``QR(mode="raw")``: numpy's ``(h, tau)``;

and one found with the complex dtypes:

11. the constant-folding rewrites (``local_mul_div_canonizer``, the add
    canonizer, ``x / 1``, ``0 / x``) read a constant through ``float()``,
    which drops a complex constant's imaginary part: ``z * 2j * 3`` was 0
    and ``complex_from_polar`` real.  A complex constant with an imaginary
    part is no longer a foldable scalar (``tensor/rewriting/math.py
    _unique_value``).  The JAX package keeps the fault (pinned; ROADMAP
    Queue 3).

and one found in the port's batched index write:

12. a ``Blockwise`` of ``set_``/``inc_subtensor`` by one integer index (a
    vectorized ``jacobian``'s row, one scatter on the device) clamped an
    index out of range into the edge row and wrote there; the JAX
    package's ``x.at[i]`` scatter drops that update, and a negative index
    counts from the end in both.

and the one of ROADMAP Queue 3 item 1:

13. twenty-three rewrites of the JAX package's ``tensor/rewriting/math.py``
    that the port lacked: the twenty-two that the probe of
    ``tests/torch_math_probe.py`` shows to change a value (``log(-expm1(-x))``
    2.6e-8 off in relative terms, ``log(1 / x)`` NaN at -0.0, ``exp(x)**3``
    34 ulps, ...) and ``local_odd_fn_of_neg``, which it named.  Each graph
    is op for op the JAX package's, each rewrite fires as often, and the
    values are within the ulps stated for each graph: what torch's and
    XLA's own functions (``sinh``, ``log1mexp``, ...) differ by.

and one found with the sparse module:

14. a function whose output is sparse raised (``'CSR' object has no
    attribute 'untyped_storage'``).  It now returns a torch sparse
    compressed tensor in the output's format (csr or csc) on the
    function's device, where the JAX package returns a scipy matrix
    (``FAST_COMPILE``) or a BCOO (its XLA path), with the oracle's
    structure; it takes such a tensor as an input; and an output whose
    buffers are a shared variable's is copied, as a dense one is.

Values are compared exactly (bools, signs of zero) or at ``rtol 1e-12``.
"""

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt

JAX = (jptt, jpt, {})
PORT = (tptt, tpt, {"device": "cpu"})


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


@pytest.mark.parametrize("view", ["whole", "slice"])
def test_outputs_do_not_alias_shared_variables_across_functions(view):
    """``function([], x)`` and ``function([], x[1:])`` return what the
    shared variable held when they ran, after a third function updates
    it."""
    held = []
    for ptt, pt, kw in (JAX, PORT):
        x = ptt.shared(np.zeros(3), name="x", **kw)
        read = ptt.function([], x if view == "whole" else x[1:], **kw)
        bump = ptt.function([], [], updates={x: x + 1.0}, **kw)
        before = read()
        bump()
        held.append((_np(before), _np(read()), _np(x.get_value())))
    (j_before, j_after, j_x), (t_before, t_after, t_x) = held
    np.testing.assert_array_equal(j_before, np.zeros(3 if view == "whole" else 2))
    for t, j in ((t_before, j_before), (t_after, j_after), (t_x, j_x)):
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_array_equal(t, j)


def test_only_outputs_that_alias_a_shared_variable_are_copied(monkeypatch):
    """Of ``[x, x * 2, y + 1]`` only ``x`` is copied: one clone a call."""
    x = tptt.shared(np.arange(3.0), name="x", device="cpu")
    y = tpt.tensor("y", dtype="float64", shape=(3,))
    f = tptt.function([y], [x, x * 2.0, y + 1.0], device="cpu")
    clones = []
    clone = torch.Tensor.clone

    def counted(self, *args, **kwargs):
        clones.append(self)
        return clone(self, *args, **kwargs)

    monkeypatch.setattr(torch.Tensor, "clone", counted)
    out = f(torch.ones(3, dtype=torch.float64))
    assert len(clones) == 1
    shared_ptr = x.get_value(borrow=True).untyped_storage().data_ptr()
    assert out[0].untyped_storage().data_ptr() != shared_ptr
    np.testing.assert_array_equal(out[0].numpy(), [0.0, 1.0, 2.0])
    np.testing.assert_array_equal(out[2].numpy(), [2.0, 2.0, 2.0])


# name -> the inputs used, and the graph over the bool vectors b, c
_BOOL_GRAPHS = {
    "sqr": (1, lambda pt, b, c: pt.sqr(b)),
    "abs": (1, lambda pt, b, c: pt.abs(b)),
    "fused": (2, lambda pt, b, c: pt.sqr(b) * c + pt.abs(c)),
}


@pytest.mark.parametrize("name", sorted(_BOOL_GRAPHS))
def test_sqr_and_abs_of_bool_are_bool_like_jax(name):
    n_in, build = _BOOL_GRAPHS[name]
    vals = list(np.random.default_rng(5).integers(0, 2, size=(2, 7)).astype(bool))[:n_in]
    outs = []
    for ptt, pt, kw in (JAX, PORT):
        b = pt.tensor("b", dtype="bool", shape=(7,))
        c = pt.tensor("c", dtype="bool", shape=(7,))
        y = build(pt, b, c)
        assert y.type.dtype == "bool"
        outs.append(_np(ptt.function([b, c][:n_in], y, **kw)(*vals)))
    j, t = outs
    assert j.dtype == t.dtype == np.bool_
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("graph", ["alone", "fused"])
def test_sigmoid_of_integers_is_refused_like_jax(graph):
    vals = np.array([1, -2, 3], dtype="int32")
    for ptt, pt, kw in (JAX, PORT):
        i = pt.tensor("i", dtype="int32", shape=(3,))
        y = pt.sigmoid(i) if graph == "alone" else pt.sigmoid(i) * 2.0 + 1.0
        assert y.type.dtype == "float64"  # the graph itself builds
        with pytest.raises(TypeError, match="int32"):
            ptt.function([i], y, **kw)(vals)
    # on floats it runs, and agrees
    outs = []
    for ptt, pt, kw in (JAX, PORT):
        x = pt.tensor("x", dtype="float64", shape=(3,))
        f = ptt.function([x], pt.sigmoid(x) * 2.0 + 1.0, **kw)
        outs.append(_np(f(vals.astype("float64"))))
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-12)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_grad_of_sqrt_sqr_is_sign_like_jax(dtype):
    vals = np.array([0.0, -0.0, 2.0, -3.0], dtype=dtype)
    graphs, outs = [], []
    for ptt, pt, kw in (JAX, PORT):
        x = pt.tensor("x", dtype=dtype, shape=(4,))
        f = ptt.function([x], ptt.grad(pt.sum(pt.sqrt(pt.sqr(x))), x), **kw)
        graphs.append([str(nd.op) for nd in f.fgraph.toposort()])
        outs.append(_np(f(vals)))
    assert graphs[1] == graphs[0] == ["Elemwise{sign}"]
    j, t = outs
    assert t.dtype == j.dtype == np.dtype(dtype)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t, [0.0, 0.0, 1.0, -1.0])
    np.testing.assert_array_equal(np.signbit(t), [False, True, False, True])
    np.testing.assert_array_equal(np.signbit(t), np.signbit(j))


# --- ROADMAP Queue 3's five faults ------------------------------------------------

def _both(build, values, dtype="float64"):
    """The outputs of ``function(inputs, build(ptt, pt, *inputs))`` on
    ``values`` in the JAX package, then the port."""
    res = []
    for ptt, pt, kw in (JAX, PORT):
        ins = [pt.tensor(f"x{k}", dtype=str(np.asarray(v).dtype) if dtype is None else dtype,
                         shape=(None,) * np.ndim(v)) for k, v in enumerate(values)]
        out = ptt.function(ins, build(ptt, pt, *ins), **kw)(*[
            np.asarray(v) if dtype is None else np.asarray(v, dtype=dtype) for v in values])
        res.append([_np(o) for o in (out if isinstance(out, list) else [out])])
    return res


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape, (g.dtype, w.dtype, g.shape, w.shape)
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-12)


EDGES = [np.nan, 0.0, 2.0, np.inf]


@pytest.mark.parametrize("build,values,want", [
    (lambda p, t, x: t.eq(x, x), [EDGES], [True] * 4),
    (lambda p, t, x: t.le(x, x), [EDGES], [True] * 4),
    (lambda p, t, x: t.ge(x, x), [EDGES], [True] * 4),
    (lambda p, t, x: x % x, [EDGES], [0.0] * 4),
    (lambda p, t, x: 0 / x, [EDGES], [0.0] * 4),
    (lambda p, t, x: t.log(1 + x), [[1e-20]], [1e-20]),
    (lambda p, t, x: t.log(1 - x), [[1e-20]], [-1e-20]),
    (lambda p, t, x: t.exp(x) - 1, [[1e-20]], [1e-20]),
    (lambda p, t, x: t.log(t.sum(t.exp(x))), [[800.0]], 800.0),
    (lambda p, t, x: t.exp(x) * t.exp(-x), [[800.0]], [1.0]),
    (lambda p, t, x, y: t.exp(x) / t.exp(y), [[800.0, -800.0]] * 2, [1.0, 1.0]),
    (lambda p, t, x: t.log(1 + t.exp(x)), [[800.0]], [800.0]),
    (lambda p, t, x: p.grad(t.sum(t.log(1 + t.exp(x))), x), [[800.0]], [1.0]),
    (lambda p, t, x: t.log(t.sigmoid(x)), [[-800.0]], [-800.0]),
    (lambda p, t, x: t.log(1 - t.sigmoid(x)), [[800.0]], [-800.0]),
    (lambda p, t, x: t.log(1 - t.exp(x)), [[-1e-20]], [np.log(1e-20)]),
], ids=["eq", "le", "ge", "mod", "zero_div", "log1p", "log1m", "expm1", "logsumexp",
        "exp_mul", "exp_div", "softplus", "softplus_grad", "log_sigmoid", "log1msigm",
        "log1mexp"])
def test_value_changing_rewrites(build, values, want):
    jax, port = _both(build, values)
    _same(port, jax)
    np.testing.assert_allclose(port[0], np.asarray(want), rtol=1e-12)


X = np.array([1.5, -2.0, 3.0, -0.5, 4.0])


@pytest.mark.parametrize("build", [
    lambda p, t, x: t.sum(x[x > 0]),
    lambda p, t, x: t.mean(x[x > 0]),
    lambda p, t, x: x[x > 0].shape,
    lambda p, t, x: p.grad(t.sum(x[x > 0]), x),
    lambda p, t, x: p.grad(t.mean(x[x > 0]), x),
    lambda p, t, x: t.set_subtensor(x[x > 0], 0.0),
    lambda p, t, x: t.inc_subtensor(x[x > 0], 1.0),
], ids=["sum", "mean", "shape", "grad_sum", "grad_mean", "set", "inc"])
def test_data_dependent_boolean_masks(build):
    jax, port = _both(build, [X])
    _same(port, jax)


def test_a_bare_boolean_mask_still_raises_in_both():
    for ptt, pt, kw in (JAX, PORT):
        x = pt.dvector("x")
        with pytest.raises(NotImplementedError):
            ptt.function([x], x[x > 0], **kw)(X)


M = np.arange(12.0).reshape(3, 4)


@pytest.mark.parametrize("build", [
    lambda p, t, x: x[::-1, [0, 2]],
    lambda p, t, x: x[[0, 2], ::-2],
    lambda p, t, x: x[[2, 0], 3:0:-2],
    lambda p, t, x: t.set_subtensor(x[::-1, [0, 2]], -1.0),
    lambda p, t, x: t.inc_subtensor(x[[0, 2], ::-2], np.array([[1.0, 2.0], [3.0, 4.0]])),
    lambda p, t, x: t.inc_subtensor(x[::-1, [0, 2]], np.arange(6.0).reshape(3, 2)),
], ids=["rev_adv", "adv_rev2", "adv_rev_bounded", "set_rev_adv", "inc_adv_rev",
        "inc_rev_adv"])
def test_advanced_index_beside_a_negative_step(build):
    jax, port = _both(build, [M])
    _same(port, jax)


@pytest.mark.parametrize("build", [lambda p, t, x: t.sum(x), lambda p, t, x: t.prod(x)],
                         ids=["sum", "prod"])
def test_reductions_of_uint8_are_uint64(build):
    jax, port = _both(build, [np.array([200, 200, 200], dtype="uint8")], dtype=None)
    _same(port, jax)
    assert port[0].dtype == np.uint64


@pytest.mark.parametrize("dtype", ["uint16", "uint32", "uint64"])
def test_wide_unsigned_dtypes(dtype):
    top = np.iinfo(dtype).max
    x = np.array([top, 3, 7, top // 2 + 1], dtype=dtype)
    y = np.array([2, top, 7, 5], dtype=dtype)

    def build(p, t, a, b):
        return [a + b, a * b, a - b, a // b, a % b, a > b, a <= b, t.maximum(a, b),
                t.minimum(a, b), t.cast(a, "float64"), t.cast(a, "int32"), t.max(a), t.min(a),
                t.sum(a), a + 3, t.cast(t.cast(a, "float64") * 0.5, dtype)]

    jax, port = _both(build, [x, y], dtype=None)
    _same(port, jax)


def test_qr_raw_gives_numpys_h_and_tau():
    """``(h, tau)`` of shapes ``(n, m)`` and ``(k,)``; the node's types are
    the JAX package's, which its ``make_node`` gives as ``(m, m)`` and
    ``(m, n)`` (``pytensor_tpu/tensor/linalg.py:555-562``)."""
    a = np.random.default_rng(3).standard_normal((5, 3))
    jax, port = _both(lambda p, t, x: list(t.linalg.qr(x, mode="raw")), [a])
    want = np.linalg.qr(a, mode="raw")
    assert [p.shape for p in port] == [(3, 5), (3,)]
    for got, w, j in zip(port, want, jax):
        np.testing.assert_allclose(got, w, rtol=1e-12, atol=1e-15)
        np.testing.assert_allclose(j, w, rtol=1e-12, atol=1e-15)
    types = []
    for ptt, pt, kw in (JAX, PORT):
        node = pt.linalg.qr(pt.tensor("x", dtype="float64", shape=(5, 3)), mode="raw")[0].owner
        types.append([o.type.shape for o in node.outputs])
    assert types[0] == types[1] == [(5, 5), (5, 3)]


def test_complex_constants_keep_their_imaginary_part():
    """``z * 2j * 3``, ``z + 1j + 2``, ``(z * 2) / 4j``, ``z / (1 + 2j)`` and
    ``(0 + 5j) / z`` against numpy; the JAX package's value, pinned, drops
    the constants' imaginary parts (``float()`` of ``2j`` is 0)."""
    z = np.array([1 + 1j, -2 + 0.5j, 3 - 4j])

    def build(p, t, a):
        return [a * 2j * 3, a + 1j + 2, (a * 2) / 4j, a / (1 + 2j), (0 + 5j) / a]

    with np.errstate(all="ignore"):
        want = [z * 6j, z + 1j + 2, z * 2 / 4j, z / (1 + 2j), 5j / z]
    jax, port = _both(build, [z], dtype="complex128")
    for got, w in zip(port, want):
        np.testing.assert_allclose(got, w, rtol=1e-12)
    np.testing.assert_array_equal(jax[0], np.zeros(3))  # 2j folded to 0


@pytest.mark.parametrize("y_ndim,y_shape", [(0, ()), (0, (5,)), (1, (2,)), (1, (5, 2))],
                         ids=["scalar", "batched_scalar", "row", "batched_row"])
@pytest.mark.parametrize("inc", [False, True], ids=["set", "inc"])
def test_batched_index_write_drops_an_index_out_of_range(inc, y_ndim, y_shape):
    """``vectorize_graph`` of ``x[i] (+)= y`` over a batch of ``x`` and of
    ``i`` (and of ``y``, or not): one index in range, one negative (the last row), two out of
    range (3 and -4 of 3 rows: their updates dropped) and one in range
    again, in the port and in the JAX package's XLA path."""
    from pytensor_tpu.graph.replace import vectorize_graph as jvectorize
    from pytensor_tpu_torch.graph.replace import vectorize_graph as tvectorize

    rng = np.random.default_rng(12)
    xv = rng.normal(size=(5, 3, 2))
    yv = rng.normal(size=y_shape)
    iv = np.array([0, -1, 3, -4, 2])
    res = []
    for (ptt, pt, kw), vectorize in ((JAX, jvectorize), (PORT, tvectorize)):
        x, i = pt.matrix("x", dtype="float64"), pt.scalar("i", dtype="int64")
        y = pt.tensor("y", dtype="float64", shape=(None,) * y_ndim)
        write = pt.inc_subtensor if inc else pt.set_subtensor
        xb = pt.tensor3("xb", dtype="float64")
        ib = pt.vector("ib", dtype="int64")
        yb = pt.tensor("yb", dtype="float64", shape=(None,) * len(y_shape))
        out = vectorize(write(x[i], y), replace={x: xb, i: ib, y: yb})
        assert type(out.owner.op).__name__ == "Blockwise"
        res.append(_np(ptt.function([xb, ib, yb], out, **kw)(xv, iv, yv)))
    jax, port = res
    np.testing.assert_array_equal(port, jax)
    np.testing.assert_array_equal(port[2:4], xv[2:4])


# --- 13. the value-changing rewrites of tensor/rewriting/math.py ---------------------

# the repaired rewrites, and the largest distance in ulps of the port's value
# from the JAX package's on each of their probe graphs: 0 where both compute
# the same operations with the same rounding, else what torch's and XLA's
# implementations of the same function differ by on the probe's values
MATH_ULPS = {
    "exp(-softplus(-x))": 2, "sum(sum(m, 0))": 2, "sum(x * c)": 2,
    "switch(x < 1, 0, x) * log(x)": 2, "switch(x < 1, 0, x) / x": 0, "dot(zeros, x)": 0,
    "log(sqrt(x))": 1, "exp(x)**3": 1, "(x**3)**2": 0, "prod(prod(m, 0))": 12,
    "max(max(m, 0))": 0, "sum(alloc(c, 4097))": 0, "sinh(-x)": 16, "tanh(-x)": 7,
    "sin(-x)": 1, "arctan(-x)": 1, "arcsinh(-x)": 2, "erf(-x)": 1, "tan(arctan(x))": 0,
    "sinh(arcsinh(x))": 0, "log(1 / x)": 1, "log(3 / x)": 4, "log(x / 3)": 4,
    "sign(1 / x)": 0, "sign(-2 / x)": 0, "sqr(sqrt(x))": 0, "exp(log(x))": 0,
    "expm1(log1p(x))": 0, "exp(softplus(x))": 1, "softplus(log(x))": 2, "x**5": 0,
    "x**-3": 0, "log(-expm1(-x))": 121, "log1p(expm1(x))": 0, "arcsinh(sinh(x))": 0,
    "deg2rad(rad2deg(x))": 0, "x**2.5 * x**0.7": 1,
    "sum(sqr(W[None] * G[:, None]), (1, 2))": 2,
}


def _math_cases():
    from tests.torch_math_probe import GRAPHS, PORTED

    return [(name, graph) for name in PORTED for graph in GRAPHS[name]]


@pytest.mark.parametrize("name,graph", _math_cases(),
                         ids=[f"{n}:{g[0]}" for n, g in _math_cases()])
def test_value_changing_math_rewrites(name, graph):
    """Each repaired rewrite of Queue 3 item 1 on its probe graph (4,096
    float64 values in [0.01, 20] and -0.0 and -inf, or 16 seeded draws of
    a reduction's inputs): the same ops, the same count of firings (none
    on the port before the repair) and the JAX package's value within the
    stated ulps, NaNs and infinities exactly."""
    from tests.torch_math_probe import _fired, compiled, input_sets, ulps

    label, build, inputs, _ = graph
    counts, undo = _fired()
    try:
        ops = []
        for ptt, pt, kw in (JAX, PORT):
            ins = [pt.tensor(f"x{k}", dtype=np.asarray(v).dtype, shape=(None,) * np.ndim(v))
                   for k, v in enumerate(input_sets(inputs)[0])]
            f = ptt.function(ins, build(pt, *ins), **kw)
            fg = f.maker.fgraph if hasattr(f, "maker") else f.fgraph
            ops.append([type(n.op).__name__ for n in fg.toposort()])
        jax, port = compiled(build, inputs)
    finally:
        undo()
    assert ops[1] == ops[0]
    assert counts["torch"][name] == counts["jax"][name] > 0
    assert port.dtype == jax.dtype and port.shape == jax.shape
    assert ulps(port, jax) <= MATH_ULPS[label]


# --- 14. sparse outputs ------------------------------------------------------------------

def _scipy_of(t):
    """A torch sparse csr or csc tensor as the scipy matrix of its triple."""
    import scipy.sparse as sp

    if t.layout == torch.sparse_csr:
        return sp.csr_matrix((t.values().numpy(), t.col_indices().numpy(),
                              t.crow_indices().numpy()), shape=tuple(t.shape))
    assert t.layout == torch.sparse_csc
    return sp.csc_matrix((t.values().numpy(), t.row_indices().numpy(),
                          t.ccol_indices().numpy()), shape=tuple(t.shape))


def _sparse_outputs(sparse, pt, fmt):
    x = sparse.matrix(fmt, "x", "float64")
    y = sparse.matrix(fmt, "y", "float64")
    d = pt.dmatrix("d")
    return [x, y, d], [sparse.transpose(x), sparse.add(x, y), sparse.csr_from_dense(d),
                       sparse.csc_from_dense(d), sparse.hstack([x, y], format=fmt)]


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_sparse_outputs_are_torch_sparse_tensors(fmt):
    """Each sparse output is a torch sparse tensor of its graph format on
    the CPU, with the JAX oracle's triple (data, indices, pointers)."""
    import scipy.sparse as sp

    from pytensor_tpu import sparse as jsparse
    from pytensor_tpu_torch import sparse as tsparse

    A = sp.random(4, 5, density=0.4, format=fmt, random_state=1)
    B = sp.random(4, 5, density=0.4, format=fmt, random_state=2)
    D = sp.random(3, 4, density=0.5, random_state=3).toarray()
    j_ins, j_outs = _sparse_outputs(jsparse, jpt, fmt)
    want = jptt.function(j_ins, j_outs, mode="FAST_COMPILE")(A, B, D)
    t_ins, t_outs = _sparse_outputs(tsparse, tpt, fmt)
    got = tptt.function(t_ins, t_outs, device="cpu")(A, B, D)
    for g, w, o in zip(got, want, t_outs):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert g.layout == {"csr": torch.sparse_csr, "csc": torch.sparse_csc}[o.type.format]
        g = _scipy_of(g)
        assert g.format == w.format and g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g.indptr, w.indptr)
        np.testing.assert_array_equal(g.indices, w.indices)
        np.testing.assert_array_equal(g.data, w.data)


@pytest.mark.parametrize("fmt", ["csr", "csc"])
def test_sparse_inputs_take_torch_sparse_tensors(fmt):
    """A torch sparse tensor of either layout is taken where a scipy
    matrix is, with the same result."""
    import scipy.sparse as sp

    from pytensor_tpu_torch import sparse as tsparse

    A = sp.random(6, 5, density=0.4, format=fmt, random_state=4)
    x = tsparse.matrix(fmt, "x", "float64")
    f = tptt.function([x], [tsparse.sp_sum(x, axis=0), tsparse.transpose(x)], device="cpu")
    dense = torch.from_numpy(A.toarray())
    outs = [f(A), f(dense.to_sparse_csr()), f(dense.to_sparse_csc())]
    for s, t in outs[1:]:
        np.testing.assert_array_equal(s.numpy(), outs[0][0].numpy())
        np.testing.assert_array_equal(t.to_dense().numpy(), A.T.toarray())


def test_sparse_output_does_not_alias_a_shared_variable():
    """``CSM`` of a shared vector returns the shared tensor's storage as its
    data: the output is copied, so a later update leaves it as it was."""
    from pytensor_tpu_torch import sparse as tsparse

    w = tptt.shared(np.arange(1.0, 4.0), name="w", device="cpu")
    indices, indptr = np.array([0, 2, 1], "int32"), np.array([0, 2, 3], "int32")
    read = tptt.function([], tsparse.CSM("csr")(w, indices, indptr, np.array([2, 3])),
                         device="cpu")
    bump = tptt.function([], [], updates={w: w + 1.0}, device="cpu")
    before = read()
    bump()
    np.testing.assert_array_equal(before.values().numpy(), [1.0, 2.0, 3.0])
    np.testing.assert_array_equal(read().values().numpy(), [2.0, 3.0, 4.0])


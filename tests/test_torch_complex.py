"""complex64 and complex128 in the port against the JAX package and numpy.

The five complex ops (``real``, ``imag``, ``conj``, ``angle``,
``complex``), ``complex_from_polar``, ``conjugate`` and ``abs`` of a
complex; numpy's promotion of the complex dtypes; casts and complex
literals; the reductions, ``dot`` and the elementwise ops on complex
operands; the gradients of ``conj`` and of ``abs`` of a complex.  Each
graph runs in the port (``function(..., device="cpu")``), in the JAX
package's XLA path and its numpy oracle (``mode="FAST_COMPILE"``) and in
numpy, on seeded values with signed zeros, units and the axes in front.
Tolerance: ``rtol 1e-5`` for complex64 and ``1e-12`` for complex128,
over the modulus of numpy's value (``_close``); exact ops bit for bit.

Reference behaviours, pinned: the JAX package types ``abs`` and
``angle`` of a complex complex (the port, numpy and PyTensor give a
real; the values agree), and ``max`` of a complex raises on its XLA
path.  K1 (``tensor/fused_kernel.py``) emits every op of
``link/cuda/cases.py COMPLEX_OPS``; the fused graphs are held op for op
against the JAX package's, with the nodes where K1 does not emit an op
pinned.  One K1 library of every complex op, in both dtypes, is compiled
by g++ against ``tests/k1_host.h`` (``tests/test_torch_fused.py``'s
harness) and held against its plain version (``cases.complex_held``:
exact ops bit for bit, the others within 8 epsilons of the modulus) and
numpy complex128.  The card's build is held by ``tests/test_torch_cuda.py``
and ``chip_smoke.py`` phase 17.
"""

import warnings

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
from pytensor_tpu.compile.mode import FAST_RUN as J_FAST_RUN
from pytensor_tpu.graph.fg import FunctionGraph as JFunctionGraph
from pytensor_tpu.scalar import basic as jbasic

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.compile.mode import FAST_RUN as T_FAST_RUN
from pytensor_tpu_torch.graph.fg import FunctionGraph as TFunctionGraph
from pytensor_tpu_torch.link.cuda import cases
from pytensor_tpu_torch.scalar import basic as tbasic
from pytensor_tpu_torch.tensor import fused_kernel
from pytensor_tpu_torch.tensor.fused import FusedElemwise as TFused
from pytensor_tpu_torch.tensor.fused import fusable

from test_torch_fused import _host_launch, k1_host  # noqa: F401 (the fixture)

RTOL = {"complex64": 1e-5, "complex128": 1e-12, "float32": 1e-5, "float64": 1e-12}
DTYPES = ("complex64", "complex128")
REAL = {"complex64": "float32", "complex128": "float64"}
PKGS = (("jax", jptt, jpt), ("torch", tptt, tpt))
N = 40


def _np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _close(got, want, dtype, what):
    got, want = _np(got), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype == bool:
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    ok = np.isfinite(want)
    assert np.array_equal(np.isfinite(got), ok), what
    err = np.abs(got[ok] - want[ok])
    assert (err <= RTOL[dtype] * np.maximum(np.abs(want[ok]), 1e-30)).all(), (what, err.max())


def _run(build, values):
    """Each package's outputs of ``build(pt)`` on ``values``: the port's,
    the XLA path's and the oracle's."""
    out = {}
    for name, ptt, pt in PKGS:
        ins, outs = build(pt)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            if name == "jax":
                out["xla"] = [np.asarray(r) for r in ptt.function(ins, outs)(*values)]
                out["oracle"] = [np.asarray(r) for r in
                                 ptt.function(ins, outs, mode="FAST_COMPILE")(*values)]
            else:
                out["torch"] = [_np(r) for r in ptt.function(ins, outs, device="cpu")(*values)]
    return out


# --- the five ops, complex_from_polar, conjugate, abs ---------------------------------

UNARY = {"real": np.real, "imag": np.imag, "angle": np.angle, "conj": np.conj, "abs": np.abs}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_complex_ops(name, dtype):
    """``real``, ``imag``, ``conj`` and ``angle`` and ``abs`` of a complex
    vector: the port's dtype is numpy's (a real for all but ``conj``) and
    its value numpy's, the JAX package's values the same (its ``abs`` and
    ``angle`` typed complex, with 0 imaginary parts: pinned)."""
    z = cases.complex_values(dtype, N, 1)

    def build(pt):
        v = pt.tensor("z", dtype=dtype, shape=(None,))
        return [v], [getattr(pt, name)(v)]

    out = _run(build, [z])
    want = UNARY[name](z)
    assert out["torch"][0].dtype == want.dtype
    _close(out["torch"][0], want, dtype, name)
    for kind in ("xla", "oracle"):
        got = out[kind][0]
        if name in ("abs", "angle"):
            assert got.dtype == np.dtype(dtype)  # the JAX package's complex type
            assert (got.imag == 0).all()
            got = got.real
        _close(got, want, dtype, f"{kind} {name}")


@pytest.mark.parametrize("re_dtype,im_dtype", [("float32", "float32"), ("float64", "float64"),
                                               ("float32", "float64"), ("int32", "float32"),
                                               ("int64", "int64")])
def test_complex_from_two_parts(re_dtype, im_dtype):
    """``complex(re, im)``: complex64 where the parts upcast below float64,
    complex128 otherwise, as the JAX package's rule."""
    rng = np.random.default_rng(2)
    re = (rng.standard_normal(N) * 5).astype(re_dtype)
    im = (rng.standard_normal(N) * 5).astype(im_dtype)

    def build(pt):
        a = pt.tensor("a", dtype=re_dtype, shape=(None,))
        b = pt.tensor("b", dtype=im_dtype, shape=(None,))
        return [a, b], [pt.complex(a, b)]

    out = _run(build, [re, im])
    dtype = jbasic.complex_op.output_dtype(re_dtype, im_dtype)
    assert out["torch"][0].dtype == np.dtype(dtype) == out["xla"][0].dtype
    want = re.astype(REAL[dtype]) + 1j * im.astype(REAL[dtype])
    for kind in ("torch", "xla", "oracle"):
        _close(out[kind][0], want, dtype, kind)


def test_complex_from_polar_and_conjugate():
    """``complex_from_polar(r, phi)`` is ``r * exp(1j * phi)`` in complex128
    and ``conjugate`` is ``conj``.  The JAX package's mul canonicalizer folds
    the constant ``1j`` through ``float()`` and drops its imaginary part
    (ROADMAP Queue 3): its value is ``r cos(phi)`` with 0 imaginary parts,
    pinned here; the port keeps the constant (``tests/test_torch_faults.py``)."""
    rng = np.random.default_rng(3)
    r, phi = rng.uniform(0, 3, N), rng.uniform(-np.pi, np.pi, N)

    def build(pt):
        a, b = pt.dvector("a"), pt.dvector("b")
        return [a, b], [pt.complex_from_polar(a, b), pt.conjugate(pt.complex(a, b))]

    out = _run(build, [r, phi])
    _close(out["torch"][0], r * np.exp(1j * phi), "complex128", "polar")
    _close(out["torch"][1], r - 1j * phi, "complex128", "conjugate")
    for kind in ("xla", "oracle"):
        _close(out[kind][0], r * np.cos(phi) + 0j, "complex128", f"{kind} polar (pinned)")
        _close(out[kind][1], r - 1j * phi, "complex128", f"{kind} conjugate")
    assert tpt.conjugate is tpt.conj


# --- promotion, casts, literals -------------------------------------------------------

ALL = ("bool", "int8", "int16", "int32", "int64", "uint8", "bfloat16", "float32", "float64",
       "complex64", "complex128")


@pytest.mark.parametrize("other", ALL)
@pytest.mark.parametrize("dtype", DTYPES)
def test_promotion_of_complex_dtypes(dtype, other):
    """``upcast`` and ``upcast_float`` of a complex dtype with every dtype,
    either order, as the JAX package's: numpy's (int64 or float64 with
    complex64 is complex128), bfloat16 with complex64 complex64."""
    for pair in ((dtype, other), (other, dtype)):
        assert tbasic.upcast(*pair) == jbasic.upcast(*pair)
        assert tbasic.upcast_float(*pair) == jbasic.upcast_float(*pair)
    if dtype == "complex64":
        want = {"int64": "complex128", "int32": "complex128", "float64": "complex128",
                "float32": "complex64", "int8": "complex64", "bfloat16": "complex64"}
        if other in want:
            assert tbasic.upcast(dtype, other) == want[other]


def test_casts_and_literals():
    """A cast from complex to a real dtype raises in both packages; a cast
    to complex, a complex Python literal (complex128) and arithmetic with
    one agree with numpy."""
    for _, _, pt in PKGS:
        with pytest.raises(TypeError, match="complex to real"):
            pt.cast(pt.tensor("z", dtype="complex64", shape=(None,)), "float32")
        assert pt.as_tensor_variable(1j).type.dtype == "complex128"
    x = np.random.default_rng(4).standard_normal(N).astype("float32")

    def build(pt):
        v = pt.tensor("x", dtype="float32", shape=(None,))
        c = pt.cast(v, "complex64")
        return [v], [c, c * 2 - 1, pt.cast(v, "complex128") + 1j]

    out = _run(build, [x])
    wants = [x.astype("complex64"), x.astype("complex64") * 2 - 1, x.astype("complex128") + 1j]
    for kind in ("torch", "xla", "oracle"):
        for k, w in enumerate(wants):
            assert out[kind][k].dtype == w.dtype, (kind, k)
            _close(out[kind][k], w, str(w.dtype), f"{kind} {k}")


# --- reductions, dot, elementwise ops ------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_reductions_and_dot(dtype):
    """``sum``, ``prod``, ``mean`` and ``dot`` of complex operands, and
    ``max``/``min`` by numpy's order (the real parts, then the imaginary
    ones) against the oracle (the XLA path refuses them: pinned); an
    accumulator narrower than the input raises."""
    rng = np.random.default_rng(5)
    a = (rng.standard_normal((6, 7)) + 1j * rng.standard_normal((6, 7))).astype(dtype)
    b = (rng.standard_normal(7) + 1j * rng.standard_normal(7)).astype(dtype)
    a[2, :3] = [1 + 5j, 1 + 7j, 1 - 2j]  # ties of the real parts

    def build(pt):
        m = pt.tensor("a", dtype=dtype, shape=(None, None))
        v = pt.tensor("b", dtype=dtype, shape=(None,))
        return [m, v], [pt.sum(m, axis=0), pt.prod(m[:2], axis=1), pt.mean(m), pt.dot(m, v),
                        pt.sum(m * pt.conj(m))]

    out = _run(build, [a, b])
    wants = [a.sum(0), a[:2].prod(1), a.mean(), a @ b, (a * a.conj()).sum()]
    for kind in ("torch", "xla", "oracle"):
        for k, w in enumerate(wants):
            assert out[kind][k].dtype == np.dtype(dtype), (kind, k)
            _close(out[kind][k], w, dtype, f"{kind} {k}")

    def extremes(pt):
        m = pt.tensor("a", dtype=dtype, shape=(None, None))
        return [m], [pt.max(m, axis=1), pt.min(m), pt.max(m)]

    got = tptt.function(*extremes(tpt), device="cpu")(a)
    want = jptt.function(*extremes(jpt), mode="FAST_COMPILE")(a)
    for g, w, ref in zip(got, want, [a.max(1), a.min(), a.max()]):
        np.testing.assert_array_equal(_np(g), np.asarray(w))
        np.testing.assert_array_equal(_np(g), ref)
    with pytest.raises(TypeError):
        tpt.prod(tpt.tensor("c", dtype="complex128", shape=(None,)), acc_dtype="complex64")


BINARY = {"add": np.add, "sub": np.subtract, "mul": np.multiply, "true_div": np.true_divide,
          "eq": np.equal, "neq": np.not_equal, "lt": np.less, "ge": np.greater_equal,
          "pow": np.power}
UNARY_EW = {"neg": np.negative, "sqr": np.square, "exp": np.exp, "log": np.log,
            "sqrt": np.sqrt, "tanh": np.tanh, "sign": np.sign}


@pytest.mark.parametrize("dtype", DTYPES)
def test_elementwise_ops_on_complex_operands(dtype):
    """The existing elementwise ops on complex operands (and a complex with
    a real, and an integer) against numpy and the JAX package: the
    arithmetic, the exponentials, numpy's lexicographic order of the
    comparisons; ``x / c`` with an integer x (``tests/test_ref_tensor_math.py``'s
    ``test_div_impls``)."""
    z = cases.complex_values(dtype, N, 6)
    w = np.roll(cases.complex_values(dtype, N, 7), 3)
    w[w == 0] = 1 + 1j
    x = np.random.default_rng(8).standard_normal(N).astype(REAL[dtype])
    i = np.arange(-5, N - 5).astype("int32")

    def build(pt):
        a = pt.tensor("a", dtype=dtype, shape=(None,))
        b = pt.tensor("b", dtype=dtype, shape=(None,))
        r = pt.tensor("r", dtype=REAL[dtype], shape=(None,))
        k = pt.tensor("k", dtype="int32", shape=(None,))
        outs = [getattr(pt, n)(a, b) for n in BINARY]
        outs += [getattr(pt, n)(a) for n in UNARY_EW]
        outs += [a * r, r / a, k / b, a + 2.5]
        return [a, b, r, k], outs

    out = _run(build, [z, w, x, i])
    with np.errstate(all="ignore"):
        wants = [f(z, w) for f in BINARY.values()] + [f(z) for f in UNARY_EW.values()]
        wants += [z * x, x / z, i / w, z + 2.5]
    names = list(BINARY) + list(UNARY_EW) + ["mul real", "real / complex", "int / complex",
                                             "add literal"]
    for kind in ("torch", "xla", "oracle"):
        for name, got, want in zip(names, out[kind], wants):
            if name == "pow" and kind != "torch":
                continue  # the JAX package gives NaN at 0 ** w
            assert got.dtype == want.dtype, (kind, name, got.dtype, want.dtype)
            # XLA on the values past the edges: at a signed zero on a branch
            # cut (sqrt, log of -2.5 - 0j) its sign is XLA's own
            keep = np.arange(N) >= (cases.N_COMPLEX_EDGES if kind == "xla" else 0)
            keep &= np.isfinite(want) if want.dtype != bool else True
            _close(got[keep], want[keep], dtype, f"{kind} {name}")


# --- gradients -----------------------------------------------------------------------


@pytest.mark.parametrize("dtype", DTYPES)
def test_gradients_of_conj_and_abs(dtype):
    """``d sum|conj(z)| / dz`` is ``z / |z|`` and ``d sum(conj(z) * w) / dz``
    is ``conj(w)``, as the JAX package's gradient rules give them
    (``conj``'s is ``conj(gz)``, ``abs``'s ``gz * sign(z)``)."""
    z = cases.complex_values(dtype, N, 9)[4:]  # no zero
    w = np.roll(z, 2)

    def build(pt):
        a = pt.tensor("a", dtype=dtype, shape=(None,))
        b = pt.tensor("b", dtype=dtype, shape=(None,))
        ptt = jptt if pt is jpt else tptt
        return [a, b], [ptt.grad(pt.sum(pt.abs(pt.conj(a))), a),
                        ptt.grad(pt.sum(pt.conj(a) * b), a)]

    out = _run(build, [z, w])
    for kind in ("torch", "xla", "oracle"):
        _close(out[kind][0], z / np.abs(z), dtype, f"{kind} abs")
        _close(out[kind][1], np.conj(w), dtype, f"{kind} conj")


# --- the fusion pass and K1 -----------------------------------------------------------

def _fused_ops(pkg, build):
    """The rewritten graph's ops: each FusedElemwise as the sorted names of
    its inner scalar ops, each other node as its op's class name."""
    ptt, pt, fg_cls, fast_run = pkg
    ins, outs = build(pt)
    fg = fg_cls(ins, outs, clone=True)
    fast_run.optimizer.rewrite(fg)
    ops = []
    for node in fg.toposort():
        if type(node.op).__name__ == "FusedElemwise":
            ops.append(tuple(sorted(n.op.scalar_op.name for n in node.op.fgraph.toposort())))
        elif type(node.op).__name__ == "Elemwise":
            ops.append(node.op.scalar_op.name)
        else:
            ops.append(type(node.op).__name__)
    return ops


JAX = (jptt, jpt, JFunctionGraph, J_FAST_RUN)
TORCH = (tptt, tpt, TFunctionGraph, T_FAST_RUN)


def test_periodogram_chain_groups_as_in_the_jax_package():
    """The periodogram's chain, ``complex(re, im)`` to ``abs(c)**2`` and
    ``angle(c)``, after the same FFT and slices: both packages' greedy
    fusion cuts at ``c`` (two readers), leaving ``complex`` and ``angle``
    single nodes.  Pinned, ROADMAP Queue 3: the JAX package types ``abs``
    of a complex complex, so its ``sqr(abs(x)) -> sqr(x)`` rewrite, which
    holds for a real x only, fires and makes its power ``c**2`` (a group of
    ``sqr`` alone): held here against numpy's ``c**2``."""
    ours, theirs = _fused_ops(TORCH, lambda pt: cases.periodogram_graph()), _fused_ops(JAX, _jax_periodogram)
    assert ours == ["RFFTOp", "Subtensor", "Subtensor", "complex", ("abs", "sqr"), "angle"]
    assert theirs == ["RFFTOp", "Subtensor", "Subtensor", "complex", ("sqr",), "angle"]
    x = np.random.default_rng(10).standard_normal((3, 64)).astype("float32")
    got = tptt.function(*cases.periodogram_graph(), device="cpu")(x)
    spec = np.fft.rfft(x.astype("float64"))
    np.testing.assert_allclose(_np(got[0]), np.abs(spec) ** 2, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(_np(got[1]), np.angle(spec), atol=2e-4)
    jgot = jptt.function(*_jax_periodogram(jpt))(x)
    np.testing.assert_allclose(np.asarray(jgot[0]), spec ** 2, rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(np.asarray(jgot[1]).real, np.angle(spec), atol=2e-4)


def _jax_periodogram(pt):
    x = pt.tensor("x", dtype="float32", shape=(None, None))
    packed = pt.fft.rfft(x)
    c = pt.complex(packed[..., 0], packed[..., 1])
    return [x], [pt.abs(c) ** 2, pt.angle(c)]


def test_complex_chains_fuse_op_for_op_or_are_pinned():
    """A chain of every complex op K1 emits fuses as in the JAX package.
    Where K1 does not emit an op (``tanh`` and ``pow`` of a complex, ``angle``
    and ``imag`` of a real), the port leaves the node alone and the JAX
    package fuses it (its fusion has no dtype gate): pinned."""
    def emitted(pt):
        a = pt.tensor("a", dtype="complex64", shape=(None,))
        b = pt.tensor("b", dtype="complex64", shape=(None,))
        r = pt.tensor("r", dtype="float32", shape=(None,))
        c = pt.sqrt(pt.exp(a) / (b - a)) * pt.log(pt.conj(b) + pt.complex(r, r))
        return [a, b, r], [pt.abs(c) + pt.real(c) + pt.angle(-c) + pt.imag(c * c),
                           pt.eq(c, a) | pt.neq(b, c)]

    assert _fused_ops(TORCH, emitted) == _fused_ops(JAX, emitted)
    assert all(isinstance(o, tuple) for o in _fused_ops(TORCH, emitted))

    def not_emitted(pt):
        a = pt.tensor("a", dtype="complex64", shape=(None,))
        r = pt.tensor("r", dtype="float32", shape=(None,))
        return [a, r], [pt.tanh(a * 2) + a, pt.angle(r * 2) + pt.imag(r + 1)]

    ours, theirs = _fused_ops(TORCH, not_emitted), _fused_ops(JAX, not_emitted)
    assert "tanh" in ours and "angle" in ours and "imag" in ours
    assert not any(isinstance(o, str) and o in ("tanh", "angle", "imag") for o in theirs)


@pytest.mark.parametrize("dtype", DTYPES)
def test_fusable_admits_exactly_the_complex_ops(dtype):
    for name in cases.COMPLEX_OPS:
        assert fusable(cases.complex_node(name, dtype)), name
    z = tpt.tensor("z", dtype=dtype, shape=(None,))
    other = "complex64" if dtype == "complex128" else "complex128"
    for bad in (tpt.tanh(z), tpt.sin(z), z ** z, tpt.cast(z, other)):
        assert not fusable(bad.owner), bad.owner


def test_k1_source_matches_plain_on_every_complex_op(k1_host):  # noqa: F811
    """One K1 library of every complex op in both dtypes, one node a
    kernel, compiled for the host: each against its plain version
    (``cases.complex_held``) and against numpy complex128 (within
    COMPLEX_ULPS epsilons of the modulus, on the finite values); the
    periodogram's ``abs``-``sqr`` group and its whole chain as one kernel
    (``cases.periodogram_chain``: a complex intermediate in registers)
    likewise."""
    runs, kerns = [], []
    for dtype in DTYPES:
        for name in cases.COMPLEX_OPS:
            node = cases.complex_node(name, dtype)
            kern = fused_kernel.FusedElemwiseKernel(
                TFunctionGraph(list(node.inputs), node.outputs, clone=True), "cpu")
            runs.append((name, dtype, kern,
                         [torch.from_numpy(v) for v in cases.complex_inputs(name, dtype, 96, 11)]))
            kerns.append(kern)
    ins, outs = cases.periodogram_graph()
    fg = TFunctionGraph(ins, outs, clone=True)
    T_FAST_RUN.optimizer.rewrite(fg)
    (pnode,) = [n for n in fg.toposort() if isinstance(n.op, TFused)]
    pkern = fused_kernel.FusedElemwiseKernel(pnode.op.fgraph, "cpu")
    ckern = fused_kernel.FusedElemwiseKernel(
        TFunctionGraph(*cases.periodogram_chain(), clone=True), "cpu")
    kerns += [pkern, ckern]
    lib = k1_host(kerns)
    for name, dtype, kern, args in runs:
        (got,), _ = _host_launch(lib, kern, args)
        (want,) = kern.plain(*args)
        assert got.dtype == want.dtype and got.shape == want.shape, (name, dtype)
        assert cases.complex_held(got.numpy(), want.numpy(), name, dtype), (name, dtype)
        ref = cases.numpy_complex_op(name, [a.numpy() for a in args])
        assert cases.complex_near(got.numpy(), ref, dtype), (name, dtype)
    rng = np.random.default_rng(12)
    parts = [torch.from_numpy(rng.standard_normal((4, 33)).astype("float32")) for _ in range(2)]
    for kern, args in ((pkern, [torch.complex(*parts)]), (ckern, parts)):
        got, _ = _host_launch(lib, kern, args)
        want = kern.plain(*args)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.allclose(g.numpy(), w.numpy(), rtol=8 * 2 ** -23, atol=1e-6)

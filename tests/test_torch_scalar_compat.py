"""``scalar/loop.py`` (ScalarLoop) and ``scalar/compatnames.py`` against the JAX package.

ScalarLoop: the JAX package's ``tests/test_more.py`` case (the for form,
10 doublings) in both packages, with vectors, and the while form, which
stops the first time its ``until`` is not all true and keeps that step's
states: the port's plan against the JAX package's XLA path and its
``perform``.  The for form reads nothing back (a captured plan); the
while form reads ``until`` each step (``reads_back``).

compatnames: the cases of the JAX package's ``tests/test_scalar_compat.py``
that the port has names for (the autocasting, the scalar types, the
output-type preferences, the PyTensor-style custom ops with their host
lowering, Composite and the helpers), each run in both packages where it
builds a function, and the one ``NumpyAutocaster``.
"""

import pickle

import numpy as np
import pytest

import pytensor_tpu as jptt
import pytensor_tpu.scalar as jps
import pytensor_tpu.tensor as jpt
from pytensor_tpu.scalar.loop import ScalarLoop as JScalarLoop

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.scalar as tps
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch import gradient as tG
from pytensor_tpu_torch.config import config as tconfig
from pytensor_tpu_torch.scalar.loop import ScalarLoop as TScalarLoop
from pytensor_tpu_torch.tensor.elemwise import Elemwise as TElemwise

PKGS = [("jax", jptt, jpt, JScalarLoop, {}), ("torch", tptt, tpt, TScalarLoop, {"device": "cpu"})]


# --- ScalarLoop --------------------------------------------------------------

def test_scalar_loop_fori_as_in_test_more():
    """tests/test_more.py:142: 10 steps of st * cc from 1 at 2 is 1024."""
    for pkg, ptt, pt, Loop, kw in PKGS:
        st, cc = pt.dscalar("st"), pt.dscalar("cc")
        loop = Loop([st], [st * cc], [cc])
        s0, c = pt.dscalar("s0"), pt.dscalar("c")
        f = ptt.function([s0, c], loop(10, s0, c), **kw)
        np.testing.assert_allclose(float(np.asarray(f(1.0, 2.0))), 1024.0)
        if pkg == "torch":
            assert f.linked.host_reads == []


def _loops(pt, Loop):
    x, y, c = pt.dscalar("x"), pt.dscalar("y"), pt.dscalar("c")
    fori = Loop([x, y], [x * c + y, y + 1.0], [c], name="affine")
    until = Loop([x], [x * 2.0], [], until=(x * 2.0) < 100.0)
    return fori, until


@pytest.mark.parametrize("form", ["for", "while"])
def test_scalar_loop_forms_against_the_jax_package(form):
    """Vectors through both forms: the port's plan, the JAX package's XLA
    path and its ``perform`` (``FAST_COMPILE``) agree exactly."""
    x0 = np.array([1.0, 3.0, -0.5, 0.0])
    y0 = np.array([0.5, 0.25, 2.0, -1.0])
    out = {}
    for pkg, ptt, pt, Loop, kw in PKGS:
        fori, until = _loops(pt, Loop)
        xv, yv, cv = pt.dvector("xv"), pt.dvector("yv"), pt.dscalar("cv")
        if form == "for":
            ins, outs, vals = [xv, yv, cv], fori(7, xv, yv, cv), (x0, y0, 0.5)
        else:
            ins, outs, vals = [xv], [until(50, xv)], (np.abs(x0) + 1.0,)
        f = ptt.function(ins, outs, **kw)
        out[pkg] = [np.asarray(o) for o in f(*vals)]
        if pkg == "jax":
            g = ptt.function(ins, outs, mode="FAST_COMPILE")
            out["oracle"] = [np.asarray(o) for o in g(*vals)]
        else:
            reads = f.linked.host_reads
            assert (reads == []) == (form == "for"), reads
            assert form == "for" or "until" in reads[0]
    for k in ("torch", "oracle"):
        assert len(out[k]) == len(out["jax"])
        for a, b in zip(out[k], out["jax"]):
            np.testing.assert_array_equal(a, b)
    if form == "while":
        # 2 doubles to 64 and stops with the element at 4 past 100: 4, 8, ... 128
        np.testing.assert_array_equal(out["torch"][0], [64.0, 128.0, 48.0, 32.0])


def test_scalar_loop_keeps_the_step_that_failed_until():
    """The while form keeps the states of the step whose until was false,
    as the JAX package's perform does, and stops at n_steps otherwise."""
    for pkg, ptt, pt, Loop, kw in PKGS:
        _, until = _loops(pt, Loop)
        v = pt.dvector("v")
        f = ptt.function([v], until(3, v), **kw)
        # the second step's until fails at 120: its states are kept
        np.testing.assert_array_equal(np.asarray(f(np.array([1.0, 30.0]))), [4.0, 120.0])
        # no until fails in 3 steps
        np.testing.assert_array_equal(np.asarray(f(np.array([1.0, 2.0]))), [8.0, 16.0])


def test_scalar_loop_gradient_is_not_implemented():
    st, cc = tpt.dscalar("st"), tpt.dscalar("cc")
    loop = TScalarLoop([st], [st * cc], [cc])
    s0 = tpt.dscalar("s0")
    with pytest.raises(tG.NullTypeGradError):
        tptt.grad(loop(3, s0, cc), s0)


def test_scalar_loop_alias_and_str():
    assert tps.ScalarLoop is TScalarLoop
    st = tpt.dscalar("st")
    assert str(TScalarLoop([st], [st + 1.0], name="inc")) == "ScalarLoop{inc}"
    assert str(TScalarLoop([st], [st + 1.0])) == "ScalarLoop{1}"


# --- compatnames -------------------------------------------------------------

def test_one_numpy_autocaster():
    from pytensor_tpu_torch.scalar import basic, compatnames

    assert basic.NumpyAutocaster is compatnames.NumpyAutocaster is tps.NumpyAutocaster
    assert basic.autocast_float is compatnames.autocast_float
    assert basic.autocast_int is compatnames.autocast_int
    assert basic.convert is compatnames.convert


def test_int_literal_smallest_dtype():
    for v, d in ((7, "int8"), (300, "int16"), (2 ** 20, "int32"), (2 ** 40, "int64")):
        assert tpt.constant(v).dtype == d == jpt.constant(v).dtype


def test_float_literal_value_dependent():
    from pytensor_tpu.config import config as jconfig

    for cfg, pt in ((jconfig, jpt), (tconfig, tpt)):
        with cfg.change_flags(floatX="float64"):
            assert pt.constant(1.5).dtype == "float32"
            assert pt.constant(1.1).dtype == "float64"
        with cfg.change_flags(floatX="float32"):
            assert pt.constant(1.1).dtype == "float32"


def test_autocast_float_as():
    for ps, pt in ((jps, jpt), (tps, tpt)):
        with ps.autocast_float_as("float64"):
            assert pt.constant(1.5).dtype == "float64"
        assert pt.constant(1.5).dtype == "float32"
        with ps.autocast_float_as("float32"):
            assert pt.constant(1.1).dtype == "float32"


def test_fvector_plus_literal():
    from pytensor_tpu.config import config as jconfig

    for cfg, ps, pt in ((jconfig, jps, jpt), (tconfig, tps, tpt)):
        x = pt.fvector("x")
        with cfg.change_flags(floatX="float64"):
            with ps.autocast_float_as("float32"):
                assert (x + 1.1).dtype == "float32"
            assert (x + 1.1).dtype == "float64"


def test_numpy_scalars_keep_dtype_and_numpy_floatX_policy():
    from pytensor_tpu.config import config as jconfig

    for cfg, pt in ((jconfig, jpt), (tconfig, tpt)):
        assert pt.constant(np.float64(1.5)).dtype == "float64"
        assert pt.constant(np.int32(7)).dtype == "int32"
        with cfg.change_flags(cast_policy="numpy+floatX", floatX="float32"):
            assert pt.constant(1.1).dtype == "float32"
            assert pt.constant(7).dtype == "int64"


def test_convert():
    for ps in (jps, tps):
        assert ps.convert(7).dtype == np.dtype("int8")
        assert ps.convert(1.5).dtype == np.dtype("float32")
        assert ps.convert(7, dtype="float64").dtype == np.dtype("float64")
    # a complex literal: complex128 in the port; the JAX package's convert
    # raises TypeError there (its module-level ``complex`` is the variable
    # constructor, which its isinstance test then reads)
    assert tps.convert(1 + 2j).dtype == np.dtype("complex128")
    with pytest.raises(TypeError):
        jps.convert(1 + 2j)


def test_scalar_types():
    for ps in (jps, tps):
        assert ps.int8.dtype == "int8" and ps.int8.ndim == 0
        v = ps.float64("v")
        assert v.type.dtype == "float64" and v.type.ndim == 0
        d = {ps.int8: "a", ps.float32: "b"}
        assert d[ps.get_scalar_type("int8")] == "a"
        t = ps.ScalarType("float32")
        assert t.dtype == "float32" and t.ndim == 0


PREFS = [("upgrade_to_float", ("int8",)), ("upgrade_to_float", ("int64",)),
         ("upgrade_to_float", ("float32",)), ("upcast_out", ("int8", "float32")),
         ("upcast_out", ("int32", "int8")), ("same_out", ("int16",)),
         ("same_out_min8", ("bool",)), ("int_out", ("int8",)), ("float_out", ("int8",)),
         ("upgrade_to_float64", ("float32",)), ("real_out", ("complex64",)),
         ("real_out", ("complex128",)), ("real_out", ("float32",)),
         ("upcast_out_min8", ("bool", "bool")), ("upcast_out_nobool", ("int8", "int16"))]


@pytest.mark.parametrize("pref,dtypes", PREFS)
def test_output_type_preferences(pref, dtypes):
    got = [getattr(ps, pref)(*(getattr(ps, d) for d in dtypes))[0].dtype for ps in (jps, tps)]
    assert got[0] == got[1]


@pytest.mark.parametrize("pref,dtype", [
    ("same_out_nobool", "bool"), ("same_out_float_only", "int32"),
    ("same_out_nocomplex", "complex64"), ("upcast_out_no_complex", "complex128"),
    ("upgrade_to_float_no_complex", "complex64")])
def test_output_type_preference_guards(pref, dtype):
    for ps in (jps, tps):
        with pytest.raises(TypeError):
            getattr(ps, pref)(getattr(ps, dtype))


def test_specific_out():
    for ps in (jps, tps):
        assert ps.specific_out("int32")(ps.float64)[0].dtype == "int32"


class _Triple(tps.UnaryScalarOp):
    def impl(self, x):
        return 3.0 * x

    def grad(self, inputs, gz):
        return [gz[0] * 3.0]


class _PowDiff(tps.BinaryScalarOp):
    """x**2 - y, with a torch lowering and L_op-style gradients."""

    def impl(self, x, y):
        return x * x - y

    def torch_impl(self, x, y):
        return x * x - y

    def L_op(self, inputs, outputs, gz):
        x, y = inputs
        return [gz[0] * 2 * x, -gz[0]]


def test_unary_host_path_reads_back():
    triple = _Triple(tps.upgrade_to_float, name="triple")
    x = tpt.dvector("x")
    y = TElemwise(triple)(x)
    assert y.type.dtype == "float64"
    f = tptt.function([x], y, device="cpu")
    np.testing.assert_allclose(np.asarray(f(np.array([1.0, 2.0]))), [3.0, 6.0])
    assert any("triple" in r for r in f.linked.host_reads)
    g = tG.grad(y.sum(), x)
    np.testing.assert_allclose(
        np.asarray(tptt.function([x], g, device="cpu")(np.array([1.0, 2.0]))), [3.0, 3.0])


def test_binary_torch_lowering_and_L_op():
    op = _PowDiff(tps.upgrade_to_float, name="powdiff")
    x, y = tpt.dvector("x"), tpt.dvector("y")
    out = TElemwise(op)(x, y)
    f = tptt.function([x, y], out, device="cpu")
    assert f.linked.host_reads == []
    np.testing.assert_allclose(np.asarray(f(np.array([2.0, 3.0]), np.array([1.0, 1.0]))),
                               [3.0, 8.0])
    gx, gy = tG.grad(out.sum(), [x, y])
    rx, ry = tptt.function([x, y], [gx, gy], device="cpu")(np.array([2.0, 3.0]),
                                                            np.array([1.0, 1.0]))
    np.testing.assert_allclose(np.asarray(rx), [4.0, 6.0])
    np.testing.assert_allclose(np.asarray(ry), [-1.0, -1.0])


def test_int_dtype_preference_and_pickle():
    triple = _Triple(tps.same_out, name="triple_same")
    x = tpt.lvector("x")
    y = TElemwise(triple)(x)
    assert y.type.dtype == "int64"
    np.testing.assert_array_equal(
        np.asarray(tptt.function([x], y, device="cpu")(np.array([2, 5]))), [6, 15])
    t = _Triple(tps.upgrade_to_float, name="triple")
    t2 = pickle.loads(pickle.dumps(t))
    assert t2 == t and type(t2) is _Triple


def test_custom_op_contracts():
    class NoGrad(tps.UnaryScalarOp):
        def impl(self, x):
            return x + 1

    y = TElemwise(NoGrad(tps.same_out, name="nograd"))(x := tpt.dvector("x"))
    with pytest.raises(Exception):
        tG.grad(y.sum(), x)

    class Bare(tps.UnaryScalarOp):
        def impl(self, x):
            return x

    with pytest.raises(NotImplementedError):
        TElemwise(Bare(name="bare"))(tpt.dvector("x"))
    with pytest.raises(TypeError):
        _Triple("float64", name="bad")


def test_logical_comparison_and_bit_ops():
    class Bigger(tps.LogicalComparison):
        def impl(self, x, y):
            return x > y

    class Inv(tps.UnaryBitOp):
        def impl(self, x):
            return ~x

    x, y = tpt.dvector("x"), tpt.dvector("y")
    out = TElemwise(Bigger(name="bigger"))(x, y)
    assert out.type.dtype == "bool"
    f = tptt.function([x, y], out, device="cpu")
    np.testing.assert_array_equal(np.asarray(f(np.array([1.0, 3.0]), np.array([2.0, 2.0]))),
                                  [False, True])
    i = tpt.lvector("i")
    g = tptt.function([i], TElemwise(Inv(name="inv"))(i), device="cpu")
    np.testing.assert_array_equal(np.asarray(g(np.array([0, 5]))), [-1, -6])
    with pytest.raises(TypeError):
        TElemwise(Inv(name="inv"))(x)


def test_composite_in_both_packages():
    for pkg, ptt, pt, _, kw in PKGS:
        ps = jps if pkg == "jax" else tps
        a, b = pt.dscalar("a"), pt.dscalar("b")
        comp = ps.Composite([a, b], [a * b + a])
        assert float(np.asarray(ptt.function([a, b], comp(a, b), **kw)(2.0, 3.0))) == 8.0
        x = pt.dvector("x")
        np.testing.assert_allclose(
            np.asarray(ptt.function([x], comp(x, x), **kw)(np.array([2.0, 3.0]))), [6.0, 12.0])
        c2 = ps.Composite([a], [a + 1, a * 2])
        assert tuple(float(np.asarray(v)) for v in ptt.function([a], c2(a), **kw)(3.0)) == (
            4.0, 6.0)
        fg = ps.Composite([a, b], [a * b]).fgraph
        assert len(fg.inputs) == 2 and len(fg.outputs) == 1


def test_misc_helpers():
    a = tpt.zvector("a")
    with pytest.raises(tps.ComplexError):
        tps.mod_check(a, a)
    np.testing.assert_allclose(tps.round_half_away_from_zero_vec(np.array([2.5, -2.5])),
                               [3.0, -3.0])
    assert issubclass(tps.ComplexError, NotImplementedError)
    assert issubclass(tps.IntegerDivisionError, Exception)
    assert tps.floats("p", "q")[1].type.dtype == "float64"
    assert tps.complex("z").type.dtype == "complex128"
    assert tps.convert_to_int32 is tps.basic.cast_op("int32")
    assert tps.ScalarInnerGraphOp is TScalarLoop
    assert tps.apply_across_args(tps.float64, tps.int64)("p", "q")[1].type.dtype == "int64"


def test_the_jax_packages_names_are_here():
    """Every name the JAX package's scalar namespace takes from compatnames,
    its graph-level re-exports included."""
    from pytensor_tpu.scalar import compatnames as jcn

    names = {n for n in vars(jcn) if not n.startswith("_")} | set(jcn._LAZY_COMPAT)
    missing = sorted(n for n in names
                     if not hasattr(tps, n) and n not in ("builtins", "np", "annotations",
                                                          "config"))
    assert not missing, missing

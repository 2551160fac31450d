"""The ShapeFeature in both packages: the cases of
``tests/test_shape_feature.py`` run against the port and the JAX package
alike (the same symbolic answers, the same rewritten graphs op for op, the
same values), and the two graphs on matrices of unknown shape that the port
left unrewritten before it had the feature: ``alloc(x + y, *x.shape)`` and
``reshape(exp(x), exp(x).shape)`` rewrite to one ``Elemwise``."""

from collections import Counter

import numpy as np
import pytest

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
from pytensor_tpu.graph.fg import FunctionGraph as JFunctionGraph
from pytensor_tpu.tensor.rewriting.shape import ShapeFeature as JShapeFeature
from pytensor_tpu.tensor.utils import shape_of_variables as j_shape_of_variables

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.graph.fg import FunctionGraph as TFunctionGraph
from pytensor_tpu_torch.tensor.rewriting.shape import ShapeFeature as TShapeFeature
from pytensor_tpu_torch.tensor.utils import shape_of_variables as t_shape_of_variables

PACKAGES = {"jax": (jptt, jpt, JFunctionGraph, JShapeFeature, {}),
            "torch": (tptt, tpt, TFunctionGraph, TShapeFeature, {"device": "cpu"})}


def _ops(f):
    return [type(n.op).__name__ for n in f.maker.fgraph.toposort()]


def _feature(pkg, inputs, outputs):
    _, _, FG, SF, _ = PACKAGES[pkg]
    fg = FG(inputs, outputs, clone=False)
    sf = SF()
    fg.attach_feature(sf)
    return fg, sf


def _both(case):
    """``case(pkg)`` for each package; the answers must agree."""
    got = {pkg: case(pkg) for pkg in PACKAGES}
    assert got["torch"] == got["jax"], got
    return got["torch"]


def test_static_shapes_are_ints():
    def case(pkg):
        pt = PACKAGES[pkg][1]
        x = pt.tensor("x", dtype="float32", shape=(4, 5))
        y = pt.exp(x)
        _, sf = _feature(pkg, [x], [y])
        return sf.shape_tuple(y)

    assert _both(case) == (4, 5)


def test_propagates_through_ops():
    def case(pkg):
        pt = PACKAGES[pkg][1]
        x = pt.tensor("x", dtype="float32", shape=(None, 7))
        w = pt.tensor("w", dtype="float32", shape=(7, 3))
        y = pt.tanh(pt.dot(x, w))
        _, sf = _feature(pkg, [x, w], [y])
        return sf.shape_tuple(y)[1], sf.same_shape(y, x, dim_a=0, dim_b=0)

    assert _both(case) == (3, True)


def test_same_shape_whole_and_different_inputs():
    def case(pkg):
        pt = PACKAGES[pkg][1]
        x = pt.tensor("x", dtype="float32", shape=(None, None))
        z = pt.tensor("z", dtype="float32", shape=(None, None))
        y = pt.exp(x) * 2 + 1
        _, sf = _feature(pkg, [x, z], [y, z + 0])
        return sf.same_shape(x, y), sf.same_shape(x, z)

    assert _both(case) == (True, False)


def test_cache_invalidation_on_change():
    def case(pkg):
        pt = PACKAGES[pkg][1]
        x = pt.tensor("x", dtype="float32", shape=(None, 3))
        y = pt.exp(x)
        fg, sf = _feature(pkg, [x], [y])
        sf.shape_tuple(y)
        filled = bool(sf._cache)
        sf.on_import(fg, y.owner, "test")
        return filled, bool(sf._cache)

    assert _both(case) == (True, False)


def test_attached_once_and_detached():
    """``ShapeOpt`` attaches the feature at the start of ``FAST_RUN`` and
    ``UnShapeOpt`` takes it off after specialize: a linked function's graph
    holds none; a second feature on one graph raises."""
    def case(pkg):
        ptt, pt, FG, SF, kw = PACKAGES[pkg]
        x = pt.tensor("x", dtype="float32", shape=(None,))
        f = ptt.function([x], pt.exp(x), **kw)
        fg, _ = _feature(pkg, [x], [x + 1])
        with pytest.raises(RuntimeError, match="already attached"):
            fg.attach_feature(SF())
        return hasattr(f.maker.fgraph, "shape_feature")

    assert _both(case) is False


@pytest.mark.parametrize("name", ["alloc(x + y, *x.shape)", "reshape(exp(x), exp(x).shape)"])
def test_unknown_shape_graphs_rewrite_to_one_elemwise(name):
    v = np.random.default_rng(0).standard_normal((3, 5))
    w = np.random.default_rng(1).standard_normal((3, 5))
    outs = {}

    def case(pkg):
        ptt, pt, _, _, kw = PACKAGES[pkg]
        x, y = pt.dmatrix("x"), pt.dmatrix("y")
        out = (pt.alloc(x + y, *x.shape) if name.startswith("alloc")
               else pt.reshape(pt.exp(x), pt.exp(x).shape))
        f = ptt.function([x, y], out, on_unused_input="ignore", **kw)
        outs[pkg] = np.asarray(f(v, w))
        return _ops(f)

    assert _both(case) == ["Elemwise"]
    want = v + w if name.startswith("alloc") else np.exp(v)
    np.testing.assert_allclose(outs["torch"], want, rtol=1e-15)
    np.testing.assert_allclose(outs["torch"], outs["jax"], rtol=1e-15)


def test_useless_reshape_dynamic():
    v = np.random.default_rng(0).standard_normal((3, 5)).astype("f4")

    def case(pkg):
        ptt, pt, _, _, kw = PACKAGES[pkg]
        x = pt.tensor("x", dtype="float32", shape=(None, 5))
        f = ptt.function([x], pt.reshape(pt.exp(x), pt.shape(pt.exp(x))), **kw)
        np.testing.assert_allclose(np.asarray(f(v)), np.exp(v), rtol=1e-6)
        return _ops(f)

    assert "Reshape" not in _both(case)


def test_reduce_of_makevector_folds():
    def case(pkg):
        ptt, pt, _, _, kw = PACKAGES[pkg]
        x = pt.tensor("x", dtype="float32", shape=(None, 4))
        f = ptt.function([x], pt.prod(pt.shape(x)), **kw)
        assert int(np.asarray(f(np.zeros((6, 4), "f4")))) == 24
        return _ops(f)

    ops = _both(case)
    assert "CAReduce" not in ops and "MakeVector" not in ops


def test_dynamic_mean_uses_single_shape_i():
    def case(pkg):
        ptt, pt, _, _, kw = PACKAGES[pkg]
        x = pt.tensor("x", dtype="float32", shape=(None,))
        y = pt.tensor("y", dtype="float32", shape=(None,))
        f = ptt.function([x, y], pt.mean(x * y), **kw)
        got = float(np.asarray(f(np.arange(5, dtype="f4"), np.ones(5, dtype="f4"))))
        assert got == 2.0
        return _ops(f)

    ops = _both(case)
    assert ops.count("Shape_i") == 1 and "MakeVector" not in ops


def test_dynamic_logreg_matches_static_structure():
    def case(pkg):
        ptt, pt, _, _, kw = PACKAGES[pkg]

        def build(batch):
            X = pt.tensor("X", dtype="float32", shape=(batch, 16))
            y = pt.tensor("y", dtype="float32", shape=(batch,))
            w = pt.tensor("w", dtype="float32", shape=(16,))
            b = pt.tensor("b", dtype="float32", shape=())
            p = pt.sigmoid(pt.dot(X, w) + b)
            eps = np.float32(1e-7)
            xent = -pt.mean(y * pt.log(p + eps) + (1 - y) * pt.log(1 - p + eps))
            gw, gb = ptt.grad(xent, [w, b])
            return ptt.function([X, y, w, b], [xent, gw, gb], **kw)

        return _ops(build(64)), _ops(build(None))

    static, dynamic = _both(case)
    assert len(dynamic) <= len(static) + 4 and dynamic.count("Shape_i") == 1
    assert Counter(dynamic)["Shape_i"] == 1


def test_shape_of_variables_through_the_feature():
    """``tensor/utils.py shape_of_variables`` attaches the feature and
    evaluates its symbolic entries: the same shapes in both packages."""
    got = {}
    for pkg, fn in (("jax", j_shape_of_variables), ("torch", t_shape_of_variables)):
        pt = PACKAGES[pkg][1]
        x = pt.dmatrix("x")
        y = pt.dot(x, x.T).sum(axis=0)
        fg, _ = _feature(pkg, [x], [y])
        shapes = fn(fg, {x: (5, 3)})
        got[pkg] = (tuple(int(d) for d in shapes[x]), tuple(int(d) for d in shapes[y]))
        assert hasattr(fg, "shape_feature")
    assert got["torch"] == got["jax"] == ((5, 3), (5,))

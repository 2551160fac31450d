"""The port's op library against the JAX package's, on the CPU.

One case for each scalar op of ``scalar/basic.py`` that the port added
(39 ops, every dtype the JAX package's op takes) and for each tensor op
of ``tensor/{elemwise,math,basic,shape,subtensor,blas}.py``,
``compile/ops.py``, ``tensor/type_other.py``, the gradient-manipulating
ops and ``TensorVariable``'s operators.  Each builds the same graph in
both packages on inputs from ``np.random.default_rng(seed)`` with
numpy's edges in front (NaN, +-inf, +-0.0, halves, negative integers,
integer divisors of 0, shift counts at and past the width) and compares
the port's ``function`` (FAST_RUN, the plain torch lowerings, fused
groups as K1's plain version) with the JAX package's numpy oracle
(``mode="FAST_COMPILE"``, the ``py`` linker), which the port follows
where XLA differs from it, and with the JAX package's XLA path on inputs
without those edges.  Integer and bool outputs are compared exactly;
floats at ``rtol 1e-6`` (float32) and ``1e-12`` (float64), unless the
case states another tolerance and why.
"""

import warnings

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt

RTOL = {"float32": 1e-6, "float64": 1e-12}
PKGS = (("jax", jptt, jpt), ("torch", tptt, tpt))


def _as_np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def _held(got, want, rtol=None, what="", zero_sign=True):
    got, want = _as_np(got), _as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert str(got.dtype) == str(want.dtype), (what, got.dtype, want.dtype)
    if got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_allclose(got, want, rtol=rtol or RTOL[str(got.dtype)], atol=0,
                               err_msg=what)
    if zero_sign and not what.startswith("xla"):
        # the oracle's sign of every zero (XLA's may differ; a product's
        # depends on its summation order, so the tensor cases skip this)
        zero = want == 0
        np.testing.assert_array_equal(np.signbit(got[zero]), np.signbit(want[zero]),
                                      err_msg=what + ": the sign of a zero")


def _compile(build, kinds=("oracle", "xla", "torch")):
    """Each package's function of the graph ``build(pt)`` gives."""
    fns = {}
    for name, ptt, pt in PKGS:
        inputs, outputs = build(pt)
        if name == "jax":
            if "oracle" in kinds:
                fns["oracle"] = ptt.function(inputs, outputs, mode="FAST_COMPILE")
            if "xla" in kinds:
                fns["xla"] = ptt.function(inputs, outputs)
        else:
            fns["torch"] = ptt.function(inputs, outputs, device="cpu")
    return fns


def _check(build, values, rtol=None, xla_values=None, kinds=("oracle", "xla", "torch"),
           xla_outputs=None, zero_sign=True):
    """The port against the oracle on ``values`` and against XLA on
    ``xla_values`` (``values`` when not given), for the outputs
    ``xla_outputs`` (all when not given)."""
    fns = _compile(build, kinds)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        got = fns["torch"](*values)
        if "oracle" in fns:
            want = fns["oracle"](*values)
            for k, (g, w) in enumerate(zip(got, want)):
                _held(g, w, rtol, f"oracle output {k}", zero_sign)
        if "xla" in fns:
            xv = values if xla_values is None else xla_values
            got_x = fns["torch"](*xv)
            for k, (g, w) in enumerate(zip(got_x, fns["xla"](*xv))):
                if xla_outputs is None or k in xla_outputs:
                    _held(g, w, rtol, f"xla output {k}")
    return got


# --- inputs -----------------------------------------------------------------------

N = 48


def _values(dtype, seed, edges=True, kind="any"):
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, size=N).astype(bool)
    if dtype.startswith("float"):
        if kind == "unit":
            body = rng.uniform(-1, 1, N)
        elif kind == "pos":
            body = rng.uniform(1.0, 6.0, N)
        else:
            body = rng.standard_normal(N) * 3
        edge = [np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, -0.5, 1.5, -2.5, 2.5, 1.0, -1.0]
        if edges:
            body[: len(edge)] = edge
        return body.astype(dtype)
    info = np.iinfo(dtype)
    body = rng.integers(-60, 60, size=N)
    if edges:
        body[:8] = [0, 1, -1, 7, -7, -3, 3, 2]
    return body.astype(dtype)


def _divisors(dtype, seed):
    """Divisors with 0s, negatives and -1."""
    v = _values(dtype, seed)
    if not dtype.startswith("float"):
        v[:6] = [2, -2, 0, -1, 3, -3]
        v[6::7] = 0
    return v


def _counts(dtype, seed):
    w = np.iinfo(dtype).bits
    rng = np.random.default_rng(seed)
    c = rng.integers(0, w, size=N)
    c[:8] = [0, 1, w - 1, w, w + 1, -1, -w, 2 * w]
    return c.astype(dtype)


FLOATS = ("float32", "float64")
INTS = ("int8", "int16", "int32", "int64")

# op -> (arity, dtypes, input kind); "float" ops of integer inputs compute
# in a float dtype (the graph's rule) and are checked in int32 too
UNARY_FLOAT = {
    "exp2": "any", "expm1": "any", "log1p": "any", "log2": "any", "log10": "any",
    "deg2rad": "any", "rad2deg": "any", "tan": "any", "cosh": "any", "sinh": "any",
    "arcsin": "unit", "arccos": "unit", "arctan": "any", "arcsinh": "any",
    "arccosh": "pos", "arctanh": "unit", "floor": "any", "ceil": "any", "trunc": "any",
}


@pytest.mark.parametrize("name", sorted(UNARY_FLOAT))
def test_unary_float_op(name):
    kind = UNARY_FLOAT[name]
    dts = FLOATS + ("int32",)

    def build(pt):
        xs = [pt.tensor(f"x{k}", dtype=dt, shape=(None,)) for k, dt in enumerate(dts)]
        return xs, [getattr(pt, name)(x) for x in xs]

    vals = [_values(dt, k, kind=kind) for k, dt in enumerate(dts)]
    clean = [_values(dt, k, edges=False, kind=kind) for k, dt in enumerate(dts)]
    # XLA computes a float op of int32 into float64 in float32 (ROADMAP
    # "Contracts"): the int32 output is held to the oracle only
    _check(build, vals, xla_values=clean, xla_outputs={0, 1})


@pytest.mark.parametrize("name", ["round_half_to_even", "round_half_away_from_zero"])
def test_rounding_op(name):
    """Halves round to even, or away from zero as the oracle computes it
    (copysign(floor(|x| + 0.5), x)); integers are themselves."""
    dts = FLOATS + ("int32", "int64")

    def build(pt):
        xs = [pt.tensor(f"x{k}", dtype=dt, shape=(None,)) for k, dt in enumerate(dts)]
        return xs, [getattr(pt, name)(x) for x in xs]

    vals = [_values(dt, k) for k, dt in enumerate(dts)]
    for v in vals[:2]:
        v[12:20] = [0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 3.5, 0.49999997]
    _check(build, vals, xla_values=vals)


@pytest.mark.parametrize("name", ["int_div", "mod"])
def test_floor_division_op(name):
    """numpy's floor_divide and mod: the quotient floored, the remainder
    with the divisor's sign, an integer divisor of 0 gives 0 (XLA gives
    other values there, so XLA is compared on nonzero divisors)."""
    dts = FLOATS + INTS

    def build(pt):
        xs = [pt.tensor(f"x{k}", dtype=dt, shape=(None,)) for k, dt in enumerate(dts)]
        ys = [pt.tensor(f"y{k}", dtype=dt, shape=(None,)) for k, dt in enumerate(dts)]
        return xs + ys, [getattr(pt, name)(x, y) for x, y in zip(xs, ys)]

    xs = [_values(dt, k) for k, dt in enumerate(dts)]
    ys = [_divisors(dt, 10 + k) for k, dt in enumerate(dts)]
    nz = [np.where(y == 0, 1, y).astype(y.dtype) for y in ys]
    fin = [np.nan_to_num(x, posinf=5.0, neginf=-5.0) if x.dtype.kind == "f" else x for x in xs]
    _check(build, xs + ys, xla_values=fin + nz)


@pytest.mark.parametrize("name", ["left_shift", "right_shift"])
def test_shift_op(name):
    """Counts below 0 or of the width or more give 0, or -1 for a negative
    value shifted right, as numpy gives (C leaves them undefined); XLA is
    compared on counts inside the width."""
    def build(pt):
        xs = [pt.tensor(f"x{k}", dtype=dt, shape=(None,)) for k, dt in enumerate(INTS)]
        cs = [pt.tensor(f"c{k}", dtype=dt, shape=(None,)) for k, dt in enumerate(INTS)]
        return xs + cs, [getattr(pt, name)(x, c) for x, c in zip(xs, cs)]

    xs = [_values(dt, k) for k, dt in enumerate(INTS)]
    cs = [_counts(dt, 20 + k) for k, dt in enumerate(INTS)]
    inside = [np.mod(c, np.iinfo(c.dtype).bits).astype(c.dtype) for c in cs]
    _check(build, xs + cs, xla_values=xs + inside)


@pytest.mark.parametrize("name", ["gt", "le", "neq", "minimum", "arctan2"])
def test_binary_op(name):
    dts = FLOATS if name == "arctan2" else FLOATS + ("int8", "int32", "int64", "bool")
    if name == "arctan2":
        dts = dts + ("int32",)

    def build(pt):
        xs = [pt.tensor(f"x{k}", dtype=dt, shape=(None,)) for k, dt in enumerate(dts)]
        ys = [pt.tensor(f"y{k}", dtype=dt, shape=(None,)) for k, dt in enumerate(dts)]
        return xs + ys, [getattr(pt, name)(x, y) for x, y in zip(xs, ys)]

    vals = [_values(dt, k) for k, dt in enumerate(dts)]
    vals += [_values(dt, 30 + k)[::-1].copy() for k, dt in enumerate(dts)]
    # arctan2 of int32 is float64, which XLA computes in float32 (ROADMAP
    # "Contracts"): held to the oracle only
    _check(build, vals, xla_outputs={0, 1} if name == "arctan2" else None)


@pytest.mark.parametrize("name", ["isnan", "isinf"])
def test_predicate_op(name):
    dts = FLOATS + ("int32",)

    def build(pt):
        xs = [pt.tensor(f"x{k}", dtype=dt, shape=(None,)) for k, dt in enumerate(dts)]
        return xs, [getattr(pt, name)(x) for x in xs]

    _check(build, [_values(dt, k) for k, dt in enumerate(dts)])


@pytest.mark.parametrize("name", ["and_", "or_", "xor", "invert"])
def test_bitwise_op(name):
    """On bools, and/or/xor are logical and invert is not (never ``~`` of
    a C bool); floats are refused when the graph is built."""
    dts = ("bool", "int8", "int32", "int64")

    def build(pt):
        xs = [pt.tensor(f"x{k}", dtype=dt, shape=(None,)) for k, dt in enumerate(dts)]
        ys = [pt.tensor(f"y{k}", dtype=dt, shape=(None,)) for k, dt in enumerate(dts)]
        fn = getattr(pt, name)
        outs = [fn(x) for x in xs] if name == "invert" else [fn(x, y) for x, y in zip(xs, ys)]
        return (xs if name == "invert" else xs + ys), outs

    vals = [_values(dt, k) for k, dt in enumerate(dts)]
    if name != "invert":
        vals += [_values(dt, 40 + k) for k, dt in enumerate(dts)]
    _check(build, vals)
    for pt in (jpt, tpt):
        f = pt.tensor("f", dtype="float32", shape=(None,))
        with pytest.raises(TypeError):
            getattr(pt, name)(f) if name == "invert" else getattr(pt, name)(f, f)


def test_switch_op():
    """switch with a bool and an integer condition, branches of several
    dtypes (the condition keeps its dtype; the branches compute in the
    output's)."""
    def build(pt):
        c = pt.tensor("c", dtype="bool", shape=(None,))
        k = pt.tensor("k", dtype="int32", shape=(None,))
        a = pt.tensor("a", dtype="float32", shape=(None,))
        b = pt.tensor("b", dtype="float64", shape=(None,))
        i = pt.tensor("i", dtype="int16", shape=(None,))
        return [c, k, a, b, i], [pt.switch(c, a, b), pt.switch(k, i, a), pt.switch(c, i, k)]

    _check(build, [_values("bool", 0), _values("int32", 1), _values("float32", 2),
                   _values("float64", 3), _values("int16", 4)])


def test_clip_op():
    """clip in the reference's order: the lower bound first, so lo > hi
    gives lo."""
    def build(pt):
        xs = [pt.tensor(f"x{k}", dtype=dt, shape=(None,)) for k, dt in
              enumerate(("float32", "float64", "int32"))]
        return xs, [pt.clip(xs[0], -0.5, 0.75), pt.clip(xs[1], xs[1] * 0.5, 1.0),
                    pt.clip(xs[2], 3, -3)]

    _check(build, [_values("float32", 0), _values("float64", 1), _values("int32", 2)])


def test_identity_op():
    from pytensor_tpu.scalar import basic as jps
    from pytensor_tpu.tensor.elemwise import Elemwise as JElemwise
    from pytensor_tpu_torch.scalar import basic as tps
    from pytensor_tpu_torch.tensor.elemwise import Elemwise as TElemwise

    def build(pt):
        ps, ew = (jps, JElemwise) if pt is jpt else (tps, TElemwise)
        xs = [pt.tensor(f"x{k}", dtype=dt, shape=(None,)) for k, dt in
              enumerate(("float32", "int8", "bool"))]
        return xs, [ew(ps.identity)(x) for x in xs]

    _check(build, [_values("float32", 0), _values("int8", 1), _values("bool", 2)])


NEW_SCALAR_OPS = {
    "gt", "le", "neq", "isnan", "isinf", "and_", "or_", "xor", "invert", "left_shift",
    "right_shift", "switch", "clip", "minimum", "identity", "int_div", "mod", "floor", "ceil",
    "trunc", "round_half_to_even", "round_half_away_from_zero", "exp2", "expm1", "log1p",
    "log2", "log10", "tan", "cosh", "sinh", "arcsin", "arccos", "arctan", "arctan2", "arcsinh",
    "arccosh", "arctanh", "deg2rad", "rad2deg"}


def test_the_39_scalar_ops_are_ported_with_their_rules():
    """Each op of the list exists with the JAX package's dtype rule and
    gradient (an op without one keeps that), and K1 and K2 emit it."""
    from pytensor_tpu.scalar import basic as jps
    from pytensor_tpu_torch.link.cuda.cexpr import CEXPR
    from pytensor_tpu_torch.scalar import basic as tps

    assert len(NEW_SCALAR_OPS) == 39
    for name in NEW_SCALAR_OPS:
        j, t = getattr(jps, name), getattr(tps, name)
        assert t.name == j.name == name and t.nin == j.nin and name in CEXPR
        assert (t.grad_fn is None) == (j.grad_fn is None), name
        for dts in (("float32",) * j.nin, ("int32",) * j.nin, ("int8", "float64", "int16")[:j.nin]):
            if name in ("and_", "or_", "xor", "invert") and "float" in "".join(dts):
                continue
            assert t.output_dtype(*dts) == j.output_dtype(*dts), (name, dts)


@pytest.mark.parametrize("name", ["tan", "arcsinh", "int_div", "mod", "minimum", "switch",
                                  "clip", "arctan2", "floor", "expm1"])
def test_scalar_op_gradient(name):
    """The gradient graphs of a few ops, evaluated in both packages."""
    def build(pt):
        x = pt.tensor("x", dtype="float64", shape=(None,))
        y = pt.tensor("y", dtype="float64", shape=(None,))
        if name == "switch":
            out = pt.switch(pt.gt(x, 0.0), x * y, y)
        elif name == "clip":
            out = pt.clip(x, -0.5, y)
        elif name in ("int_div", "mod", "minimum", "arctan2"):
            out = getattr(pt, name)(x, y)
        else:
            out = getattr(pt, name)(x) * y
        ptt = jptt if pt is jpt else tptt
        return [x, y], list(ptt.grad(pt.sum(out), [x, y]))

    rng = np.random.default_rng(5)
    x, y = rng.uniform(-0.9, 0.9, N), rng.uniform(0.5, 2.0, N)
    _check(build, [x, y], kinds=("xla", "torch"))


# --- tensor ops ------------------------------------------------------------------------

def _mat(seed, shape=(4, 5), dtype="float64"):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _int(pt, x, k=4):
    return pt.cast(x * k, "int32")


# one case for each tensor op: op name -> the outputs of x, a (4, 5)
# float64 matrix with a zero at [0, 0]
TENSOR_CASES = {
    # tensor/elemwise.py and the CAReduce family
    "Elemwise.outer": lambda pt, x: [pt.add.outer(x[0], x[1]), pt.maximum.outer(x[0], x[:, 1])],
    "prod": lambda pt, x: [pt.prod(x), pt.prod(x, axis=1), pt.prod(_int(pt, x), axis=0),
                           pt.prod(x, keepdims=True)],
    "min": lambda pt, x: [pt.min(x), pt.min(x, axis=0), pt.min(_int(pt, x), axis=1)],
    "any": lambda pt, x: [pt.any(pt.gt(x, 1.0), axis=1), pt.any(x), pt.any(_int(pt, x, 0))],
    "all": lambda pt, x: [pt.all(x), pt.all(pt.gt(x, -1.0), axis=0), pt.all(_int(pt, x))],
    "acc_dtype": lambda pt, x: [pt.sum(pt.cast(x * 4, "int8"), acc_dtype="int64"),
                                pt.sum(x, dtype="float32"),
                                pt.prod(pt.cast(x, "float32"), acc_dtype="float64")],
    # tensor/math.py
    "mean": lambda pt, x: [pt.mean(x), pt.mean(x, axis=1, keepdims=True),
                           pt.mean(_int(pt, x)), pt.mean(x, axis=(0, 1))],
    "var": lambda pt, x: [pt.var(x), pt.var(x, axis=0), pt.var(x, axis=1, ddof=1)],
    "std": lambda pt, x: [pt.std(x), pt.std(x, axis=1, ddof=1, keepdims=True)],
    "argmax": lambda pt, x: [pt.argmax(x), pt.argmax(x, axis=1),
                             pt.argmax(x, axis=(0, 1), keepdims=True), pt.argmax(x, axis=-1)],
    "argmin": lambda pt, x: [pt.argmin(x), pt.argmin(x, axis=0), pt.argmin(_int(pt, x), axis=1)],
    "max_and_argmax": lambda pt, x: [*pt.max_and_argmax(x, axis=1)],
    "outer": lambda pt, x: [pt.outer(x[0], x[1]), pt.outer(x, x[0])],
    "matmul": lambda pt, x: [pt.matmul(x, x.T), pt.matmul(x[0], x.T), pt.matmul(x, x[0])],
    "dot": lambda pt, x: [pt.dot(x[0], x.T), pt.dot(x, x[0]), pt.dot(x[0], x[0]), x @ x.T],
    "tensordot": lambda pt, x: [pt.tensordot(x, x, [[1], [1]]), pt.tensordot(x, x, 2)],
    "vecdot": lambda pt, x: [pt.vecdot(x, x)],
    "ptp": lambda pt, x: [pt.ptp(x, axis=0), pt.ptp(x)],
    "norm": lambda pt, x: [pt.norm(x, 1), pt.norm(x, 2, axis=1), pt.norm(x, np.inf),
                           pt.norm(x, 3)],
    "logsumexp": lambda pt, x: [pt.logsumexp(x, axis=1), pt.logsumexp(x)],
    "logaddexp": lambda pt, x: [pt.logaddexp(x, -x)],
    "cov": lambda pt, x: [pt.cov(x), pt.cov(x, rowvar=False)],
    "sign": lambda pt, x: [pt.sign(x), pt.sgn(x), pt.sign(_int(pt, x))],
    "round": lambda pt, x: [pt.round(x * 2), pt.round(x * 2, "half_away_from_zero"),
                            pt.iround(x * 2)],
    "isclose": lambda pt, x: [pt.isclose(x, x + 1e-9), pt.isclose(x, x * 1.1),
                              pt.allclose(x, x)],
    "xlogx": lambda pt, x: [pt.xlogx(pt.abs(x)), pt.xlogy0(pt.abs(x), pt.abs(x) + 1)],
    "prod_without_zeros": lambda pt, x: [pt.prod_without_zeros(pt.floor(x), axis=0)],
    "choose": lambda pt, x: [pt.choose(np.array([[0, 1, 1, 0, 1]] * 4), [x, -x])],
    "smallest_largest": lambda pt, x: [pt.smallest(x, -x, x * 2), pt.largest(x, -x, x * 2)],
    "power_divmod": lambda pt, x: [pt.power(pt.abs(x), 1.5), *pt.divmod(x, 0.7)],
    # tensor/basic.py
    "alloc": lambda pt, x: [pt.alloc(x[0], 3, 5), pt.alloc(0.5, 2, 3)],
    "zeros_ones_full": lambda pt, x: [pt.zeros((2, 3)), pt.ones((3,), dtype="int32"),
                                      pt.full((2, 2), 7.5), pt.full_like(x, 2.0),
                                      pt.zeros_like(x) + x.shape[0]],
    "eye": lambda pt, x: [pt.eye(3, 4, 1), pt.eye(3), pt.identity_like(x)],
    "tri": lambda pt, x: [pt.tri(3, 4, -1), pt.tri(x.shape[0], x.shape[1], 1)],
    "tril_triu": lambda pt, x: [pt.tril(x), pt.triu(x, 1), pt.tril(x, -1)],
    "arange": lambda pt, x: [pt.arange(2, 11, 3), pt.arange(0.5, 3.0, 0.25),
                             pt.arange(x.shape[0])],
    "join_concatenate": lambda pt, x: [pt.concatenate([x, x * 2], axis=1), pt.join(0, x, -x)],
    "split": lambda pt, x: [*pt.split(x, [1, 3], 2, axis=0), *pt.split(x, [2, 3], 2, axis=1)],
    "stack": lambda pt, x: [pt.stack([x, -x]), pt.stack([x[0], x[1]], axis=1),
                            pt.stack([x[0, 0], x[1, 1]])],
    "horizontal_vertical_stack": lambda pt, x: [pt.horizontal_stack(x, x),
                                                pt.vertical_stack(x, x)],
    "diagonal": lambda pt, x: [pt.diagonal(x, 1), pt.extract_diag(x), pt.trace(x)],
    "diag": lambda pt, x: [pt.diag(x[0]), pt.diag(x), pt.diag(x[1], -1), pt.diag(x[1], 2)],
    "flatten": lambda pt, x: [pt.flatten(x), pt.flatten(x, 2)],
    "transposes": lambda pt, x: [pt.matrix_transpose(x), pt.swapaxes(x, 0, 1),
                                 pt.moveaxis(x, 0, 1), pt.transpose(x)],
    "expand_dims": lambda pt, x: [pt.expand_dims(x, (0, 2)), pt.shape_padleft(x),
                                  pt.shape_padright(x, 2), pt.shape_padaxis(x, 1),
                                  pt.atleast_2d(x[0])],
    "tile": lambda pt, x: [pt.tile(x, (2, 1)), pt.tile(x[0], 3)],
    "where": lambda pt, x: [pt.where(pt.gt(x, 0.0), x, -1.0)],
    "meshgrid": lambda pt, x: [*pt.meshgrid(x[0], x[1]), *pt.meshgrid(x[0], x[:, 1],
                                                                       indexing="ij")],
    # tensor/shape.py
    "unbroadcast": lambda pt, x: [pt.unbroadcast(pt.shape_padleft(x), 0),
                                  pt.specify_broadcastable(x[:1], 0)],
    "reshape": lambda pt, x: [pt.reshape(x, (5, 4)), pt.reshape(x, (-1,)), x.reshape((2, 10))],
    "shape": lambda pt, x: [pt.shape(x), x.shape[1], pt.stack(list(pt.shape_tuple(x)))],
    # tensor/subtensor.py
    "take": lambda pt, x: [pt.take(x, np.array([0, 2, -1])),
                           pt.take(x, np.array([1, 3]), axis=1),
                           pt.take(x[0], np.array([7, -9]), mode="wrap"),
                           pt.take(x[0], np.array([7, -9]), mode="clip")],
    "take_along_axis": lambda pt, x: [pt.take_along_axis(x, np.array([[0], [2], [1], [4]]), 1)],
    "flip": lambda pt, x: [pt.flip(x, 0), pt.flip(x)],
    "advanced_inc_set": lambda pt, x: [pt.inc_subtensor(x[np.array([3, 3])], x[:2]),
                                       pt.set_subtensor(x[np.array([1, 0])], x[:2])],
    "boolean_mask": lambda pt, x: [x[np.array([True, False, True, False])]],
    # tensor/blas.py
    "Gemm": lambda pt, x: [pt.blas.gemm(x, 0.5, x, pt.eye(5, 5, 0, "float64") * 2, 0.25)],
    "Dot22": lambda pt, x: [pt.blas._dot22(x, x.T)],
    "Dot22Scalar": lambda pt, x: [pt.blas._dot22scalar(x, x.T, 3.0)],
    "Gemv": lambda pt, x: [pt.blas.gemv(x[:, 0], 2.0, x, x[0], 0.5)],
    "Ger": lambda pt, x: [pt.blas.ger(x, 0.5, x[:, 1], x[2])],
    "BatchedDot": lambda pt, x: [pt.batched_dot(pt.stack([x, x]), pt.stack([x.T, 2 * x.T]))],
    # compile/ops.py and the gradient-manipulating ops
    "ViewOp_DeepCopyOp": lambda pt, x: [pt.tensor_copy(x), x.copy()],
    "grad_ops": lambda pt, x: _grad_ops(pt, x),
    # tensor/variable.py operators
    "operators_arithmetic": lambda pt, x: [abs(x), x // 0.7, x % 0.7, divmod(x, 0.7)[0], -x, +x,
                                           x ** 2, 2 ** x],
    "operators_bitwise": lambda pt, x: [~_int(pt, x, 3) & 5 | 2 ^ _int(pt, x, 1),
                                        _int(pt, x) << 2, _int(pt, x, 9) >> 1],
    "operators_methods": lambda pt, x: [x.prod(axis=0), x.mean(), x.var(), x.std(axis=1),
                                        x.min(), x.argmax(), x.argmin(axis=1), x.any(), x.all(),
                                        x.ptp(), x.round(), x.clip(-0.3, 0.3), x.trace(),
                                        x.diagonal(), x.take([1, 2], axis=1), x.T, x.mT,
                                        x.ravel(), x.dimshuffle(1, 0), x.squeeze(),
                                        x[None].squeeze(0), x.norm(2),
                                        x.sum(axis=1, keepdims=True), x.dot(x[0])],
}


def _grad_ops(pt, x):
    ptt = jptt if pt is jpt else tptt
    from importlib import import_module

    g = import_module(ptt.__name__ + ".gradient")
    y = pt.sum(x ** 2 * g.zero_grad(x) + g.grad_clip(x, -0.1, 0.1) ** 2
               + g.grad_scale(x ** 3, 0.5) + g.disconnected_grad(x) * x)
    return [g.zero_grad(x) * 1.0, ptt.grad(y, x)]


@pytest.mark.parametrize("case", sorted(TENSOR_CASES))
def test_tensor_op(case):
    fn = TENSOR_CASES[case]

    def build(pt):
        x = pt.tensor("x", dtype="float64", shape=(4, 5))
        return [x], fn(pt, x)

    vals = [_mat(7)]
    vals[0][0, 0] = 0.0
    _check(build, vals, zero_sign=False)


# an index with duplicates in each form the port lowers apart: a 1-d index
# on axis 0 (AdvancedIncSubtensor1), on another axis with full slices
# elsewhere (index_copy_), and several array indices (flat positions)
DUPLICATE_INDEX = {
    "axis0": (lambda x: x[np.array([1, 3, 1, 0, 3])], (5, 5)),
    "axis1": (lambda x: x[:, np.array([4, 2, 4, 4])], (4, 4)),
    "flat": (lambda x: x[np.array([0, 2, 0, 3, 0]), np.array([1, 3, 1, 4, 1])], (5,)),
}


@pytest.mark.parametrize("mode", ["set", "inc_ignore_duplicates"])
@pytest.mark.parametrize("form", sorted(DUPLICATE_INDEX))
def test_duplicate_index_write_takes_the_last(form, mode):
    """A set, or an increment that ignores duplicates (numpy's
    ``x[idx] += y``), of an index with duplicates: each position takes its
    last write, as in the oracle (the port makes every write of a position
    the same value, so the card's undefined order of writes cannot show)."""
    index, y_shape = DUPLICATE_INDEX[form]

    def build(pt):
        x = pt.tensor("x", dtype="float64", shape=(4, 5))
        y = pt.tensor("y", dtype="float64", shape=y_shape)
        out = (pt.set_subtensor(index(x), y) if mode == "set"
               else pt.inc_subtensor(index(x), y, ignore_duplicates=True))
        return [x, y], [out]

    y = np.arange(1.0, 1.0 + np.prod(y_shape)).reshape(y_shape)
    _check(build, [_mat(3), y], kinds=("oracle", "torch"))


def test_nonzero_and_alloc_empty():
    """Nonzero's outputs depend on the data (the port reads them back; the
    JAX package's XLA path refuses them, so they are held to the
    oracle); AllocEmpty's values are undefined, its shape and dtype are
    compared."""
    def build(pt):
        x = pt.tensor("x", dtype="float64", shape=(None, None))
        return [x], [*pt.nonzero(pt.gt(x, 0.5)), pt.flatnonzero(x),
                     pt.nonzero_values(pt.gt(x, 0.0) * x), pt.where(pt.gt(x, 1.0))[1]]

    _check(build, [_mat(8)], kinds=("oracle", "torch"))
    outs = []
    for name, ptt, pt in PKGS:
        from importlib import import_module

        AllocEmpty = import_module(pt.__name__ + ".basic").AllocEmpty
        n = pt.tensor("n", dtype="int64", shape=())
        kw = {"device": "cpu"} if name == "torch" else {}
        f = ptt.function([n], AllocEmpty("float32")(n, 3) * 0, **kw)
        outs.append(_as_np(f(4)))
    assert outs[0].shape == outs[1].shape == (4, 3) and outs[0].dtype == outs[1].dtype


def test_variable_operators_of_the_python_protocol():
    """``len``, ``iter``, ``__setitem__``'s refusal, ``__bool__``'s."""
    for pt in (jpt, tpt):
        x = pt.tensor("x", dtype="float64", shape=(3, 2))
        assert len(x) == 3 and len(list(iter(x))) == 3
        with pytest.raises(TypeError):
            x[0] = 1.0
        with pytest.raises(TypeError):
            bool(x)
        with pytest.raises(TypeError):
            len(pt.tensor("y", dtype="float64", shape=(None,)))


def test_get_scalar_constant_value_and_errors():
    from pytensor_tpu_torch.tensor.exceptions import NotScalarConstantError, ShapeError

    for pt in (jpt, tpt):
        x = pt.tensor("x", dtype="float64", shape=(3, None))
        assert int(pt.get_scalar_constant_value(pt.shape(x)[0] * 2 + 1)) == 7
        assert float(pt.get_scalar_constant_value(pt.cast(pt.constant(2.5), "float32"))) == 2.5
    with pytest.raises(NotScalarConstantError):
        tpt.get_scalar_constant_value(tpt.tensor("y", dtype="float64", shape=()))
    assert issubclass(ShapeError, Exception)


def test_tensor_utils_and_shared_shape():
    from pytensor_tpu.tensor import utils as jutils
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.tensor import utils as tutils

    a = np.arange(12.0).reshape(3, 4)
    assert tutils.hash_from_ndarray(a) == jutils.hash_from_ndarray(a)
    x = tpt.tensor("x", dtype="float64", shape=(None, None))
    fg = FunctionGraph([x], [tpt.dot(x, x.T).sum(axis=0)], clone=False)
    shapes = tutils.shape_of_variables(fg, {x: (3, 4)})
    assert tuple(int(s) for s in shapes[fg.outputs[0]]) == (3,)
    s = tptt.shared(np.zeros((2, 3)), name="s", shape=(2, 3), device="cpu")
    assert s.type.shape == (2, 3)
    assert jptt.shared(np.zeros((2, 3)), shape=(2, 3)).type.shape == s.type.shape
    with pytest.raises(ValueError):
        tptt.shared(np.zeros((2, 3)), shape=(2, 4), device="cpu")


def test_make_slice_lowering():
    from pytensor_tpu_torch.link.torch.dispatch import torch_funcify
    from pytensor_tpu_torch.tensor.type_other import MakeSlice, make_slice

    a = tpt.tensor("a", dtype="int64", shape=())
    node = make_slice(a, 9, 2).owner
    fn = torch_funcify(node.op, node=node, device="cpu")
    assert fn(torch.tensor(1), torch.tensor(9), torch.tensor(2)) == slice(1, 9, 2)
    assert isinstance(node.op, MakeSlice)


# the seven shape-parameter gradient ops of scalar/math.py (ROADMAP Queue 1
# item 10b): defined by tensor/math.py in the JAX package; in the port the
# seven raise NotImplementedError (tests/test_torch_special.py).  The
# complex ops are here (tests/test_torch_complex.py)
NOT_YET = {
    "betainc_dda", "betainc_ddb", "gammainc_ddk", "gammaincc_ddk", "hyp2f1_dda", "hyp2f1_ddb",
    "hyp2f1_ddc",
}


def test_namespace_holds_every_public_name_of_the_modules():
    """Every public name that the JAX package's tensor namespace takes from
    tensor/{elemwise,math,basic,shape,subtensor,blas,utils,exceptions,
    sharedvar,variable,type_other}.py and compile/ops.py is in the port's,
    apart from NOT_YET: the special functions among them since item 10."""
    import importlib

    mods = ["tensor.elemwise", "tensor.math", "tensor.basic", "tensor.shape", "tensor.subtensor",
            "tensor.blas", "tensor.utils", "tensor.exceptions", "tensor.sharedvar",
            "tensor.variable", "tensor.type_other", "compile.ops"]
    names = set()
    for m in mods:
        jm = importlib.import_module("pytensor_tpu." + m)
        names |= {n for n, v in list(vars(jm).items())
                  if not n.startswith("_") and n in dir(jpt) and getattr(jpt, n) is v
                  and type(v).__name__ != "module"}
    missing = sorted(n for n in names - NOT_YET if not hasattr(tpt, n))
    assert not missing, missing
    assert NOT_YET <= names  # each exclusion is a name those modules define
    assert len(names) > 280


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_floor_division_of_a_signed_zero_follows_the_oracle(dtype):
    """A reference behaviour, not a fault: ``(-0.0) // 0.3`` is -0.0 in the
    numpy oracle and the port and +0.0 on the XLA path, and ``(-0.0) //
    -0.3`` +0.0 against the XLA path's -0.0 (XLA's zero takes the
    divisor's sign); ``0.0 // 0.3`` and ``0.0 // -0.3`` agree in all three."""
    def build(pt):
        x, y = pt.vector("x", dtype=dtype), pt.vector("y", dtype=dtype)
        return [x, y], [x // y]

    x = np.array([-0.0, 0.0, -0.0, 0.0], dtype=dtype)
    y = np.array([0.3, 0.3, -0.3, -0.3], dtype=dtype)
    fns = _compile(build)
    got = _check(build, [x, y], kinds=("oracle", "torch"))[0]
    np.testing.assert_array_equal(np.signbit(_as_np(got)), [True, False, False, True])
    xla = np.asarray(fns["xla"](x, y)[0])
    np.testing.assert_array_equal(np.signbit(xla), [False, False, True, True])

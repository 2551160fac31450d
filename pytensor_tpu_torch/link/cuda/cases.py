"""The cases that hold K1 and K2 on the ops of the expression table and
K2's new ops against their plain versions.

``scalar_op_group(dtype)`` is one fused node a dtype computing every op
of ``cexpr.py``'s table that takes that dtype, ``op_group_inputs`` its
inputs with numpy's edges (NaN, +-inf, +-0.0, halves, integer extremes,
shift counts past the width), and ``k2_new_op_scans()`` the scans of
``Dot22``, ``Gemm``, ``Dot22Scalar``, ``Join``, ``Split``, ``ARange``,
``DeepCopyOp`` and ``ViewOp`` that K2 runs against its step loop; and
for the special functions (``link/cuda/special.py``) each op's grid
(``SPECIAL_GRIDS``, ``special_node``, ``special_inputs``), scipy's value
(``scipy_special``) and one fused node a dtype of every one of them
(``special_op_group``).  ``chip_smoke.py`` and the card tests
(``tests/test_torch_cuda.py``) use them alike.
"""

from __future__ import annotations

import numpy as np

import pytensor_tpu_torch as ptt
import pytensor_tpu_torch.tensor as pt
from pytensor_tpu_torch.compile.ops import deep_copy_op, view_op
from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.scalar import basic as ps
from pytensor_tpu_torch.tensor import blas
from pytensor_tpu_torch.tensor.basic import ARange, Split, constant
from pytensor_tpu_torch.tensor.elemwise import Elemwise
from pytensor_tpu_torch.tensor.type import TensorType
from pytensor_tpu_torch.utils import dtype_kind, np_dtype
# the scalar ops whose value is exact: held value for value (NaN at
# the same places) against the plain version; the others at K1_RTOL over
# max(1, |plain|)
EXACT_OPS = {"gt", "le", "eq", "neq", "isnan", "isinf", "minimum", "and_", "or_", "xor",
             "invert", "left_shift", "right_shift", "int_div", "mod", "switch", "clip",
             "identity", "floor", "ceil", "trunc", "round_half_to_even",
             "round_half_away_from_zero", "deg2rad", "rad2deg", "sign"}
OP_GROUP_DTYPES = ("float32", "float64", "bool", "int8", "int16", "int32", "int64")
def edge_values(dtype, n, seed):
    """n values of ``dtype`` with numpy's edges in front: NaN, +-inf, +-0.0,
    halves for the floats; negatives, 0, the extremes for the integers."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, size=n).astype(bool)
    if dtype_kind(dtype) == "f":
        edge = [np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, -0.5, 1.5, -2.5, 2.5, 0.49999997,
                -0.49999997, 1.0, -1.0, 7.0, -7.0]
        return np.concatenate([edge, rng.standard_normal(n - len(edge)) * 4]).astype(
            np_dtype(dtype))
    info = np.iinfo(dtype)
    edge = [0, 1, -1, 7, -7, 3, -3, info.min, info.max, info.min + 1]
    return np.concatenate([edge, rng.integers(-50, 50, size=n - len(edge))]).astype(dtype)


def shift_counts(dtype, n, seed):
    """Shift counts at, below and past the width, and negative ones."""
    w = np.iinfo(dtype).bits
    edge = [0, 1, w - 1, w, w + 1, -1, -w, 2 * w]
    rng = np.random.default_rng(seed)
    return np.concatenate([edge, rng.integers(0, w, size=n - len(edge))]).astype(dtype)


def scalar_op_group(dtype):
    """(inputs, outputs, op names): one fused node a dtype computing every
    op of the expression table that takes that dtype."""
    ident = Elemwise(ps.identity)
    if dtype == "bool":
        p, q, c = (pt.tensor(k, dtype="bool", shape=(None,)) for k in "pqc")
        names = ["and_", "or_", "xor", "minimum", "gt", "le", "eq", "neq"]
        outs = [getattr(pt, k)(p, q) for k in names]
        outs += [pt.invert(p), ident(p), pt.switch(c, p, q)]
        return [p, q, c], outs, names + ["invert", "identity", "switch"]
    if dtype.startswith("float"):
        x, y, z = (pt.tensor(k, dtype=dtype, shape=(None,)) for k in "xyz")
        c = pt.tensor("c", dtype="bool", shape=(None,))
        unary = ["exp2", "expm1", "log1p", "log2", "log10", "deg2rad", "rad2deg", "tan", "cosh",
                 "sinh", "arcsin", "arccos", "arctan", "arcsinh", "arccosh", "arctanh", "floor",
                 "ceil", "trunc", "round_half_to_even", "round_half_away_from_zero", "isnan",
                 "isinf", "sign"]
        binary = ["arctan2", "int_div", "mod", "minimum", "gt", "le", "eq", "neq"]
        outs = ([getattr(pt, k)(x) for k in unary] + [ident(x)]
                + [getattr(pt, k)(x, y) for k in binary]
                + [pt.clip(x, y, z), pt.switch(c, x, y)])
        return [x, y, z, c], outs, unary + ["identity"] + binary + ["clip", "switch"]
    a, b, s = (pt.tensor(k, dtype=dtype, shape=(None,)) for k in "abs")
    c = pt.tensor("c", dtype="int32", shape=(None,))
    binary = ["int_div", "mod", "and_", "or_", "xor", "minimum", "gt", "le", "eq", "neq"]
    outs = [getattr(pt, k)(a, b) for k in binary]
    outs += [pt.left_shift(a, s), pt.right_shift(a, s), pt.invert(a), pt.clip(a, b, s),
             pt.switch(c, a, b), pt.round_half_to_even(a), pt.round_half_away_from_zero(a),
             pt.isnan(a), pt.isinf(a), pt.floor(a), ident(a), pt.sign(a)]
    return [a, b, s, c], outs, binary + [
        "left_shift", "right_shift", "invert", "clip", "switch", "round_half_to_even",
        "round_half_away_from_zero", "isnan", "isinf", "floor", "identity", "sign"]


# the bfloat16 ops whose value the plain version (torch's bfloat16 ops) and
# K1 both round once from an exact or exactly rounded value: held bit for
# bit; the others within 1 bfloat16 ulp (each library's float function,
# rounded once)
BF16_EXACT_OPS = {"neg", "abs", "sqr", "add", "sub", "mul", "true_div", "maximum", "minimum",
                  "gt", "lt", "ge", "le", "eq", "neq", "isnan", "isinf", "switch", "clip",
                  "identity", "floor", "ceil", "trunc", "round_half_to_even",
                  "round_half_away_from_zero", "sign", "deg2rad", "rad2deg", "sqrt",
                  "reciprocal", "mod", "add3", "mul3"}


def bf16_op_group():
    """(inputs, outputs, op names): every op of the expression table that
    K1 emits in bfloat16 (all but the special functions, ``second`` and
    ``int_div``), each one Elemwise node on the inputs (x, y, z bfloat16
    vectors, c a bool one), and a three-operand add and mul."""
    x, y, z = (pt.tensor(k, dtype="bfloat16", shape=(None,)) for k in "xyz")
    c = pt.tensor("c", dtype="bool", shape=(None,))
    unary = ["exp", "log", "sqrt", "sin", "cos", "tanh", "sigmoid", "neg", "abs", "sqr",
             "reciprocal", "exp2", "expm1", "log1p", "log2", "log10", "deg2rad", "rad2deg",
             "tan", "cosh", "sinh", "arcsin", "arccos", "arctan", "arcsinh", "arccosh",
             "arctanh", "floor", "ceil", "trunc", "round_half_to_even",
             "round_half_away_from_zero", "isnan", "isinf", "sign"]
    binary = ["add", "sub", "mul", "true_div", "pow", "maximum", "minimum", "arctan2", "mod",
              "gt", "lt", "ge", "le", "eq", "neq"]
    outs = ([getattr(pt, k)(x) for k in unary] + [Elemwise(ps.identity)(x)]
            + [getattr(pt, k)(x, y) for k in binary]
            + [pt.clip(x, y, z), pt.switch(c, x, y), Elemwise(ps.mul)(x, y, z),
               Elemwise(ps.add)(x, y, z)])
    return [x, y, z, c], outs, unary + ["identity"] + binary + ["clip", "switch", "mul3", "add3"]


def op_group_inputs(dtype, inputs, n):
    """Edge values for each input of a group; each edge of one operand
    meets the other's in turn."""
    vals = []
    for j, v in enumerate(inputs):
        x = (shift_counts(dtype, n, j) if v.name == "s" and dtype.startswith("int")
             else edge_values(v.type.dtype, n, 100 * j + len(dtype)))
        vals.append(np.roll(x, j) if j % 2 else x)
    return vals


def k2_new_op_scans():
    """The scans of K2's cases of its new ops, each (tag, inputs, outputs, values):
    ``tanh(dot(W, acc))`` with a 5 x 5 W (the JAX package's
    tests/test_scan.py:738), a body of Dot22, Gemm and Dot22Scalar, and a
    body of Join, Split, ARange, DeepCopyOp and ViewOp (as built, since the
    rewrites would fold its ARanges; its Splits carry the static types
    that a known length gives them)."""
    rng = np.random.default_rng(9)
    v0 = pt.tensor("v0", dtype="float32", shape=(5,))
    W = pt.as_tensor_variable((np.eye(5) * 0.9 + 0.01).astype("float32"))
    tr, _ = ptt.scan(lambda acc: pt.tanh(pt.dot(W, acc)) + np.float32(0.01),
                     outputs_info=[v0], n_steps=10)
    cases = [("tanh(dot(W, acc)), W 5x5", [v0], [tr],
              [rng.standard_normal(5).astype("float32")], False)]

    M0 = pt.tensor("M0", dtype="float32", shape=(4, 6))
    u0 = pt.tensor("u0", dtype="float32", shape=(300,))
    Wc = pt.as_tensor_variable((rng.standard_normal((6, 6)) * 0.3).astype("float32"))
    A = pt.as_tensor_variable((rng.standard_normal((2, 300)) * 0.1).astype("float32"))
    B = pt.as_tensor_variable((rng.standard_normal((300, 3)) * 0.1).astype("float32"))

    def blas_step(M, u):
        d = blas._dot22(M, Wc)
        g = blas.gemm(M, np.float32(0.5), M, Wc, np.float32(0.25))
        s = blas._dot22scalar(M, Wc, np.float32(0.1))
        wide = blas._dot22(A * u.dimshuffle("x", 0), B)
        return (pt.tanh(d * np.float32(0.1) + g * np.float32(0.1) + s), u * np.float32(0.9),
                wide.sum())

    outs, _ = ptt.scan(blas_step, outputs_info=[M0, u0, None], n_steps=4)
    cases.append(("Dot22, Gemm, Dot22Scalar", [M0, u0], list(outs),
                  [rng.standard_normal((4, 6)).astype("float32"),
                   rng.standard_normal(300).astype("float32")], False))

    def static_split(x, sizes, axis):
        types = []
        for n in sizes:
            shape = list(x.type.shape)
            shape[axis] = n
            types.append(TensorType(x.type.dtype, tuple(shape))())
        return Apply(Split(len(sizes)), [x, constant(np.int64(axis)),
                                         constant(np.asarray(sizes, "int64"))], types).outputs

    w0 = pt.tensor("w0", dtype="float32", shape=(6,))
    N0 = pt.tensor("N0", dtype="float32", shape=(3, 4))

    def join_step(v, M):
        a, b = static_split(v, [2, 4], 0)
        j = pt.join(np.int64(0), b, a)
        p, q = static_split(M, [1, 3], 1)
        jm = pt.join(np.int64(1), q * np.float32(0.5), p)
        r = ARange("float32")(np.float32(0.5), np.float32(3.5), np.float32(0.5))
        ri = pt.cast(ARange("int64")(np.int64(-5), np.int64(13), np.int64(3)), "float32")
        top, bottom = static_split(M, [2, 1], 0)
        jr = pt.join(np.int64(0), bottom, top)
        return (deep_copy_op(j) * np.float32(0.5) + r * np.float32(0.1) + ri * np.float32(0.01),
                view_op(jm + jr * np.float32(0.25)))

    outs, _ = ptt.scan(join_step, outputs_info=[w0, N0], n_steps=3)
    cases.append(("Join, Split, ARange, DeepCopyOp, ViewOp", [w0, N0], list(outs),
                  [np.arange(6, dtype="float32"), np.arange(12, dtype="float32").reshape(3, 4)],
                  True))
    return cases


# --- the special functions (link/cuda/special.py) ----------------------------------

# op -> the grid of each operand (uniform on the interval), or a constant
# operand (a float); the grids of tests/test_op_grids_special.py where it
# has the op
SPECIAL_GRIDS = {
    "erf": [(-3, 3)], "erfc": [(-2, 6)], "erfinv": [(-0.95, 0.95)], "erfcinv": [(0.05, 1.95)],
    "erfcx": [(-3, 10)], "gamma": [(0.1, 6)], "gammaln": [(-3.7, 10)], "psi": [(-3.7, 8)],
    "tri_gamma": [(-3.7, 8)], "softplus": [(-40, 40)], "log1mexp": [(-6, -0.01)],
    "logit": [(0.02, 0.98)], "i0": [(-4, 4)], "i1": [(-4, 4)], "j0": [(0.1, 8)],
    "j1": [(0.1, 8)], "ndtr": [(-5, 5)], "ndtri": [(0.01, 0.99)], "ndtri_exp": [(-10, -0.01)],
    "polygamma": [2.0, (0.2, 8)], "gammainc": [(0.5, 5), (0.1, 8)],
    "gammaincc": [(0.5, 5), (0.1, 8)], "gammau": [(0.5, 5), (0.1, 8)],
    "gammal": [(0.5, 5), (0.1, 8)], "betaln": [(0.5, 5), (0.5, 5)],
    "xlogy": [(0, 2), (0.1, 4)], "xlog1py": [(0, 2), (-0.9, 4)], "chi2sf": [(0.1, 10), (1, 6)],
    "betainc": [(0.5, 5), (0.5, 5), (0, 1)],
    "iv": [(-5.5, 10), (0.01, 30)], "ive": [(-5.5, 40), (0.001, 500)],
    "jv": [(-5.5, 20), (0.01, 100)], "yv": [(-5.5, 20), (0.01, 100)],
    "kve": [(-5.5, 40), (0.001, 500)], "kv": [(-5.5, 10), (0.01, 30)],
}
BESSEL_OPS = ("iv", "ive", "jv", "yv", "kve", "kv")
# tests/test_bessel_native.py:21-24
BESSEL_V = np.array([-10.3, -5.0, -2.0, -0.5, 0.0, 0.3, 1.0, 2.7, 5.0, 10.3, 20.0, 40.0])
BESSEL_X = np.array([1e-3, 0.1, 0.5, 1.9, 2.0, 3.0, 10.0, 30.0, 89.9, 90.1, 100.0, 500.0])
# numpy's edges, on the last operand (the others at 1.5)
SPECIAL_EDGES = [np.nan, np.inf, -np.inf, 0.0, -0.0, -1.0, 1.0]
def special_op(name):
    """The port's tensor-level op of a special function."""
    if name in ("xlogy", "xlog1py"):
        return getattr(pt.special, name)
    return getattr(pt, name)


def special_node(name, dtype):
    """The Elemwise node of ``name`` on vector inputs of ``dtype`` (a
    constant operand where SPECIAL_GRIDS gives a float)."""
    ins = []
    for k, g in enumerate(SPECIAL_GRIDS[name]):
        if isinstance(g, float):
            ins.append(constant(np.asarray(int(g) if name == "polygamma" else g)))
        else:
            ins.append(pt.tensor(f"a{k}", dtype=dtype, shape=(None,)))
    return special_op(name)(*ins).owner


def special_inputs(name, dtype, n, seed, edges=True):
    """The values of the node's variable inputs: ``n`` points on the op's
    grid (for a Bessel function, tests/test_bessel_native.py's V x X grid
    first), then numpy's edges."""
    rng = np.random.default_rng(seed)
    grids = [g for g in SPECIAL_GRIDS[name] if not isinstance(g, float)]
    vals = [rng.uniform(*g, size=n) for g in grids]
    if name in BESSEL_OPS:
        V, X = np.meshgrid(BESSEL_V, BESSEL_X, indexing="ij")
        if name in ("iv", "kv"):
            X = np.where(X >= 500, 30.0, X)  # the unscaled functions over- or underflow
        vals = [np.concatenate([V.ravel(), vals[0]]), np.concatenate([X.ravel(), vals[1]])]
    if edges:
        last = len(vals) - 1
        vals = [np.concatenate([v, SPECIAL_EDGES if j == last else [1.5] * len(SPECIAL_EDGES)])
                for j, v in enumerate(vals)]
    return [np.asarray(v, dtype=np_dtype(dtype)) for v in vals]


def scipy_special(name, args):
    """scipy's value of the op on float64 ``args`` (the ops' oracle)."""
    import scipy.special as sps

    a = [np.asarray(x, dtype="float64") for x in args]
    with np.errstate(all="ignore"):
        if name == "polygamma":
            return sps.polygamma(2, a[0])
        if name == "tri_gamma":
            return sps.polygamma(1, a[0])
        if name == "gammau":
            return sps.gammaincc(*a) * sps.gamma(a[0])
        if name == "gammal":
            return sps.gammainc(*a) * sps.gamma(a[0])
        if name == "chi2sf":
            return sps.chdtrc(a[1], a[0])
        if name == "ndtri_exp":
            return sps.ndtri(np.exp(a[0]))
        if name == "softplus":
            return np.logaddexp(0.0, a[0])
        if name == "log1mexp":
            return np.log(-np.expm1(a[0]))
        return getattr(sps, name)(*a)


def special_op_group(dtype):
    """(inputs, outputs, op names): one fused node of ``dtype`` computing
    every special function of the expression table on in-domain operands:
    p in (0, 1), x and y positive (phase 3's sweep)."""
    p, x, y = (pt.tensor(k, dtype=dtype, shape=(None,)) for k in "pxy")
    unary_x = ["erf", "erfc", "erfcx", "gamma", "gammaln", "psi", "tri_gamma", "softplus", "i0",
               "i1", "j0", "j1", "ndtr"]
    unary_p = ["erfinv", "erfcinv", "logit", "ndtri"]
    binary = ["gammainc", "gammaincc", "gammau", "gammal", "betaln", "xlogy", "xlog1py",
              "iv", "ive", "jv", "yv", "kve", "kv"]
    outs = ([special_op(k)(x) for k in unary_x] + [special_op(k)(p) for k in unary_p]
            + [special_op(k)(y, x) for k in binary]
            + [pt.log1mexp(-x), pt.ndtri_exp(-x), pt.chi2sf(x, y), pt.polygamma(2, x),
               pt.betainc(y, x, p)])
    names = unary_x + unary_p + binary + ["log1mexp", "ndtri_exp", "chi2sf", "polygamma",
                                          "betainc"]
    return [p, x, y], outs, names


def special_group_inputs(dtype, n, seed=3):
    rng = np.random.default_rng(seed)
    dtype = np_dtype(dtype)
    return [rng.uniform(0.02, 0.98, n).astype(dtype), rng.uniform(0.1, 8.0, n).astype(dtype),
            rng.uniform(0.5, 5.0, n).astype(dtype)]

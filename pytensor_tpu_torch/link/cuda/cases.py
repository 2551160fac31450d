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
(``special_op_group``).  ``tail_cases()`` gives one graph for each
group of the lowerings of the tensor library's tail (``CumOp`` in each
dtype, ``Repeat``, ``SearchsortedOp``, ``TopKOp`` with ties,
``UnravelIndex`` and ``RavelMultiIndex``, the real FFTs, the
convolutions, ``pad`` in every mode, ``interp``) with its inputs, which a
card holds against the same graph linked for the CPU (``TAIL_RTOL``).
For jax's loop samplers (``tensor/random/samplers.py``), ``loop_grid``
gives each sampler's parameters tiled over a draw's shape, spanning each
branch of its loops (``LOOP_LAM``, ``LOOP_NP``, ``LOOP_GAMMA_ALPHA``,
``LOOP_DIRICHLET_ALPHA``), and ``loop_typical`` a grid inside their
domains.  ``chip_smoke.py``, the card tests (``tests/test_torch_cuda.py``)
and the CPU tests against the JAX package use them alike.
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
    "betainc_dda": [(0.5, 5), (0.5, 5), (0, 1)], "betainc_ddb": [(0.5, 5), (0.5, 5), (0, 1)],
    "gammainc_ddk": [(0.5, 5), (0.1, 8)], "gammaincc_ddk": [(0.5, 5), (0.1, 8)],
    "hyp2f1_dda": [(0.5, 2), (0.5, 2), (1, 3), (-0.8, 0.8)],
    "hyp2f1_ddb": [(0.5, 2), (0.5, 2), (1, 3), (-0.8, 0.8)],
    "hyp2f1_ddc": [(0.5, 2), (0.5, 2), (1, 3), (-0.8, 0.8)],
}
# the shape-parameter gradients, whose oracle is the op's own: central
# differences of scipy's function
GRAD_OPS = ("betainc_dda", "betainc_ddb", "gammainc_ddk", "gammaincc_ddk", "hyp2f1_dda",
            "hyp2f1_ddb", "hyp2f1_ddc")
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
        if name in GRAD_OPS:
            from pytensor_tpu_torch.scalar import math as psm

            return getattr(psm, name).np_fn(*a)
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


# the tail's lowerings on a card against the CPU, over max|cpu| (exact for
# integer and bool results): float32 cumulative sums and products and FFTs
# add and multiply in other orders there (cuFFT, torch's scans); float64
# within that of the same arithmetic
TAIL_RTOL = {"float32": 1e-5, "float64": 1e-10}
PAD_MODES = ("constant", "edge", "reflect", "symmetric", "wrap", "maximum", "minimum", "mean",
             "linear_ramp")


def tail_cases(n=2 ** 18):
    """``[(tag, inputs, outputs, values)]``: one graph a group of the tail's
    lowerings, each at most ``n`` elements an input (chip_smoke's phase 16
    at ``2**18``; the card tests smaller), with inputs from a seed.
    ``CumOp`` in bool, int32, float32 and float64 (axis 1, flat, the
    product along axis 1, close to 1 so it stays finite); ``Repeat`` with
    constant counts (a vector and a scalar); ``SearchsortedOp`` both sides
    and with a sorter; ``TopKOp`` on values with ties, sorted and not;
    ``UnravelIndex`` and ``RavelMultiIndex`` in C and F order and each
    mode; ``RFFTOp`` and ``IRFFTOp`` in float32 and float64 with each norm
    and an odd length; ``Convolve1d`` in each mode with an odd and an even
    kernel, batched, and ``Convolve2d`` in each mode; ``pad`` in every
    mode; ``interp``."""
    from pytensor_tpu_torch.tensor.fft import IRFFTOp

    rng = np.random.default_rng(16)
    cols = 256
    rows = max(n // cols, 2)
    out = []
    for dtype in ("bool", "int32", "float32", "float64"):
        x = pt.tensor("x", dtype=dtype, shape=(rows, cols))
        if dtype == "bool":
            v = rng.random((rows, cols)) < 0.02
        elif dtype == "int32":
            v = rng.integers(-3, 4, (rows, cols))
        else:
            v = rng.uniform(0.995, 1.005, (rows, cols))
        outs = [pt.cumsum(x, axis=1), pt.cumsum(x), pt.cumprod(x, axis=1)]
        out.append((f"cumop {dtype}", [x], outs, [v.astype(dtype)]))
    x = pt.tensor("x", dtype="float32", shape=(rows, cols))
    counts = rng.integers(0, 4, cols)
    out.append(("repeat", [x], [pt.repeat(x, counts, axis=1), pt.repeat(x[:8], 3, axis=0)],
                [rng.standard_normal((rows, cols)).astype("float32")]))
    a = pt.tensor("a", dtype="float32", shape=(4096,))
    q = pt.tensor("q", dtype="float32", shape=(n,))
    srt = pt.tensor("s", dtype="int64", shape=(4096,))
    av = np.sort(rng.integers(0, 2048, 4096)).astype("float32")
    qv = rng.integers(-8, 2056, n).astype("float32")
    perm = rng.permutation(4096)
    out.append(("searchsorted", [a, q, srt],
                [pt.searchsorted(a, q), pt.searchsorted(a, q, side="right"),
                 pt.searchsorted(a[perm], q, sorter=srt)],
                [av, qv, np.argsort(av[perm], kind="stable")]))
    x = pt.tensor("x", dtype="float32", shape=(rows, cols))
    ties = rng.integers(0, 16, (rows, cols)).astype("float32")
    out.append(("topk ties", [x], [*pt.topk(x, 16), *pt.topk(x, 5, sorted=False)], [ties]))
    dims = (64, 32, 128)
    i = pt.tensor("i", dtype="int64", shape=(n,))
    iv = rng.integers(0, int(np.prod(dims)), n)
    cs = pt.unravel_index(i, dims)
    fs = pt.unravel_index(i, dims, order="F")
    wild = [c * 3 - 7 for c in cs]
    out.append(("unravel ravel", [i],
                [*cs, *fs, pt.ravel_multi_index(cs, dims), pt.ravel_multi_index(fs, dims, order="F"),
                 pt.ravel_multi_index(wild, dims, mode="wrap"),
                 pt.ravel_multi_index(wild, dims, mode="clip")], [iv]))
    for dtype in ("float32", "float64"):
        x = pt.tensor("x", dtype=dtype, shape=(n // 4096, 4096))
        y = pt.tensor("y", dtype=dtype, shape=(n // 4095, 4095))
        outs = []
        for norm in (None, "ortho", "forward"):
            spec = pt.fft.rfft(x, norm=norm)
            outs += [spec, pt.fft.irfft(spec, norm=norm)]
        outs.append(IRFFTOp(n=4095)(pt.fft.rfft(y)))
        out.append((f"fft {dtype}", [x, y], outs,
                    [rng.standard_normal((n // 4096, 4096)).astype(dtype),
                     rng.standard_normal((n // 4095, 4095)).astype(dtype)]))
    sig = pt.tensor("sig", dtype="float32", shape=(n,))
    k_odd = pt.tensor("k_odd", dtype="float32", shape=(33,))
    k_even = pt.tensor("k_even", dtype="float32", shape=(32,))
    batch = pt.tensor("batch", dtype="float32", shape=(16, n // 16))
    outs = [pt.signal.convolve1d(sig, k, mode=m) for m in ("full", "valid", "same")
            for k in (k_odd, k_even)]
    outs.append(pt.signal.convolve1d(batch, k_odd))
    out.append(("convolve1d", [sig, k_odd, k_even, batch], outs,
                [rng.standard_normal(s).astype("float32") for s in ((n,), (33,), (32,),
                                                                    (16, n // 16))]))
    side = int(np.sqrt(n))
    img = pt.tensor("img", dtype="float32", shape=(side, side))
    ker = pt.tensor("ker", dtype="float32", shape=(7, 6))
    out.append(("convolve2d", [img, ker],
                [pt.signal.convolve2d(img, ker, mode=m) for m in ("full", "valid", "same")],
                [rng.standard_normal((side, side)).astype("float32"),
                 rng.standard_normal((7, 6)).astype("float32")]))
    x = pt.tensor("x", dtype="float32", shape=(rows, cols))
    out.append(("pad", [x], [pt.pad(x, ((3, 2), (1, 4)), mode=m) for m in PAD_MODES],
                [rng.standard_normal((rows, cols)).astype("float32")]))
    q = pt.tensor("q", dtype="float64", shape=(n,))
    xp = np.sort(rng.uniform(-5, 5, 1024))
    out.append(("interp", [q], [pt.interp(q, pt.constant(xp), pt.constant(np.sin(xp)))],
                [rng.uniform(-6, 6, n)]))
    return out


def tail_held(got, want, dtype):
    """The largest error of a card result against the CPU's, over
    max|cpu| (an element count of the differences for integer and bool
    results); raises when the shapes, dtypes or NaNs differ."""
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{got.shape} {got.dtype} against {want.shape} {want.dtype}")
    if got.dtype.kind in "biu":
        return float(np.sum(got != want))
    if not np.array_equal(np.isnan(got), np.isnan(want)):
        raise AssertionError("NaN at other places")
    ok = ~np.isnan(want)
    return float(np.max(np.abs(got[ok] - want[ok]), initial=0.0)) / max(
        float(np.max(np.abs(want[ok]), initial=0.0)), np.finfo(dtype).tiny)



# --- complex64 and complex128 (K1's complex ops) ---------------------------------

# every op K1 emits with a complex operand or result (``cexpr.CCEXPR``)
COMPLEX_OPS = ("real", "imag", "conj", "angle", "complex", "abs", "neg", "add", "sub", "mul",
               "true_div", "sqr", "exp", "log", "sqrt", "eq", "neq", "identity")
# the complex ops whose value is exact (each part rounded once, or none),
# held bit for bit against the plain version; the others within
# COMPLEX_ULPS units of the dtype's epsilon of max(|plain|, the least
# normal), in the complex modulus of the difference
COMPLEX_EXACT = {"real", "imag", "conj", "complex", "neg", "add", "sub", "eq", "neq",
                 "identity"}
COMPLEX_ULPS = 8
_EPS = {"complex64": float(np.finfo(np.float32).eps), "complex128": float(np.finfo(np.float64).eps)}
_TINY = {"complex64": float(np.finfo(np.float32).tiny),
         "complex128": float(np.finfo(np.float64).tiny)}


N_COMPLEX_EDGES = 17


def complex_values(dtype, n, seed):
    """n complex values of ``dtype``: signed zeros, units, the axes, parts
    of very different sizes and points near the unit circle in front, then
    normal parts of scale 3."""
    rng = np.random.default_rng(seed)
    edge = [0j, complex(-0.0, 0.0), complex(0.0, -0.0), complex(-0.0, -0.0), 1 + 0j, -1 + 0j,
            1j, -1j, 3 - 4j, -3 + 4j, 1e-3 + 1e3j, -1e3 + 1e-3j, 1 + 1e-7j,
            complex(np.cos(0.3), np.sin(0.3)), 0.5 - 0.5j, -2.5 + 0.0j, complex(-2.5, -0.0)]
    assert len(edge) == N_COMPLEX_EDGES
    body = rng.standard_normal(n - len(edge)) * 3 + 1j * rng.standard_normal(n - len(edge)) * 3
    return np.concatenate([np.asarray(edge), body]).astype(dtype)


def complex_node(name, dtype):
    """One Elemwise node of complex op ``name`` in ``dtype``: over complex
    operands, or for ``complex`` over the two real parts."""
    from pytensor_tpu_torch.scalar.basic import real_dtype

    if name == "complex":
        re, im = (pt.tensor(k, dtype=real_dtype(dtype), shape=(None,)) for k in ("re", "im"))
        return pt.complex(re, im).owner
    op = {"sqr": ps.sqr, "identity": ps.identity, "complex": ps.complex_op}.get(name)
    op = op or getattr(ps, name)
    nin = 2 if op.nin < 0 else op.nin
    args = [pt.tensor(f"z{k}", dtype=dtype, shape=(None,)) for k in range(nin)]
    return Elemwise(op)(*args).owner


def complex_inputs(name, dtype, n, seed):
    """The inputs of ``complex_node(name, dtype)``: complex values with the
    edges of ``complex_values``, one operand rolled against the other."""
    from pytensor_tpu_torch.scalar.basic import real_dtype

    z = complex_values(dtype, n, seed)
    if name == "complex":
        return [z.real.astype(real_dtype(dtype)), np.roll(z.imag, 3).astype(real_dtype(dtype))]
    node = complex_node(name, dtype)
    return [z if k == 0 else np.roll(complex_values(dtype, n, seed + k), 5)
            for k in range(len(node.inputs))]


def complex_held(got, want, name, dtype):
    """``got`` against the plain version's ``want`` (numpy arrays): exact
    ops bit for bit, the others within COMPLEX_ULPS epsilons; NaN, and
    the infinities, where ``want`` has them."""
    if got.dtype == bool or name in COMPLEX_EXACT:
        return np.array_equal(got.view(np.uint8), want.view(np.uint8))
    gp = np.stack([got.real, got.imag]) if np.iscomplexobj(got) else got[None]
    wp = np.stack([want.real, want.imag]) if np.iscomplexobj(want) else want[None]
    if not np.array_equal(np.isnan(gp), np.isnan(wp)):
        return False
    inf = np.isinf(wp)
    if not np.array_equal(gp[inf], wp[inf]):
        return False
    fin = np.isfinite(wp).all(axis=0)
    err = np.abs(gp[:, fin] - wp[:, fin]).max(axis=0, initial=0)
    scale = np.maximum(np.abs(want[fin]).astype(np.float64), _TINY[dtype])
    return bool((err <= COMPLEX_ULPS * _EPS[dtype] * scale).all())


def numpy_complex_op(name, args):
    """numpy's value of complex op ``name`` on ``args``, in complex128 (or
    float64, or bool): the reference a K1 result is held to."""
    wide = [a.astype("complex128" if np.iscomplexobj(a) else "float64") for a in args]
    if name == "complex":
        return wide[0] + 1j * wide[1]
    fn = {"true_div": np.true_divide, "sqr": np.square, "neg": np.negative, "sub": np.subtract,
          "mul": np.multiply, "add": np.add, "eq": np.equal, "neq": np.not_equal,
          "identity": np.positive}.get(name) or getattr(np, name)
    with np.errstate(all="ignore"):
        return fn(*wide)


def complex_near(got, ref, dtype):
    """``got`` (of ``dtype``'s precision) within COMPLEX_ULPS epsilons of
    ``dtype`` of numpy's wider ``ref``, over max(|ref|, the least normal),
    on the values where ``ref`` is finite; bools equal."""
    if ref.dtype == bool:
        return np.array_equal(got, ref)
    ok = np.isfinite(ref)
    err = np.abs(got[ok].astype(ref.dtype) - ref[ok])
    scale = np.maximum(np.abs(ref[ok]), _TINY[dtype])
    return bool((err <= COMPLEX_ULPS * _EPS[dtype] * scale).all())


def periodogram_graph(dtype="float32"):
    """The periodogram's graph: the real FFT of each row of ``x``, its
    packed pairs as a complex spectrum, the power ``abs(c)**2`` and the
    phase ``angle(c)``.  The fusion pass, the JAX package's greedy one,
    cuts at ``c``, which has two readers: ``complex`` and ``angle`` stay
    single nodes, and ``abs`` and ``sqr`` are one FusedElemwise."""
    x = pt.tensor("x", dtype=dtype, shape=(None, None))
    packed = pt.fft.rfft(x)
    c = pt.complex(packed[..., 0], packed[..., 1])
    return [x], [pt.abs(c) ** 2, pt.angle(c)]


def periodogram_chain(dtype="float32"):
    """The periodogram's chain after its slices as one graph of its two
    parts, ``(re, im) -> (sqr(abs(c)), angle(c))`` with ``c`` their complex:
    the one K1 kernel that would keep ``c`` in registers, where the fusion
    pass writes it (``periodogram_graph``)."""
    re = pt.tensor("re", dtype=dtype, shape=(None, None))
    im = pt.tensor("im", dtype=dtype, shape=(None, None))
    c = pt.complex(re, im)
    return [re, im], [pt.sqr(pt.abs(c)), pt.angle(c)]


# --- jax's loop samplers ------------------------------------------------------------

# the twelve RVs whose jax sampler is a loop, by the kernel under them
LOOP_SAMPLERS = {"gamma": "gamma", "beta": "gamma", "dirichlet": "gamma",
                 "chisquare": "gamma", "invgamma": "gamma", "gengamma": "gamma", "t": "gamma",
                 "poisson": "poisson", "negative_binomial": "poisson", "binomial": "binomial",
                 "betabinom": "binomial", "multinomial": "binomial"}
# Knuth (lam < 10, NaN), PTRS, and 0
LOOP_LAM = [0, 1e-3, 3, 9.999, 10, 50, 1e4, np.nan]
# inversion (count q <= 10, a NaN or negative count), BTRS, and jax's
# edges; jax's loop never ends for an infinite count with p 0 or 1
LOOP_NP = [(n, p) for n in (0, 1, 10, 100, 1e4, -3, np.inf)
           for p in (0, 1e-3, 0.3, 0.5, 0.7, 1, np.nan) if not (n == np.inf and p in (0, 1))]
# the boost below 1, Marsaglia and Tsang's loops, and the edges
LOOP_GAMMA_ALPHA = [1e-3, 0.5, 1, 2.5, 100, 0, np.nan]
LOOP_DIRICHLET_ALPHA = [1e-2, 0.5, 3, 10]


def _tile(vals, shape):
    return np.resize(np.asarray(vals, dtype="float64"), shape)


def _rows(vals, shape):
    return np.broadcast_to(np.asarray(vals, dtype="float64"), tuple(shape) + (len(vals),)).copy()


_LOOP_GRIDS = {
    "poisson": lambda s: [_tile(LOOP_LAM, s)],
    "binomial": lambda s: [_tile([n for n, _ in LOOP_NP], s), _tile([p for _, p in LOOP_NP], s)],
    "negative_binomial": lambda s: [_tile([1, 5, 20, 0.5, 100], s),
                                    _tile([0.1, 0.4, 0.9, 0.999], s)],
    "betabinom": lambda s: [_tile([0, 1, 10, 100, 1e4], s), _tile([0.5, 2, 10], s),
                            _tile([3, 0.7], s)],
    "multinomial": lambda s: [_tile([0, 10, 100, 1e4], s), _rows([0.5, 0.25, 0.2, 0.05], s)],
    "gamma": lambda s: [_tile(LOOP_GAMMA_ALPHA, s), _tile([1.5], s)],
    "beta": lambda s: [_tile([1e-3, 0.5, 1, 2.5, 100], s), _tile([0.7, 3, 1e-2, 10], s)],
    "dirichlet": lambda s: [_rows(LOOP_DIRICHLET_ALPHA, s)],
    "chisquare": lambda s: [_tile([0.5, 1, 3, 50, 0, np.nan], s)],
    "invgamma": lambda s: [_tile([1e-3, 0.5, 2.5, 100, np.nan], s), _tile([2.0], s)],
    "gengamma": lambda s: [_tile([0.5, 2.5, 100], s), _tile([0.5, 1, 3, 2], s), _tile([2.0], s)],
    "t": lambda s: [_tile([0.5, 1, 4, 100, np.nan], s), _tile([1.0], s), _tile([2.0], s)],
}


def loop_grid(name, shape):
    """``name``'s parameters (float64 arrays, in its RV's order; gamma's
    second is the scale) over a draw of batch shape ``shape``: the edge
    grid, tiled."""
    return _LOOP_GRIDS[name](tuple(shape))


# inside each kernel's domain (for timing beside torch's samplers)
LOOP_TYPICAL = {"gamma": [0.5, 1, 2.5, 100], "poisson": [1e-3, 3, 9.999, 10, 50, 1e4],
                "binomial": [(n, p) for n in (0, 1, 10, 100, 1e4) for p in (1e-3, 0.3, 0.5, 0.7)]}

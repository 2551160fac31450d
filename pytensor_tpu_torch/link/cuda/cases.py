"""The cases that hold K1 and K2 on the ops of the expression table and
K2's new ops against their plain versions.

``scalar_op_group(dtype)`` is one fused node a dtype computing every op
of ``cexpr.py``'s table that takes that dtype, ``op_group_inputs`` its
inputs with numpy's edges (NaN, +-inf, +-0.0, halves, integer extremes,
shift counts past the width), and ``k2_new_op_scans()`` the scans of
``Dot22``, ``Gemm``, ``Dot22Scalar``, ``Join``, ``Split``, ``ARange``,
``DeepCopyOp`` and ``ViewOp`` that K2 runs against its step loop.
``chip_smoke.py`` and the card tests (``tests/test_torch_cuda.py``) use
them alike.
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
    if dtype.startswith("float"):
        edge = [np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, -0.5, 1.5, -2.5, 2.5, 0.49999997,
                -0.49999997, 1.0, -1.0, 7.0, -7.0]
        return np.concatenate([edge, rng.standard_normal(n - len(edge)) * 4]).astype(dtype)
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

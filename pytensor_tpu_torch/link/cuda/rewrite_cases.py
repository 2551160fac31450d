"""The probe graphs of the graph-and-rewrite layer: one or more graphs for
each ``local_*`` rewrite of ``tensor/rewriting/{basic,subtensor,math}.py``
that the port took in ROADMAP Queue 1 item 6, and for the ShapeFeature.

Each case is ``Case(rewrite, family, label, build, inputs, reference,
kind, exclude, without)``: ``build(pt, side, *xs)`` builds the graph from
a package's tensor namespace (the port's or the JAX package's) and
symbolic inputs;
``inputs(side, dtype)`` gives numpy values (matrices ``side`` x ``side``,
vectors of ``side * side`` elements, a few small operands), whose dtype
and ndim make the symbolic inputs, all of unknown shape; ``reference(*vals)``
is the graph's value in float64 numpy; ``kind`` is ``"elemwise"``,
``"product"`` (a product or a reduction the rewrite moves) or
``"shape"`` (a ShapeFeature graph); ``exclude`` names the rewrites the
case's mode leaves out, so that the rewrite, and not an earlier one, takes
the graph (``constant_folding``, ``local_reduce_of_makevector`` and
``local_logical_self`` take three of them first); ``without`` the
registered names whose exclusion makes the comparison graph (the
rewrite's own, and for the Alloc graph also ``local_useless_alloc``,
which removes the Alloc there with or without the feature).  On each
graph the rewrite fires in the JAX package's ``FAST_RUN``.  ``chip_smoke.py`` phase 23 runs them on
the card at ``side`` 4,096 in float32 (2**24 elements, the MFU width);
the CPU tests build them in both packages at a small side in float64.
``REGISTERED`` maps a rewrite to the name it is registered under where
the two differ; ``TIMED`` names the rewrites
whose graph phase 23 times with the rewrite and without it.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import functools
import math

import numpy as np


class Case(NamedTuple):
    rewrite: str
    family: str
    label: str
    build: Callable
    inputs: Callable
    reference: Callable
    kind: str = "elemwise"
    exclude: tuple = ()
    without: tuple = ()


FAMILIES = ("shape", "basic", "subtensor", "math")

# the rewrites registered under another name than their function's
REGISTERED = {"local_subtensor_of_unbroadcast_cast": "local_subtensor_of_cast",
              "local_sqr_of_sqrt_even_pow": "local_sqr_of_abs",
              "shape_feature": "ShapeOpt"}

# timed with and without the rewrite on the card: the ShapeFeature's
# Alloc and Reshape, and the four that move a product or a reduction
TIMED = ("shape_feature", "local_subtensor_of_dot", "local_advanced_subtensor1_of_dot",
         "local_extract_diag_of_dot", "local_subtensor_of_reduce")

SEED = 23


def _rng(k=0):
    return np.random.default_rng(SEED + k)


@functools.lru_cache(maxsize=16)
def _uniform(n, dtype, k, lo, hi):
    v = _rng(k).uniform(lo, hi, n).astype(dtype)
    v.flags.writeable = False  # shared by the cases that draw the same values
    return v


def vec(side, dtype, k=0, lo=0.01, hi=20.0):
    """``side * side`` values drawn from [lo, hi] (read-only, drawn once)."""
    return _uniform(side * side, dtype, k, lo, hi)


@functools.lru_cache(maxsize=4)
def edged(side, dtype, k=0):
    """``vec`` with -0.0 and -inf at its end, as the math probe's values
    (read-only, made once)."""
    v = vec(side, dtype, k).copy()
    v[-2:] = [-0.0, -np.inf]
    v.flags.writeable = False
    return v


@functools.lru_cache(maxsize=16)
def mat(side, dtype, k=0, lo=-1.0, hi=1.0):
    """A ``side`` x ``side`` matrix of values drawn from [lo, hi] (read-only,
    drawn once)."""
    return _uniform(side * side, dtype, k, lo, hi).reshape(side, side)


def scal(v, dtype):
    return np.asarray(v, dtype=dtype)


def _ld(f):
    """A float64 numpy reference with numpy's warnings off."""
    def ref(*xs):
        with np.errstate(all="ignore"):
            return f(*[np.asarray(x, dtype="float64") if np.asarray(x).dtype.kind == "f"
                       else np.asarray(x) for x in xs])
    return ref


def _set(x, idx, v):
    x = np.array(x, dtype="float64")
    x[idx] = v
    return x


def _inc(x, idx, v):
    x = np.array(x, dtype="float64")
    np.add.at(x, idx, v)
    return x


IDX = np.array([5, 1, 3, 0], dtype="int64")  # duplicate-free constant rows
READ = np.array([3, 0, 5], dtype="int64")  # rows of IDX's write, read back


def _dot_to_mul_ref(a, b):
    n = 64 * math.isqrt(a.size)
    return a[:n].reshape(-1, 8, 1) * b[:n].reshape(-1, 1, 8)


def _cast32(t, x):
    """``x`` through an Elemwise cast to float32, built even where the
    input is float32 already (``t.cast`` returns such an input itself)."""
    return t.cast(t.ones((), dtype="float64"), "float32").owner.op(x)


def _cases():
    c = []

    def add(rewrite, family, label, build, inputs, reference, kind="elemwise", exclude=(),
            without=()):
        c.append(Case(rewrite, family, label, build, inputs, _ld(reference), kind, exclude,
                      without or (REGISTERED.get(rewrite, rewrite),)))

    # --- the ShapeFeature ------------------------------------------------------
    add("shape_feature", "shape", "alloc(x + y, *x.shape)",
        lambda t, s, x, y: t.alloc(x + y, *x.shape),
        lambda s, d: [mat(s, d), mat(s, d, 1)], lambda x, y: x + y, "shape",
        without=("ShapeOpt", "local_useless_alloc"))
    add("shape_feature", "shape", "reshape(exp(x), exp(x).shape)",
        lambda t, s, x: t.reshape(t.exp(x), t.exp(x).shape),
        lambda s, d: [mat(s, d)], np.exp, "shape")
    # --- basic.py ----------------------------------------------------------------
    add("local_useless_specify_shape", "basic", "specify_shape(specify_shape(x, (n,)), (n,)) * 2",
        lambda t, s, x: t.specify_shape(t.specify_shape(x, x.shape[0]), x.shape[0]) * 2.0,
        lambda s, d: [vec(s, d)], lambda x: x * 2)
    add("local_useless_unbroadcast", "basic", "unbroadcast(x, 0) * 2",
        lambda t, s, x: t.unbroadcast(t.specify_shape(x, (None, None)), 0) * 2.0,
        lambda s, d: [mat(s, d)], lambda x: x * 2)
    add("local_remove_copies", "basic", "x.copy() * 2",
        lambda t, s, x: x.copy() * 2.0,
        lambda s, d: [vec(s, d)], lambda x: x * 2)
    add("local_useless_cast", "basic", "cast(cast(x, f32), f32) * 2",
        lambda t, s, x: _cast32(t, _cast32(t, x)) * np.float32(2),
        lambda s, d: [vec(s, d)], lambda x: x.astype("float32").astype("float64") * 2)
    add("local_join_1", "basic", "Join()(0, x) * 2",
        lambda t, s, x: t.join(0, x, x).owner.op(0, x) * 2.0,
        lambda s, d: [vec(s, d)], lambda x: x * 2)
    add("local_useless_alloc", "basic", "alloc(x * 2, x.shape[0])",
        lambda t, s, x: t.alloc(x * 2.0, x.shape[0]),
        lambda s, d: [vec(s, d)], lambda x: x * 2)
    add("local_alloc_of_alloc", "basic", "alloc(alloc(c, n), n, n) * x",
        lambda t, s, c, x: t.alloc(t.alloc(c, x.shape[1]), x.shape[0], x.shape[1]) * x,
        lambda s, d: [scal(1.5, d), mat(s, d)], lambda c, x: c * x)
    add("local_unary_of_alloc_lift", "basic", "exp(alloc(c, n, n)) * x",
        lambda t, s, c, x: t.exp(t.alloc(c, x.shape[0], x.shape[1])) * x,
        lambda s, d: [scal(0.5, d), mat(s, d)], lambda c, x: np.exp(c) * x)
    add("local_join_empty", "basic", "join(0, x, zeros(0)) * 2",
        lambda t, s, x: t.join(0, x, t.zeros((0,), dtype=x.dtype)) * 2.0,
        lambda s, d: [vec(s, d)], lambda x: x * 2)
    add("local_join_of_join", "basic", "join(0, join(0, x, y), x) * 2",
        lambda t, s, x, y: t.join(0, t.join(0, x, y), x) * 2.0,
        lambda s, d: [vec(s, d), vec(s, d, 1)], lambda x, y: np.concatenate([x, y, x]) * 2)
    add("local_useless_split", "basic", "split(x, [n], 1)[0] * 2",
        lambda t, s, x: t.split(x, t.stack([x.shape[0]]), 1)[0] * 2.0,
        lambda s, d: [vec(s, d)], lambda x: x * 2)
    add("local_specify_shape_merge", "basic",
        "specify_shape(specify_shape(X, (side, None)), (None, side)) * 2",
        lambda t, s, x: t.specify_shape(t.specify_shape(x, (s, None)), (None, s)) * 2.0,
        lambda s, d: [mat(s, d)], lambda x: x * 2)
    # --- subtensor.py -------------------------------------------------------------
    add("local_subtensor_of_dot", "subtensor", "dot(A, B)[:4]",
        lambda t, s, a, b: t.dot(a, b)[:4],
        lambda s, d: [mat(s, d), mat(s, d, 1)], lambda a, b: a[:4] @ b, "product")
    add("local_subtensor_of_dimshuffle", "subtensor", "X.T[1:5] * 2",
        lambda t, s, x: x.T[1:5] * 2.0,
        lambda s, d: [mat(s, d)], lambda x: x.T[1:5] * 2)
    add("local_subtensor_of_alloc", "subtensor", "alloc(c, n, n)[1:5] * x[1:5]",
        lambda t, s, c, x: t.alloc(c, x.shape[0], x.shape[1])[1:5] * x[1:5],
        lambda s, d: [scal(1.5, d), mat(s, d)], lambda c, x: c * x[1:5])
    add("local_subtensor_of_makevector", "subtensor", "stack([a, b, c])[1:] * x",
        lambda t, s, a, b, cc, x: t.sum(t.stack([a, b, cc])[1:]) * x,
        lambda s, d: [scal(1.5, d), scal(2.0, d), scal(-0.5, d), vec(s, d)],
        lambda a, b, cc, x: (b + cc) * x)
    add("local_useless_inc_subtensor", "subtensor", "inc_subtensor(x[::-1], y)",
        lambda t, s, x, y: t.inc_subtensor(x[::-1], y),
        lambda s, d: [vec(s, d), vec(s, d, 1)], lambda x, y: x + y[::-1])
    add("local_subtensor_of_unbroadcast_cast", "subtensor", "x.astype(int64)[1:5] * 2",
        lambda t, s, x: t.cast(x, "int64")[1:5] * 2,
        lambda s, d: [mat(s, d, lo=0.01, hi=20.0)], lambda x: x.astype("int64")[1:5] * 2)
    add("local_subtensor_of_reduce", "subtensor", "sum(X, 1)[1:5]",
        lambda t, s, x: t.sum(x, axis=1)[1:5],
        lambda s, d: [mat(s, d)], lambda x: x.sum(axis=1)[1:5], "product")
    add("local_advanced_subtensor1_of_dot", "subtensor", "dot(A, B)[rows]",
        lambda t, s, a, b: t.dot(a, b)[IDX],
        lambda s, d: [mat(s, d), mat(s, d, 1)], lambda a, b: a[IDX] @ b, "product")
    add("local_subtensor_of_join", "subtensor", "join(1, a, b)[1:5]",
        lambda t, s, a, b: t.join(1, a, b)[1:5],
        lambda s, d: [mat(s, d), mat(s, d, 1)], lambda a, b: np.concatenate([a, b], 1)[1:5])
    add("local_subtensor_of_specify_shape", "subtensor", "specify_shape(X, (side, side))[2] * 2",
        lambda t, s, x: t.specify_shape(x, (s, s))[2] * 2.0,
        lambda s, d: [mat(s, d)], lambda x: x[2] * 2)
    add("local_extract_diag_of_eye", "subtensor", "diagonal(eye(side)) * X",
        lambda t, s, x: t.diagonal(t.eye(s)) * x,
        lambda s, d: [mat(s, d)], lambda x: x, exclude=("constant_folding",))
    add("local_set_to_inc_subtensor", "subtensor", "set_subtensor(x[2:9], x[2:9] + y)",
        lambda t, s, x, y: t.set_subtensor(x[2:9], x[2:9] + y[2:9]),
        lambda s, d: [vec(s, d), vec(s, d, 1)],
        lambda x, y: _set(x, slice(2, 9), x[2:9] + y[2:9]))
    add("local_incsubtensor_of_zeros", "subtensor", "inc_subtensor(x[2:9], zeros) * 2",
        lambda t, s, x: t.inc_subtensor(x[2:9], t.zeros((7,), dtype=x.dtype)) * 2.0,
        lambda s, d: [vec(s, d)], lambda x: x * 2)
    add("local_incsubtensor_of_zeros_to_setsubtensor", "subtensor",
        "inc_subtensor(zeros(x.shape)[2:9], y[:7]) * x",
        lambda t, s, x, y: t.inc_subtensor(t.zeros(x.shape, dtype=x.dtype)[2:9], y[:7]) * x,
        lambda s, d: [vec(s, d), vec(s, d, 1)],
        lambda x, y: _set(np.zeros_like(x), slice(2, 9), y[:7]) * x)
    add("local_add_of_sparse_write", "subtensor", "x + inc_subtensor(zeros(x.shape)[rows], v)",
        lambda t, s, x, v: x + t.inc_subtensor(t.zeros(x.shape, dtype=x.dtype)[IDX], v[:4]),
        lambda s, d: [vec(s, d), vec(s, d, 1)], lambda x, v: _inc(x, IDX, v[:4]))
    add("local_setsubtensor_of_constants", "subtensor",
        "set_subtensor(fill(x, 2)[2:9], 2) * x",
        lambda t, s, x: t.set_subtensor(t.fill(x, 2.0)[2:9], 2.0) * x,
        lambda s, d: [vec(s, d)], lambda x: 2 * x)
    add("local_read_of_write_same_indices", "subtensor", "set_subtensor(x[2:9], y[:7])[2:9] * 2",
        lambda t, s, x, y: t.set_subtensor(x[2:9], y[:7])[2:9] * 2.0,
        lambda s, d: [vec(s, d), vec(s, d, 1)], lambda x, y: y[:7] * 2)
    add("local_write_of_write_same_indices", "subtensor",
        "set_subtensor(set_subtensor(x[2:9], y[:7])[2:9], y[1:8])",
        lambda t, s, x, y: t.set_subtensor(t.set_subtensor(x[2:9], y[:7])[2:9], y[1:8]),
        lambda s, d: [vec(s, d), vec(s, d, 1)], lambda x, y: _set(x, slice(2, 9), y[1:8]))
    add("local_adv_idx_to_diagonal", "subtensor", "X[arange(side), arange(side)] * 2",
        lambda t, s, x: t.specify_shape(x, (s, s))[np.arange(s), np.arange(s)] * 2.0,
        lambda s, d: [mat(s, d)], lambda x: np.diagonal(x) * 2)
    add("local_join_subtensors", "subtensor", "join(0, x[0:3], x[3:7]) * 2",
        lambda t, s, x: t.join(0, x[0:3], x[3:7]) * 2.0,
        lambda s, d: [vec(s, d)], lambda x: x[0:7] * 2)
    add("local_extract_diag_of_dot", "subtensor", "diagonal(dot(A, B))",
        lambda t, s, a, b: t.diagonal(t.dot(t.specify_shape(a, (s, s)), t.specify_shape(b, (s, s)))),
        lambda s, d: [mat(s, d), mat(s, d, 1)], lambda a, b: np.einsum("ij,ji->i", a, b),
        "product")
    add("local_advanced_read_of_write_constant_indices", "subtensor",
        "set_subtensor(x[rows], v)[[3, 0, 5]] * 2",
        lambda t, s, x, v: t.set_subtensor(x[IDX], v[:4])[READ] * 2.0,
        lambda s, d: [vec(s, d), vec(s, d, 1)], lambda x, v: v[[2, 3, 0]] * 2)
    add("local_useless_inc_subtensor_alloc", "subtensor", "inc_subtensor(x[2:9], alloc(c, 7))",
        lambda t, s, x, c: t.inc_subtensor(t.specify_shape(x, (s * s,))[2:9], t.alloc(c, 7)),
        lambda s, d: [vec(s, d), scal(1.5, d)], lambda x, c: _inc(x, slice(2, 9), c))
    add("local_subtensor_of_batch_dims", "subtensor", "matmul(A3, B3)[:2]",
        lambda t, s, a, b: t.matmul(t.reshape(a, (s * s // 16, 4, 4)),
                                    t.reshape(b, (s * s // 16, 4, 4)))[:2],
        lambda s, d: [vec(s, d), vec(s, d, 1)],
        lambda a, b: np.matmul(a.reshape(-1, 4, 4)[:2], b.reshape(-1, 4, 4)[:2]))
    # --- math.py -----------------------------------------------------------------
    add("local_neg_neg", "math", "-(-x)", lambda t, s, x: t.neg(t.neg(x)),
        lambda s, d: [edged(s, d)], lambda x: x)
    add("local_sqr_of_sqrt_even_pow", "math", "sqr(abs(x))", lambda t, s, x: t.sqr(t.abs(x)),
        lambda s, d: [edged(s, d)], lambda x: x * x)
    add("local_extremum_self", "math", "maximum(x, x)", lambda t, s, x: t.maximum(x, x),
        lambda s, d: [edged(s, d)], lambda x: x)
    add("local_extremum_inf", "math", "maximum(x, -inf)", lambda t, s, x: t.maximum(x, -np.inf),
        lambda s, d: [edged(s, d)], lambda x: x)
    add("local_logical_self", "math", "and(b, b)", lambda t, s, b: t.and_(b, b),
        lambda s, d: [vec(s, d) > 10.0], lambda b: b)
    add("local_useless_clip", "math", "clip(x, -inf, inf)",
        lambda t, s, x: t.clip(x, -np.inf, np.inf), lambda s, d: [edged(s, d)], lambda x: x)
    add("local_extremum_of_neg", "math", "max(-x)", lambda t, s, x: t.max(-x),
        lambda s, d: [vec(s, d)], lambda x: (-x).max())
    add("local_even_fn_of_neg", "math", "cos(-x)", lambda t, s, x: t.cos(-x),
        lambda s, d: [vec(s, d)], np.cos)
    add("local_useless_floor_ceil_int", "math", "floor(i) * 2",
        lambda t, s, i: t.floor(i) * 2,
        lambda s, d: [np.arange(-(s * s // 2), s * s - s * s // 2, dtype="int64")],
        lambda i: i * 2)
    add("local_sign_of_sign", "math", "sign(sign(x))", lambda t, s, x: t.sign(t.sign(x)),
        lambda s, d: [edged(s, d)], np.sign)
    add("local_reduce_empty_axis", "math", "sum(x, axis=()) * 2",
        lambda t, s, x: t.sum(x, axis=()) * 2.0, lambda s, d: [vec(s, d)], lambda x: x * 2)
    add("local_sum_of_makevector", "math", "sum(make_vector(x0, x1, x2)) * x",
        lambda t, s, a, b, cc, x: t.sum(t.as_tensor_variable([a, b, cc])) * x,
        lambda s, d: [scal(1.5, d), scal(2.0, d), scal(-0.5, d), vec(s, d)],
        lambda a, b, cc, x: (a + b + cc) * x, exclude=("local_reduce_of_makevector",))
    add("local_sub_neg_to_add", "math", "x - (-y)", lambda t, s, x, y: x - (-y),
        lambda s, d: [edged(s, d), edged(s, d, 1)], lambda x, y: x + y)
    add("local_mul_minus_one", "math", "x * -1", lambda t, s, x: t.mul(x, -1.0),
        lambda s, d: [edged(s, d)], lambda x: -x)
    add("local_merge_switch_same_cond", "math", "switch(c, x, 2x) + switch(c, 3x, x)",
        lambda t, s, x: t.switch(t.lt(x, 5.0), x, 2 * x) + t.switch(t.lt(x, 5.0), 3 * x, x),
        lambda s, d: [edged(s, d)], lambda x: np.where(x < 5, 4 * x, 3 * x))
    add("local_xor_self", "math", "xor(b, b)", lambda t, s, b: t.xor(b, b),
        lambda s, d: [vec(s, d) > 10.0], lambda b: np.zeros_like(b),
        exclude=("local_logical_self",))
    add("local_reduce_join", "math", "sum(join(0, a[None], b[None]), 0)",
        lambda t, s, a, b: t.sum(t.concatenate([a[None], b[None]], axis=0), axis=0),
        lambda s, d: [vec(s, d), vec(s, d, 1)], lambda a, b: a + b)
    add("local_dot_to_mul", "math", "matmul((B, 8, 1), (B, 1, 8)) of x[:64 side]",
        lambda t, s, a, b: t.matmul(
            t.specify_shape(t.reshape(a[:64 * s], (-1, 8, 1)), (None, 8, 1)),
            t.specify_shape(t.reshape(b[:64 * s], (-1, 1, 8)), (None, 1, 8))),
        lambda s, d: [vec(s, d), vec(s, d, 1)],
        _dot_to_mul_ref)
    return c


CASES = _cases()

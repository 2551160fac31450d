"""The probe of ``tensor/rewriting/math.py``'s rewrites, both packages.

Each of the 41 ``local_*`` rewrites of the JAX package's
``tensor/rewriting/math.py`` that the port lacked before its Queue 3 item
1 repair gets one or more graphs on which it fires in the JAX package.
Each graph is built in both packages, compiled with the default
``FAST_RUN`` and fed 4,096 float64 values drawn from [0.01, 20] (seeded)
plus -0.0 and -inf, or a matrix of such values; both outputs are held
against a long-double evaluation of the expression.  A rewrite
"changes a value" when the two packages' outputs differ anywhere (NaNs
equal, the sign of a zero counted).

Run it to print the table (``python tests/torch_math_probe.py``); the
tests of the repaired rewrites (``tests/test_torch_faults.py``) import
its graphs.
"""

from __future__ import annotations

import collections
import os

import numpy as np

SEED = 20
N = 4096


def probe_values(n=N, seed=SEED):
    """``n`` float64 values in [0.01, 20], then -0.0 and -inf."""
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.uniform(0.01, 20.0, n), [-0.0, -np.inf]])


def probe_matrix(rows, cols, seed=SEED):
    return np.random.default_rng(seed).uniform(0.01, 20.0, (rows, cols))


V = probe_values()
LD = np.longdouble


def _ld(f):
    """A long-double reference of an elementwise expression, with numpy's
    warnings off."""
    def ref(*xs):
        with np.errstate(all="ignore"):
            return f(*[np.asarray(x, dtype=LD) for x in xs])
    return ref


# name -> [(label, build(pt, *inputs), inputs, long-double reference or None)]
# build takes the package's tensor namespace and symbolic inputs; inputs are
# numpy values (their dtype and ndim make the symbolic inputs), or, for a
# reduction, whose one output is one sample, a ``Draws`` of 16 seeded sets
class Draws:
    def __init__(self, make, n=16):
        self.sets = [make(SEED + k) for k in range(n)]


def input_sets(inputs):
    return inputs.sets if isinstance(inputs, Draws) else [inputs]


B = (V > 10.0)
I64 = np.arange(-50, 50, dtype="int64")


def _c(v):
    return np.asarray(v, dtype="float64")


def _vec(seed):
    return probe_values(seed=seed)[:N]


GRAPHS = {
    "local_neg_neg": [("-(-x)", lambda t, x: t.neg(t.neg(x)), [V], _ld(lambda x: x))],
    "local_exp_log": [("exp(-softplus(-x))", lambda t, x: t.exp(-t.softplus(-x)), [V],
                       _ld(lambda x: 1 / (1 + np.exp(-x))))],
    "local_sum_sum": [("sum(sum(m, 0))", lambda t, m: t.sum(t.sum(m, axis=0)),
                       Draws(lambda s: [probe_matrix(512, 64, s)]),
                       _ld(lambda m: m.sum()))],
    "local_sum_mul_by_scalar": [("sum(x * c)", lambda t, x, c: t.sum(x * c),
                                 Draws(lambda s: [_vec(s), _c(0.3)]),
                                 _ld(lambda x, c: (x * c).sum()))],
    "local_mul_switch_sink": [("switch(x < 1, 0, x) * log(x)",
                               lambda t, x: t.switch(t.lt(x, 1.0), 0.0, x) * t.log(x), [V],
                               _ld(lambda x: np.where(x < 1, 0.0, x * np.log(x))))],
    "local_div_switch_sink": [("switch(x < 1, 0, x) / x",
                               lambda t, x: t.switch(t.lt(x, 1.0), 0.0, x) / x, [V],
                               _ld(lambda x: np.where(x < 1, 0.0, x / x)))],
    "local_0_dot_x": [("dot(zeros, x)", lambda t, x: t.dot(t.zeros((3, N + 2)), x), [V],
                       _ld(lambda x: np.zeros(3)))],
    "local_log_sqrt": [("log(sqrt(x))", lambda t, x: t.log(t.sqrt(x)), [V],
                        _ld(lambda x: 0.5 * np.log(x)))],
    "local_exp_log_nan_switch": [("exp(x)**3", lambda t, x: t.exp(x) ** 3, [V],
                                  _ld(lambda x: np.exp(3 * x)))],
    "local_pow_pow": [("(x**3)**2", lambda t, x: (x ** 3) ** 2, [V], _ld(lambda x: x ** 6))],
    "local_sqr_of_sqrt_even_pow": [("sqr(abs(x))", lambda t, x: t.sqr(t.abs(x)), [V],
                                    _ld(lambda x: x * x))],
    "local_extremum_self": [("maximum(x, x)", lambda t, x: t.maximum(x, x), [V],
                             _ld(lambda x: x))],
    "local_extremum_inf": [("maximum(x, -inf)", lambda t, x: t.maximum(x, -np.inf), [V],
                            _ld(lambda x: x))],
    "local_logical_self": [("and(b, b)", lambda t, b: t.and_(b, b), [B], None)],
    "local_useless_clip": [("clip(x, -inf, inf)", lambda t, x: t.clip(x, -np.inf, np.inf),
                            [V], _ld(lambda x: x))],
    "local_reduce_chain": [("prod(prod(m, 0))", lambda t, m: t.prod(t.prod(m, axis=0)),
                            Draws(lambda s: [probe_matrix(8, 16, s) / 4.0]),
                            _ld(lambda m: m.prod())),
                           ("max(max(m, 0))", lambda t, m: t.max(t.max(m, axis=0)),
                            Draws(lambda s: [probe_matrix(512, 64, s)]),
                            _ld(lambda m: m.max()))],
    "local_extremum_of_neg": [("max(-x)", lambda t, x: t.max(-x), Draws(lambda s: [_vec(s)]),
                               _ld(lambda x: (-x).max()))],
    "local_sum_of_alloc": [("sum(alloc(c, 4097))", lambda t, c: t.sum(t.alloc(c, N + 1)),
                            Draws(lambda s: [_c(_vec(s)[0])]),
                            _ld(lambda c: c * (N + 1)))],
    "local_even_fn_of_neg": [("cos(-x)", lambda t, x: t.cos(-x), [V], _ld(np.cos)),
                             ("cosh(-x)", lambda t, x: t.cosh(-x), [V], _ld(np.cosh))],
    "local_odd_fn_of_neg": [("sinh(-x)", lambda t, x: t.sinh(-x), [V],
                             _ld(lambda x: -np.sinh(x))),
                            ("tanh(-x)", lambda t, x: t.tanh(-x), [V],
                             _ld(lambda x: -np.tanh(x))),
                            ("sin(-x)", lambda t, x: t.sin(-x), [V], _ld(lambda x: -np.sin(x))),
                            ("arctan(-x)", lambda t, x: t.arctan(-x), [V],
                             _ld(lambda x: -np.arctan(x))),
                            ("arcsinh(-x)", lambda t, x: t.arcsinh(-x), [V],
                             _ld(lambda x: -np.arcsinh(x))),
                            ("erf(-x)", lambda t, x: t.erf(-x), [V], None)],
    "local_inverse_composition": [("tan(arctan(x))", lambda t, x: t.tan(t.arctan(x)), [V],
                                   _ld(lambda x: x)),
                                  ("sinh(arcsinh(x))", lambda t, x: t.sinh(t.arcsinh(x)), [V],
                                   _ld(lambda x: x))],
    "local_useless_floor_ceil_int": [("floor(i)", lambda t, i: t.floor(i), [I64], None)],
    "local_sign_of_sign": [("sign(sign(x))", lambda t, x: t.sign(t.sign(x)), [V], None)],
    "local_reduce_empty_axis": [("sum(x, axis=())", lambda t, x: t.sum(x, axis=()), [V],
                                 _ld(lambda x: x))],
    "local_sum_of_makevector": [("sum(make_vector(x0, x1, x2))",
                                 lambda t, x: t.sum(t.as_tensor_variable([x[0], x[1], x[2]])),
                                 Draws(lambda s: [_vec(s)[:3]]),
                                 _ld(lambda x: x[:3].sum()))],
    "local_log_reciprocal_or_div_const": [("log(1 / x)", lambda t, x: t.log(1.0 / x), [V],
                                           _ld(lambda x: -np.log(x))),
                                          ("log(3 / x)", lambda t, x: t.log(3.0 / x), [V],
                                           _ld(lambda x: np.log(3) - np.log(x))),
                                          ("log(x / 3)", lambda t, x: t.log(x / 3.0), [V],
                                           _ld(lambda x: np.log(x) - np.log(3)))],
    "local_sign_reciprocal_or_div_const": [("sign(1 / x)", lambda t, x: t.sign(1.0 / x), [V],
                                            None),
                                           ("sign(-2 / x)", lambda t, x: t.sign(-2.0 / x), [V],
                                            None)],
    "local_sub_neg_to_add": [("x - (-y)", lambda t, x, y: x - (-y), [V, V[::-1].copy()],
                              _ld(lambda x, y: x + y))],
    "local_sqr_of_sqrt": [("sqr(sqrt(x))", lambda t, x: t.sqr(t.sqrt(x)), [V],
                           _ld(lambda x: np.where(x >= 0, x, np.nan)))],
    "local_exp_of_log_nan_switch": [("exp(log(x))", lambda t, x: t.exp(t.log(x)), [V],
                                     _ld(lambda x: np.where(x >= 0, x, np.nan))),
                                    ("expm1(log1p(x))", lambda t, x: t.expm1(t.log1p(x)), [V],
                                     _ld(lambda x: np.where(x >= -1, x, np.nan))),
                                    ("exp(softplus(x))", lambda t, x: t.exp(t.softplus(x)),
                                     [V / 10], _ld(lambda x: 1 + np.exp(x)))],
    "local_logexp_of_log_nan_switch": [("softplus(log(x))", lambda t, x: t.softplus(t.log(x)),
                                        [V], _ld(lambda x: np.where(x >= 0, np.log1p(x),
                                                                    np.nan)))],
    "local_pow_to_nested_squaring": [("x**5", lambda t, x: x ** 5, [V], _ld(lambda x: x ** 5)),
                                     ("x**-3", lambda t, x: x ** -3, [V],
                                      _ld(lambda x: x ** -3))],
    "local_mul_minus_one": [("x * -1", lambda t, x: t.mul(x, -1.0), [V], _ld(lambda x: -x))],
    "local_merge_switch_same_cond": [("switch(c, x, 2x) + switch(c, 3x, x)",
                                      lambda t, x: t.switch(t.lt(x, 5.0), x, 2 * x)
                                      + t.switch(t.lt(x, 5.0), 3 * x, x), [V],
                                      _ld(lambda x: np.where(x < 5, 4 * x, 3 * x)))],
    "local_log_neg_expm1": [("log(-expm1(-x))", lambda t, x: t.log(-t.expm1(-x)), [V],
                             _ld(lambda x: np.log(-np.expm1(-x))))],
    "local_func_inverse": [("log1p(expm1(x))", lambda t, x: t.log1p(t.expm1(x)), [V],
                            _ld(lambda x: x)),
                           ("arcsinh(sinh(x))", lambda t, x: t.arcsinh(t.sinh(x)), [V / 10],
                            _ld(lambda x: x)),
                           ("deg2rad(rad2deg(x))", lambda t, x: t.deg2rad(t.rad2deg(x)), [V],
                            _ld(lambda x: x))],
    "local_xor_self": [("xor(b, b)", lambda t, b: t.xor(b, b), [B], None)],
    "local_mul_pow_to_pow_add": [("x**2.5 * x**0.7", lambda t, x: x ** 2.5 * x ** 0.7, [V],
                                  _ld(lambda x: x ** 3.2))],
    "local_reduce_join": [("sum(join(0, a[None], b[None], c[None]), 0)",
                           lambda t, a, b, c: t.sum(t.concatenate(
                               [a[None], b[None], c[None]], axis=0), axis=0),
                           [V, V[::-1].copy(), V / 3], _ld(lambda a, b, c: a + b + c))],
    "local_dot_to_mul": [("matmul((B, m, 1), (B, 1, n))",
                          lambda t, a, b: t.matmul(t.specify_shape(a, (None, None, 1)),
                                                   t.specify_shape(b, (None, 1, None))),
                          [probe_matrix(6, 4).reshape(6, 4, 1),
                           probe_matrix(6, 5, seed=SEED + 3).reshape(6, 1, 5)],
                          _ld(lambda a, b: a * b))],
    "local_sumsqr2dot": [("sum(sqr(W[None] * G[:, None]), (1, 2))",
                          lambda t, w, g: t.sum(t.sqr(w.dimshuffle("x", 0, 1)
                                                      * g.dimshuffle(0, "x", 1)), axis=(1, 2)),
                          Draws(lambda s: [probe_matrix(3, 5, s) / 10.0,
                                          probe_matrix(7, 5, s + 100) / 10.0]),
                          _ld(lambda w, g: (np.square(w[None] * g[:, None])).sum((1, 2))))],
}


# the rewrites the port took from the probe: the twenty-two that change a
# value, and local_odd_fn_of_neg, which ROADMAP Queue 3 item 1 named
PORTED = ("local_exp_log", "local_sum_sum", "local_sum_mul_by_scalar", "local_mul_switch_sink",
          "local_div_switch_sink", "local_0_dot_x", "local_log_sqrt", "local_exp_log_nan_switch",
          "local_pow_pow", "local_reduce_chain", "local_sum_of_alloc", "local_odd_fn_of_neg",
          "local_inverse_composition", "local_log_reciprocal_or_div_const",
          "local_sign_reciprocal_or_div_const", "local_sqr_of_sqrt",
          "local_exp_of_log_nan_switch", "local_logexp_of_log_nan_switch",
          "local_pow_to_nested_squaring", "local_log_neg_expm1", "local_func_inverse",
          "local_mul_pow_to_pow_add", "local_sumsqr2dot")


def _fired():
    """Wrap both packages' ``FromFunctionNodeRewriter.transform`` to count
    the rewrites that change a graph; returns (counts, undo)."""
    from pytensor_tpu.graph.rewriting import basic as jbasic
    from pytensor_tpu_torch.graph.rewriting import basic as tbasic

    counts = {"jax": collections.Counter(), "torch": collections.Counter()}
    saved = []
    for key, mod in (("jax", jbasic), ("torch", tbasic)):
        orig = mod.FromFunctionNodeRewriter.transform

        def transform(self, fgraph, node, _orig=orig, _key=key):
            res = _orig(self, fgraph, node)
            if res:
                counts[_key][str(self)] += 1
            return res

        saved.append((mod, orig))
        mod.FromFunctionNodeRewriter.transform = transform

    def undo():
        for mod, orig in saved:
            mod.FromFunctionNodeRewriter.transform = orig

    return counts, undo


def compiled(build, inputs, mode=None):
    """The JAX package's and the port's outputs of ``build`` on ``inputs``,
    each compiled with the default ``FAST_RUN`` (a ``Draws``' outputs
    raveled and joined); with ``mode``, the JAX package's output in that
    mode comes first."""
    import pytensor_tpu as jptt
    import pytensor_tpu.tensor as jpt
    import pytensor_tpu_torch as tptt
    import pytensor_tpu_torch.tensor as tpt

    runs = [(jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})]
    if mode is not None:
        runs.insert(0, (jptt, jpt, {"mode": mode}))
    sets = input_sets(inputs)
    outs = []
    for ptt, pt, kw in runs:
        ins = [pt.tensor(f"x{k}", dtype=np.asarray(v).dtype, shape=(None,) * np.ndim(v))
               for k, v in enumerate(sets[0])]
        f = ptt.function(ins, build(pt, *ins), **kw)
        res = [np.asarray(f(*vals)) for vals in sets]
        outs.append(res[0] if len(res) == 1 else np.concatenate([r.ravel() for r in res]))
    return outs


# the names the JAX package registers some rewrites under (the probe's
# keys are the functions' names)
REGISTERED = {"local_exp_log": "local_exp_softplus_sigmoid",
              "local_exp_log_nan_switch": "local_pow_of_exp",
              "local_sqr_of_sqrt_even_pow": "local_sqr_of_abs",
              "local_exp_of_log_nan_switch": "local_exp_log_nan_switch",
              "local_logexp_of_log_nan_switch": "local_logexp_log_nan_switch"}


def without(name):
    """The JAX package's numpy oracle with ``FAST_RUN``'s rewrites but the
    one registered for ``name``: what the rewrite alone changes, free of
    XLA's own algebraic simplifier."""
    from pytensor_tpu.compile.mode import PY

    return PY.excluding(REGISTERED.get(name, name))


def ulps(a, b):
    """The largest distance in units of the last place between two float64
    arrays, NaNs equal; a zero of the other sign counts 1, a NaN against a
    number or two infinities of unlike sign count inf."""
    a, b = np.asarray(a, "float64"), np.asarray(b, "float64")
    if a.shape != b.shape:
        return np.inf
    nan = np.isnan(a) | np.isnan(b)
    if np.any(np.isnan(a) != np.isnan(b)):
        return np.inf
    ia = a.view(np.int64).astype(object)
    ib = b.view(np.int64).astype(object)
    # a monotone integer line: negative floats mirrored below zero
    la = np.where(ia < 0, -(ia & 0x7FFFFFFFFFFFFFFF) - 1, ia)
    lb = np.where(ib < 0, -(ib & 0x7FFFFFFFFFFFFFFF) - 1, ib)
    d = np.abs(la - lb)
    d = np.where(nan, 0, d)
    return float(np.max(d)) if d.size else 0.0


def rel_err(got, ref):
    """The largest relative error of ``got`` against the long-double
    ``ref`` at the points where ``ref`` is finite and nonzero."""
    got = np.asarray(got, LD)
    ref = np.asarray(ref, LD)
    ok = np.isfinite(ref) & (ref != 0)
    if not np.any(ok):
        return 0.0
    with np.errstate(all="ignore"):
        return float(np.max(np.abs(got[ok] - ref[ok]) / np.abs(ref[ok])))


def probe():
    """One row per graph: (rewrite, label, fired in the JAX package, fired
    in the port, ulps between the JAX package's numpy oracle with and
    without the rewrite, ulps between the compiled packages, the JAX
    package's and the port's relative errors against long double)."""
    from pytensor_tpu.compile.mode import PY

    counts, undo = _fired()
    rows = []
    try:
        for name, graphs in GRAPHS.items():
            for label, build, inputs, ref in graphs:
                (oracle,) = compiled(build, inputs, PY)[:1]
                for c in counts.values():
                    c.clear()
                bare, jout, tout = compiled(build, inputs, without(name))
                fired = counts["jax"][name], counts["torch"][name]
                refs = [ref(*vals) for vals in input_sets(inputs)] if ref is not None else None
                if refs is not None:
                    refs = refs[0] if len(refs) == 1 else np.concatenate(
                        [np.ravel(r) for r in refs])

                def dist(a, b):
                    return ulps(a, b) if a.dtype.kind == "f" else float(np.any(a != b))

                rows.append((name, label, *fired, dist(oracle, bare), dist(jout, tout),
                             rel_err(jout, refs) if refs is not None else None,
                             rel_err(tout, refs) if refs is not None else None))
    finally:
        undo()
    return rows


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print(f"{'rewrite':36s} {'graph':40s} jax port  changes  jax-port  rel(jax)  rel(port)")
    for name, label, fj, ft, ch, u, ej, et in probe():
        fmt = (lambda e: "-" if e is None else f"{e:.3g}")
        print(f"{name:36s} {label:40s} {fj:3d} {ft:4d}  {ch:7.3g}  {u:8.3g}  {fmt(ej):>8s}  "
              f"{fmt(et):>8s}")

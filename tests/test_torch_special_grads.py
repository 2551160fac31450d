"""The special functions' shape-parameter gradients against the JAX package.

The seven ops of ``scalar/math.py`` (``betainc_dda``, ``betainc_ddb``,
``gammainc_ddk``, ``gammaincc_ddk``, ``hyp2f1_dda``, ``hyp2f1_ddb``,
``hyp2f1_ddc``), the gradients of ``betainc``, ``gammainc``,
``gammaincc`` and ``hyp2f1`` that use them, ``hyp2f1``'s value, the
censored-likelihood graph of ``models/censored.py`` and K1's forward-mode
device functions (``link/cuda/special.py``) through g++.

The JAX package runs each op through ``function()`` (``FAST_RUN``, its
XLA path on the CPU: ``jax.grad`` of the fraction or series), the port its
plain version (the same fraction or series differentiated by
torch.autograd in reverse mode).  Tolerances:

- float64, on the ops' grids: ``RTOL64`` (1e-10) of ``max(1, |jax|)``; the
  two compute the same operations but for XLA's contraction of
  multiply-adds, which moves the last bits of the sums;
- float32: both compute in float64 and round once, so the port is within
  one float32 spacing of the JAX package's value;
- the edge grid: the same NaN and the same infinities at every point, and
  the finite values at ``RTOL64``, but at the points named in
  ``CANCELLING``: there the derivative is the small difference of two
  large terms, and the contraction moves it by more (the test prints both);
  parameters no smaller than 1e-150, since XLA's CPU flushes subnormal
  products to zero (at a = 1e-300 it gives NaN where a float64 card and
  torch give finite values).
"""

import itertools

import numpy as np
import pytest
import scipy.special as sps
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
from pytensor_tpu.scalar import math as jpsm

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.link.cuda import cases
from pytensor_tpu_torch.link.torch.dispatch import _one_node_k1
from pytensor_tpu_torch.models import censored
from pytensor_tpu_torch.scalar import math as tpsm

from test_torch_fused import _host_launch, k1_host  # noqa: F401 (the fixture)

RTOL64 = 1e-10
GRAD_OPS = cases.GRAD_OPS
NIN = {"betainc_dda": 3, "betainc_ddb": 3, "gammainc_ddk": 2, "gammaincc_ddk": 2,
       "hyp2f1_dda": 4, "hyp2f1_ddb": 4, "hyp2f1_ddc": 4}
TINY = np.finfo(np.float64).tiny

# the edge grid of each family: the operands' values, crossed
EDGE = {
    "gammainc": [[1e-3, 1e3, 0.5, 2.0, 0.0, -1.0, np.nan, np.inf],
                 [0.0, TINY, 1e4, 1.0, np.inf, -1.0, np.nan, 1e-300]],
    "betainc": [[1e-3, 1e-30, 1e-150, 0.0, 2.0, 1e3, -1.0, np.nan, np.inf]] * 2
    + [[0.0, 1.0, 0.5, 1e-300, 1 - 1e-16, 2.0, -1.0, np.nan]],
    "hyp2f1": [[0.5, -1.0, 0.0, 2.0, np.nan, np.inf, 5.0, 10.0],
               [1.5, 1.0, 0.0, -2.0, 3.0, 1e-3, 5.0, 3.0],
               [2.5, -1.0, 0.0, -2.0, 1.0, np.inf, 1.5, 2.0],
               [0.95, 0.5, -0.5, 0.91, -0.99, np.inf, np.nan, 0.92]],
}
# where the derivative cancels: a = 1e3, b = 1e-30, x = 1 - 1e-16 (I_x is
# 1 - 1e-16-ish, the fraction's flipped side)
CANCELLING = {"betainc_ddb": [(1e3, 1e-30, 1 - 1e-16)]}


def _family(name):
    return "gammainc" if name.startswith("gamma") else name.split("_")[0]


def edge_grid(name, tiny_params=False):
    """The crossed edge grid of ``name``'s family; with ``tiny_params``
    also a and b at 1e-300 (the device functions against the plain
    versions, where no XLA flush is in the way)."""
    vals = [list(v) for v in EDGE[_family(name)]]
    if tiny_params and _family(name) == "betainc":
        vals[0].append(1e-300)
        vals[1].append(1e-300)
    return [np.array(col) for col in zip(*itertools.product(*vals))]


def _grid(name, n, seed):
    rng = np.random.default_rng(seed)
    return [rng.uniform(*g, size=n) for g in cases.SPECIAL_GRIDS[name]]


def _both(name, args, dtype):
    """The op on ``args`` through each package's ``function()``: the JAX
    package's value, then the port's."""
    out = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        vs = [pt.tensor(f"a{k}", dtype=dtype, shape=(None,)) for k in range(len(args))]
        f = ptt.function(vs, getattr(pt, name)(*vs), **kw)
        out.append(np.asarray(f(*[np.asarray(a, dtype) for a in args])))
    return out


def _held(got, want, rtol, where=None):
    assert np.array_equal(np.isnan(got), np.isnan(want)), (where, np.nonzero(
        np.isnan(got) != np.isnan(want)))
    inf = np.isinf(want)
    assert np.array_equal(got[inf], want[inf]) and not np.isinf(got[~inf]).any(), where
    fin = np.isfinite(want)
    err = np.abs(got[fin] - want[fin]) / np.maximum(1.0, np.abs(want[fin]))
    assert err.max(initial=0) <= rtol, (where, err.max())


@pytest.mark.parametrize("name", GRAD_OPS)
def test_op_on_its_grid_float64(name):
    args = _grid(name, 64, 3)
    jax, port = _both(name, args, "float64")
    assert port.dtype == np.float64
    _held(port, jax, RTOL64, name)


@pytest.mark.parametrize("name", GRAD_OPS)
def test_op_on_its_grid_float32(name):
    """Both compute in float64 and round: one float32 spacing apart at most."""
    args = [a.astype("float32") for a in _grid(name, 64, 4)]
    jax, port = _both(name, args, "float32")
    assert port.dtype == jax.dtype == np.float32
    assert (np.abs(port - jax) <= np.spacing(np.abs(jax))).all(), name


@pytest.mark.parametrize("name", GRAD_OPS)
def test_op_on_the_edge_grid(name):
    """The same NaN and infinities as the JAX package everywhere on the edge
    grid, the finite values at RTOL64 but at ``CANCELLING``."""
    args = edge_grid(name)
    jax, port = _both(name, args, "float64")
    named = np.zeros(len(jax), bool)
    for point in CANCELLING.get(name, ()):
        named |= np.all([a == v for a, v in zip(args, point)], axis=0)
    _held(port[~named], jax[~named], RTOL64, name)
    # the cancelling points: both finite, of one sign and one magnitude
    for k in np.nonzero(named)[0]:
        assert np.sign(port[k]) == np.sign(jax[k]) and 0.25 < port[k] / jax[k] < 4, (
            name, port[k], jax[k])


@pytest.mark.parametrize("name", GRAD_OPS)
def test_oracle_is_the_jax_packages(name):
    """The numpy implementation: the JAX package's central differences."""
    args = _grid(name, 32, 5)
    np.testing.assert_array_equal(getattr(tpsm, name).np_fn(*args),
                                  getattr(jpsm, name).np_fn(*args))
    # and the oracle is near the op's value where the fraction has converged
    (port,) = _both(name, args, "float64")[1:]
    np.testing.assert_allclose(port, getattr(tpsm, name).np_fn(*args), rtol=1e-6, atol=1e-9)


@pytest.mark.parametrize("name", GRAD_OPS)
def test_the_jax_packages_oracle_path_is_the_ports_oracle(name):
    """The JAX package's ``mode="FAST_COMPILE"`` (its numpy oracle) gives
    the port's numpy implementation, on the grid and on the edge grid."""
    for args in (_grid(name, 16, 6), edge_grid(name)):
        vs = [jpt.dvector(f"a{k}") for k in range(len(args))]
        with np.errstate(all="ignore"):
            want = np.asarray(jptt.function(vs, getattr(jpt, name)(*vs),
                                            mode="FAST_COMPILE")(*args))
            np.testing.assert_array_equal(getattr(tpsm, name).np_fn(*args), want)


# the full gradients: grad of the function with respect to each parameter
GRADS = [("betainc", 0), ("betainc", 1), ("gammainc", 0), ("gammaincc", 0), ("hyp2f1", 0),
         ("hyp2f1", 1), ("hyp2f1", 2)]
GRAD_POINTS = {
    "betainc": [np.array([0.7, 1.5, 3.0, 0.5]), np.array([1.2, 2.5, 0.9, 4.0]),
                np.array([0.3, 0.6, 0.8, 0.05])],
    "gammainc": [np.array([0.7, 1.8, 3.5, 5.0]), np.array([0.5, 2.0, 4.0, 9.0])],
    "hyp2f1": [np.array([1.2, 0.5, 2.0, 5.0]), np.array([0.7, 1.5, 1.0, 5.0]),
               np.array([2.3, 2.5, 3.0, 1.5]), np.array([0.4, -0.6, 0.95, -0.91])],
}
GRAD_POINTS["gammaincc"] = GRAD_POINTS["gammainc"]


@pytest.mark.parametrize("fn,wrt", GRADS)
def test_shape_parameter_gradient_against_the_jax_package(fn, wrt):
    """``grad`` of the function in a shape parameter builds (it raised
    NullTypeGradError before) and gives the JAX package's value."""
    vals = GRAD_POINTS[fn]
    out = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        vs = [pt.dvector(f"a{k}") for k in range(len(vals))]
        g = ptt.grad(pt.sum(getattr(pt, fn)(*vs)), vs[wrt])
        out.append(np.asarray(ptt.function(vs, g, **kw)(*vals)))
    _held(out[1], out[0], RTOL64, (fn, wrt))


def test_hyp2f1_parameter_gradient_at_large_z_is_the_clipped_series():
    """A reference behaviour: past |z| = 0.92 the gradient differentiates
    the series at z clipped to 0.92, not scipy's function; at (0.5, 1.5,
    2.5, 0.95) d/dc is -0.627 so, and -0.797 by scipy's differences."""
    a, b, c, z = (np.array([v]) for v in (0.5, 1.5, 2.5, 0.95))
    (jax, port) = _both("hyp2f1_ddc", [a, b, c, z], "float64")
    np.testing.assert_allclose(port, jax, rtol=RTOL64)
    np.testing.assert_allclose(port, [-0.627], atol=1e-3)
    np.testing.assert_allclose(tpsm.hyp2f1_ddc.np_fn(a, b, c, z), [-0.797], atol=1e-3)
    # and the same as at z = 0.92 itself
    np.testing.assert_array_equal(port, _both("hyp2f1_ddc", [a, b, c, z * 0 + 0.92],
                                              "float64")[1])


def test_verify_grad_betainc_parameters():
    """tests/test_op_grids_special.py:107's check in the port."""
    av, bv = np.array([0.8, 1.5, 3.0]), np.array([1.2, 2.5, 0.9])
    xv = np.array([0.3, 0.6, 0.8])
    tptt.verify_grad(lambda a, b: tpt.betainc(a, b, tpt.constant(xv)).sum(), [av, bv],
                     rng=np.random.default_rng(9), abs_tol=1e-5, rel_tol=1e-5, device="cpu")


def test_verify_grad_gammainc_parameter():
    """tests/test_op_grids_special.py:119's check in the port."""
    av, xv = np.array([0.7, 1.8, 3.5]), np.array([0.5, 2.0, 4.0])
    tptt.verify_grad(lambda a: tpt.gammainc(a, tpt.constant(xv)).sum(), [av],
                     rng=np.random.default_rng(10), abs_tol=1e-5, rel_tol=1e-5, device="cpu")


def test_verify_grad_gammaincc_parameter():
    av, xv = np.array([0.7, 1.8, 3.5]), np.array([0.5, 2.0, 4.0])
    tptt.verify_grad(lambda a: tpt.gammaincc(a, tpt.constant(xv)).sum(), [av],
                     rng=np.random.default_rng(11), abs_tol=1e-5, rel_tol=1e-5, device="cpu")


def test_scalar_helpers_build_the_ops():
    """``gammainc_grad``, ``gammaincc_grad``, ``betainc_grad``,
    ``hyp2f1_grad`` and ``Grad2F1Loop`` as the JAX package's."""
    a, b, c, z = (tpt.dvector(n) for n in "abcz")
    assert tpsm.gammainc_grad(a, z).owner.op.scalar_op is tpsm.gammainc_ddk
    assert tpsm.gammaincc_grad(a, z).owner.op.scalar_op is tpsm.gammaincc_ddk
    assert tpsm.betainc_grad(a, b, z, wrtp=False).owner.op.scalar_op is tpsm.betainc_ddb
    outs = tpsm.hyp2f1_grad(a, b, c, z, [0, 2])
    assert [o.owner.op.scalar_op for o in outs] == [tpsm.hyp2f1_dda, tpsm.hyp2f1_ddc]
    assert tpsm.hyp2f1_grad(a, b, c, z, 1).owner.op.scalar_op is tpsm.hyp2f1_ddb
    assert isinstance(tpsm.hyp2f1_dda, tpsm.Grad2F1Loop)


# --- hyp2f1's value: the JAX package's series below |z| = 0.92 -----------------

@pytest.mark.parametrize("abc", [(5.0, 5.0, 1.5), (10.0, 3.0, 2.0)])
def test_hyp2f1_value_is_the_jax_packages(abc):
    """The port's value was scipy's everywhere; the JAX package's is its
    256-term series below |z| = 0.92, which has not converged where
    a + b - c is large (at (5, 5, 1.5) and z = -0.91, 3.0281e4 against
    scipy's 1.6099e-3): the port is held to it at rtol 1e-12."""
    z = np.array([0.3, 0.9, 0.91, -0.91, 0.95])
    args = [np.full(5, v) for v in abc] + [z]
    jax, port = _both("hyp2f1", args, "float64")
    np.testing.assert_allclose(port, jax, rtol=1e-12)
    # scipy where |z| >= 0.92, exactly
    assert port[4] == sps.hyp2f1(*abc, 0.95)
    if abc == (5.0, 5.0, 1.5):
        np.testing.assert_allclose(port[3], 3.0281e4, rtol=1e-4)
        np.testing.assert_allclose(sps.hyp2f1(*abc, -0.91), 1.6099e-3, rtol=1e-4)


def test_hyp2f1_value_reads_the_host():
    """It stays a host lowering (``reads_back``), as the JAX package's
    ``pure_callback``; float32 rounds the float64 value."""
    z = tpt.fvector("z")
    f = tptt.function([z], tpt.hyp2f1(1.2, 0.7, 2.3, z), device="cpu")
    assert any("hyp2f1" in r for r in f.linked.host_reads)
    zv = np.linspace(-0.99, 0.99, 9).astype("float32")
    jf = jptt.function([jz := jpt.fvector("z")], jpt.hyp2f1(1.2, 0.7, 2.3, jz))
    np.testing.assert_array_equal(np.asarray(f(zv)), np.asarray(jf(zv)))


# --- the graphs: grouped as in the JAX package -----------------------------------

def _ops(f):
    fg = f.maker.fgraph if hasattr(f, "maker") else f.fgraph
    return [type(n.op).__name__ + ("{" + n.op.scalar_op.name + "}"
                                   if hasattr(n.op, "scalar_op") else "")
            for n in fg.toposort()]


def _inner(f):
    fg = f.maker.fgraph if hasattr(f, "maker") else f.fgraph
    return [sorted(str(m.op.scalar_op) for m in n.op.fgraph.apply_nodes)
            for n in fg.toposort() if type(n.op).__name__ == "FusedElemwise"]


def test_the_seven_ops_fuse_as_in_the_jax_package():
    """K1 emits the seven ops, so the fusion pass takes them as the JAX
    package's does: one FusedElemwise, the same inner ops."""
    def build(pt, a, b, x):
        return (pt.betainc_dda(a, b, x) * 2.0 + pt.betainc_ddb(a, b, x)
                + pt.gammainc_ddk(a, x * 3.0) - pt.gammaincc_ddk(b, x)
                + pt.hyp2f1_dda(a, b, a + 1.0, x) + pt.hyp2f1_ddb(a, b, b + 1.0, -x)
                + pt.hyp2f1_ddc(a, b, a + b, x * 0.5))

    vals = [np.array([0.7, 1.5, 3.0]), np.array([1.2, 2.5, 0.9]), np.array([0.3, 0.6, 0.8])]
    res = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        vs = [pt.dvector(n) for n in "abx"]
        f = ptt.function(vs, build(pt, *vs), **kw)
        res.append((_ops(f), _inner(f), np.asarray(f(*vals))))
    assert res[1][0] == res[0][0] == ["FusedElemwise"]
    assert res[1][1] == res[0][1]
    _held(res[1][2], res[0][2], RTOL64)


def test_censored_logp_and_gradient_against_the_jax_package():
    """``models/censored.py``'s graph at 4,096 elements in both packages:
    the same ops, the same fused groups, ``logp`` and its four gradients
    at RTOL64, and both at scipy's central differences (rtol 1e-7: the
    differences' own error)."""
    t, y = censored.censored_data(4096, 7)
    params = [np.asarray(p) for p in censored.PARAMS]
    res = []
    for ptt, pt, kw in ((jptt, jpt, {}), (tptt, tpt, {"device": "cpu"})):
        ins, outs = censored.censored_graph(ptt, pt)
        f = ptt.function(ins, outs, **kw)
        res.append((_ops(f), _inner(f), [float(np.asarray(o)) for o in f(t, y, *params)]))
    assert res[1][0] == res[0][0]
    assert res[1][1] == res[0][1]
    assert any("gammaincc_ddk" in g for g in res[1][1])
    assert any("betainc_dda" in g for g in res[1][1])
    np.testing.assert_allclose(res[1][2], res[0][2], rtol=RTOL64)
    logp, grads = censored.censored_reference(t, y)
    np.testing.assert_allclose(res[1][2], [logp, *grads], rtol=1e-7)


def test_censored_function_captures_nothing_from_the_host():
    f = censored.make_censored_logp(device="cpu")
    assert f.linked.host_reads == []


# --- K1's device functions through g++ against the plain versions ----------------

def _k1_runs(dtype, edges):
    runs = []
    for name in GRAD_OPS:
        vs = [tpt.tensor(f"a{k}", dtype=dtype, shape=(None,)) for k in range(NIN[name])]
        node = getattr(tpt, name)(*vs).owner
        fn = _one_node_k1(node.op, node, "cpu")
        args = edge_grid(name, tiny_params=True) if edges else _grid(name, 257, 8)
        runs.append((name, fn.k1, [torch.from_numpy(np.asarray(a, dtype)) for a in args]))
    return runs


def infinite_parameters(name, args):
    """The one difference of patterns: hyp2f1's parameter gradients where
    a or b is infinite.  The series' terms are then infinite (+inf and
    -inf in turn where z < 0, or past a pole of c) and its value NaN; the
    reverse pass adds each term's cotangent (1 plus the next one's times
    an infinity) and gives +-inf, the forward pass adds the terms'
    derivatives, infinities of both signs, and gives NaN."""
    if not name.startswith("hyp2f1"):
        return np.zeros(len(args[0]), bool)
    a, b = (np.asarray(v, "float64") for v in args[:2])
    return np.isinf(a) | np.isinf(b)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("edges", [False, True], ids=["grid", "edges"])
def test_k1_device_functions_match_the_plain_versions(k1_host, dtype, edges):  # noqa: F811
    """The forward-mode device functions against the reverse-mode plain
    versions: within 5e-9 (float64) or 2e-5 (float32) of max(1, |plain|),
    the same NaN and infinities, on the grids and on the edge grids (a and
    b down to 1e-300 here).  The points that make a forward pass differ
    from a reverse one, and what the device functions do about each:

    - a guard or a clip cuts a branch off at x = 0 or 1, where the other
      side's fraction overflows (betainc at x <= 0 with a = 2, and at
      x = 1): the cut branch's derivative counts as an exact zero, or as
      NaN only where a partial on its paths is not finite (``ks_cut``);
    - a constant times an infinity (hyp2f1's first term at a = inf, the
      fraction's first c at x = 1): a constant's derivative is an exact
      zero (``ks_const``);
    - an infinite a or b (``infinite_parameters``): there
      neither is finite, the device gives NaN where it does not give the
      plain version's infinity, and the test holds that;
    - a = 1e-300, b = 1e3 and x <= 1e-300 (``_at_the_clip``): I_x is 1 to the
      last bit, and whether it rounds above 1 (the clip cuts the
      derivative off) or to 1 turns on the last bit of lgamma(1e-300),
      which the host's libm and torch give differently: held finite."""
    runs = _k1_runs(dtype, edges)
    lib = k1_host([k for _, k, _ in runs])
    for name, kern, args in runs:
        (got,), _ = _host_launch(lib, kern, args)
        want = kern.plain(*args)[0]
        assert got.dtype == want.dtype == getattr(torch, dtype)
        g, w = got.double().numpy(), want.double().numpy()
        alt = infinite_parameters(name, args)
        assert not np.isfinite(g[alt]).any() and not np.isfinite(w[alt]).any(), name
        assert np.array_equal(g[alt & ~np.isnan(g)], w[alt & ~np.isnan(g)]), name
        clip = _at_the_clip(name, args)
        assert np.isfinite(g[clip]).all() and np.isfinite(w[clip]).all(), name
        rest = ~alt & ~clip
        _held(g[rest], w[rest], 5e-9 if dtype == "float64" else 2e-5, name)


def _at_the_clip(name, args):
    if not name.startswith("betainc"):
        return np.zeros(len(args[0]), bool)
    a, b, x = (np.asarray(v, "float64") for v in args)
    return (a == 1e-300) & (b == 1e3) & (x <= 1e-300)


def test_k1_source_of_a_gradient_carries_its_helpers():
    vs = [tpt.dvector(n) for n in "abx"]
    node = tpt.betainc_dda(*vs).owner
    src = _one_node_k1(node.op, node, "cpu").k1.source
    assert "ks_betainc_dda(a0, a1, a2)" in src and "ks_psi" in src and "ks_ik_core" not in src
    assert "__noinline__ double ks_betainc_dda" in src


def test_k1_counts_the_gradients_it_holds():
    """A K1 kernel knows which of the seven device functions it computes:
    its launches count once for each in ``fused_kernel.OP_LAUNCHES`` (on a
    card; a captured graph's replays add them), the others not at all."""
    from pytensor_tpu_torch.tensor import fused_kernel
    from pytensor_tpu_torch.tensor.fused import FusedElemwise

    a, b, x = (tpt.dvector(n) for n in "abx")
    outs = [tpt.betainc_dda(a, b, x) * 2.0, tpt.betainc_ddb(a, b, x) + tpt.exp(x)]
    kern = fused_kernel.FusedElemwiseKernel(FusedElemwise([a, b, x], outs).fgraph, "cpu")
    assert kern.counted == ["betainc_dda", "betainc_ddb"]
    assert fused_kernel.COUNTED_OPS == set(GRAD_OPS)
    plain = fused_kernel.FusedElemwiseKernel(FusedElemwise([x], [tpt.exp(x) * 2.0]).fgraph,
                                             "cpu")
    assert plain.counted == []

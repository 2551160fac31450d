"""bfloat16 through the port, against the JAX package on the CPU.

The same inputs, made from a seed with numpy and carried as
``ml_dtypes.bfloat16`` arrays, go through both packages:

- the promotion table of ``upcast``/``upcast_float`` over every dtype
  paired with bfloat16, and the Elemwise output dtype of each pair;
- bfloat16 Elemwise, CAReduce, ``mean``, cast and ``dot`` graphs.  torch's
  CPU ops round each bfloat16 op's result as XLA does, and reductions and
  products accumulate in float32 and round once in both, so the values
  are equal bit for bit (NaN for NaN).  ``sigmoid`` is ``jax.nn.sigmoid``'s
  composite, each op rounded, within 1 ulp where the libraries' ``exp``
  differ;
- ``grad`` of a bfloat16 cost;
- the deep-MLP "MFU" step (batch 64, d 64, depth 2) and the GEMM chain
  (batch 64, d 64, 2 matrices, 2 applications a call) against
  ``pytensor_tpu/models/mlp.py``'s, weights carried across as
  ``ml_dtypes`` arrays, and their graphs op for op after ``FAST_RUN``.
  The MFU step is equal bit for bit.  The chain is held bit for bit to a
  float64 NumPy chain that rounds each op to bfloat16 as its graph says,
  and within ``2**-7`` (one bfloat16 ulp at 1) to the JAX package's: XLA
  keeps excess precision where a bfloat16 product is cast straight to
  float32 (``xla_allow_excess_precision``, on by default), so it skips that
  rounding (with the flag off the two agree to float32's last bits);
- K1's and K2's bfloat16 sources compiled with g++ against
  ``tests/k1_host.h``/``tests/k2_host.h`` (the bfloat16 type of
  ``tests/bf16_host.h``) and held against their plain versions: every op
  of K1's table (the exact ops bit for bit, the others within 1 ulp), the
  16-byte vector path of eight values, a host value in its pointer's
  place; the special functions against float64 scipy rounded to bfloat16
  (within 1 ulp, or the JAX package's own error where that is larger);
  K2's EWMA and a scan of products and reductions against the step loop;
- the bfloat16 sparse refusal in both packages (scipy has no bfloat16);
- the linker's cuBLAS setting: ``allow_bf16_reduced_precision_reduction``
  off while a plan linked for CUDA runs, and the caller's restored.
"""

import warnings
from collections import Counter

import ml_dtypes
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pytensor_tpu as jptt
import pytensor_tpu.models.mlp as jmlp
import pytensor_tpu.scalar.basic as jbasic
import pytensor_tpu.sparse as jsparse
import pytensor_tpu.tensor as jpt
from pytensor_tpu.link.pallas.scan_pallas import pallas_scan_eligible

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.models.mlp as tmlp
import pytensor_tpu_torch.scalar.basic as tbasic
import pytensor_tpu_torch.sparse as tsparse
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.config import config as tconfig
from pytensor_tpu_torch.link.cuda import cases
from pytensor_tpu_torch.link.cuda.scan_kernel import scan_kernel_eligible
from pytensor_tpu_torch.link.torch.convert import as_torch, to_numpy
from pytensor_tpu_torch.link.torch.dispatch import _one_node_k1
from pytensor_tpu_torch.tensor import fused_kernel
from pytensor_tpu_torch.tensor.fused import FusedElemwise

from test_torch_fused import _host_launch, k1_host  # noqa: F401 (the fixture)
from test_torch_scan_kernel import _emulated_vs_loop, gxx  # noqa: F401 (the fixture)

BF = ml_dtypes.bfloat16
PKGS = (("jax", jptt, jpt), ("torch", tptt, tpt))
# one bfloat16 ulp at 1
BF16_EPS = 2.0 ** -7


def _np(v):
    """A function's output as numpy: bfloat16 as ml_dtypes' bfloat16."""
    return to_numpy(v) if isinstance(v, torch.Tensor) else np.asarray(v)


def _ulps(a, b):
    """bfloat16 ulps between a and b, element by element (0 where both are
    NaN, and between +0.0 and -0.0)."""
    def ordered(x):
        u = np.asarray(x, dtype=BF).view(np.int16).astype(np.int32)
        return np.where(u < 0, -(u & 0x7FFF), u)

    a, b = np.asarray(a, dtype=BF), np.asarray(b, dtype=BF)
    d = np.abs(ordered(a) - ordered(b))
    both_nan = np.isnan(a.astype("float32")) & np.isnan(b.astype("float32"))
    return np.where(both_nan, 0, d)


def _bf16_values(n, seed, scale=2.0, edges=True):
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n) * scale
    if edges:
        v[:8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, -2.5, 1.0][:n]
    return v.astype(BF)


def _both(build, values):
    """The outputs of the graph ``build(pt)`` in each package on
    ``values``, as numpy arrays."""
    out = {}
    for name, ptt, pt in PKGS:
        ins, outs = build(pt)
        kw = {"device": "cpu"} if name == "torch" else {}
        f = ptt.function(ins, outs, **kw)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            res = f(*values)
        out[name] = [_np(r) for r in (res if isinstance(res, (list, tuple)) else [res])]
    return out["jax"], out["torch"]


# --- promotion ---------------------------------------------------------------------

ALL_DTYPES = ("bool", "int8", "int16", "int32", "int64", "uint8", "uint16", "uint32",
              "uint64", "float16", "bfloat16", "float32", "float64", "complex64", "complex128")


@pytest.mark.parametrize("first", [True, False], ids=["bf16_first", "bf16_second"])
@pytest.mark.parametrize("other", ALL_DTYPES)
def test_promotion_table(other, first):
    """``upcast`` and ``upcast_float`` of bfloat16 with every dtype, in
    either order, as the JAX package's (its scalar/basic.py:23-54):
    bfloat16 with a discrete dtype is bfloat16, with float16 or float32
    float32."""
    pair = ("bfloat16", other) if first else (other, "bfloat16")
    assert tbasic.upcast(*pair) == jbasic.upcast(*pair)
    assert tbasic.upcast_float(*pair) == jbasic.upcast_float(*pair)
    if other in ("int8", "uint64", "bool", "bfloat16"):
        assert tbasic.upcast(*pair) == "bfloat16"
    if other in ("float16", "float32"):
        assert tbasic.upcast(*pair) == "float32"


@pytest.mark.parametrize("other", [d for d in ALL_DTYPES if not d.startswith("complex")])
def test_elemwise_output_dtype(other):
    """``x + y`` and ``x / y`` of a bfloat16 x and a y of each dtype have
    the JAX package's output dtypes."""
    got = {}
    for name, _, pt in PKGS:
        x = pt.tensor("x", dtype="bfloat16", shape=(3,))
        y = pt.tensor("y", dtype=other, shape=(3,))
        got[name] = [(x + y).type.dtype, (y / x).type.dtype, pt.maximum(x, y).type.dtype]
    assert got["torch"] == got["jax"]


# --- values ----------------------------------------------------------------------------

N = 4096

UNARY = {
    "exp": lambda pt, x: pt.exp(x),
    "tanh": lambda pt, x: pt.tanh(x),
    "log": lambda pt, x: pt.log(x),
    "sqrt": lambda pt, x: pt.sqrt(x),
    "neg_abs": lambda pt, x: -pt.abs(x),
    "relu": lambda pt, x: pt.maximum(x, np.asarray(0, BF)),
    "sqr_plus_int": lambda pt, x: pt.sqr(x) + np.int8(3),
    "cast_f32": lambda pt, x: pt.cast(x, "float32"),
    "cast_f64": lambda pt, x: pt.cast(x, "float64"),
    "cast_i32": lambda pt, x: pt.cast(x, "int32"),
    "sum": lambda pt, x: pt.sum(x),
    "mean": lambda pt, x: pt.mean(x),
    "max": lambda pt, x: pt.max(x),
}


@pytest.mark.parametrize("name", list(UNARY))
def test_unary_graphs_bit_for_bit(name):
    """Each graph of one bfloat16 input, with NaN, infinities and signed
    zeros in front (but for the cast to int32, where a NaN's or an
    infinity's integer is each library's own): the JAX package's dtype and
    bits."""
    x = _bf16_values(N, 1)
    if name == "cast_i32":
        x = _bf16_values(N, 1, edges=False)

    def build(pt):
        xv = pt.tensor("x", dtype="bfloat16", shape=(N,))
        return [xv], [UNARY[name](pt, xv)]

    (j,), (t,) = _both(build, [x])
    assert str(t.dtype) == str(j.dtype)
    if t.dtype == BF:
        assert int(_ulps(t, j).max(initial=0)) == 0
    else:
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("axis", [0, 1])
def test_axis_sum_rounds_once(axis):
    """A bfloat16 sum over one axis of a (64, 64) matrix: the port
    accumulates in float32 and rounds once, within 1 ulp of the float64
    sum rounded to bfloat16.  XLA's CPU reduction over one axis of several
    rounds each add to bfloat16 (a reference behaviour: its error is the
    larger; its sum over the whole array rounds once, as
    ``test_unary_graphs_bit_for_bit[sum]`` holds)."""
    x = _bf16_values(N, 1, edges=False)

    def build(pt):
        xv = pt.tensor("x", dtype="bfloat16", shape=(N,))
        return [xv], [pt.sum(xv.reshape((64, 64)), axis=axis)]

    (j,), (t,) = _both(build, [x])
    exact = x.astype("float64").reshape(64, 64).sum(axis=axis).astype("float32").astype(BF)
    assert t.dtype == j.dtype == BF
    assert int(_ulps(t, exact).max()) <= 1
    assert int(_ulps(j, exact).max()) > int(_ulps(t, exact).max())


BINARY = {
    "add": lambda pt, x, y: x + y,
    "sub": lambda pt, x, y: x - y,
    "mul": lambda pt, x, y: x * y,
    "true_div": lambda pt, x, y: x / y,
    "exp_mul_add": lambda pt, x, y: pt.exp(x * y) + x,
    "ge_switch": lambda pt, x, y: pt.switch(x >= 0, y, np.asarray(0, BF)),
    "dot": lambda pt, x, y: pt.dot(x.reshape((64, 64)), y.reshape((64, 64))),
    "dot_mv": lambda pt, x, y: pt.dot(x.reshape((64, 64)), y[:64]),
    "dot22scalar_add": lambda pt, x, y: (pt.dot(x.reshape((64, 64)), y.reshape((64, 64)))
                                         * np.asarray(0.5, BF) + x.reshape((64, 64))),
    "blockwise_matmul": lambda pt, x, y: pt.matmul(x.reshape((4, 32, 32)),
                                                   y.reshape((4, 32, 32))),
    "mixed_f32": lambda pt, x, y: x * pt.cast(y, "float32"),
}


@pytest.mark.parametrize("name", list(BINARY))
def test_binary_graphs_bit_for_bit(name):
    """Each graph of two bfloat16 inputs: the JAX package's dtype and bits
    (a fused chain rounds after each op in both; a product accumulates in
    float32 and rounds once in both: ``Dot``, ``Dot22Scalar`` and a
    ``Blockwise{Dot}`` of a batch)."""
    x, y = _bf16_values(N, 2), _bf16_values(N, 3, scale=1.0)
    if "dot" in name or "matmul" in name:
        x, y = _bf16_values(N, 2, edges=False), _bf16_values(N, 3, edges=False)

    def build(pt):
        xv, yv = (pt.tensor(k, dtype="bfloat16", shape=(N,)) for k in "xy")
        return [xv, yv], [BINARY[name](pt, xv, yv)]

    (j,), (t,) = _both(build, [x, y])
    assert str(t.dtype) == str(j.dtype)
    assert int(_ulps(t, j).max(initial=0)) == 0


def test_sigmoid_is_jax_nn_sigmoid():
    """``sigmoid`` in bfloat16 is ``jax.nn.sigmoid``'s composite, which XLA
    computes as ``1 / (1 + exp(-x))`` with each op rounded to bfloat16: the
    port's plain version and K1 emit the same, within 1 ulp of the JAX
    package (where the two libraries' ``exp`` round to either side of a
    tie), and not torch's float-then-round ``sigmoid``."""
    x = _bf16_values(N, 4)

    def build(pt):
        xv = pt.tensor("x", dtype="bfloat16", shape=(N,))
        return [xv], [pt.sigmoid(xv)]

    (j,), (t,) = _both(build, [x])
    xt = as_torch(x, "cpu")
    once = to_numpy(torch.sigmoid(xt))
    assert t.dtype == BF
    assert int(_ulps(t, j).max()) <= 1
    assert int((_ulps(t, j) > 0).sum()) <= int((_ulps(once, j) > 0).sum()) // 100


def test_grad_of_a_bfloat16_cost():
    """The seed of a bfloat16 cost's gradient is bfloat16 (the JAX
    package's gradient.py:106-112), and the gradients of a small tanh layer
    are the JAX package's bit for bit.  The cost itself is within 1 ulp:
    XLA fuses the square into its sum and keeps it in float32."""
    rng = np.random.default_rng(5)
    X = (rng.standard_normal((16, 8))).astype(BF)
    W = (rng.standard_normal((8, 4)) * 0.5).astype(BF)

    def build(pt, ptt):
        Xv = pt.tensor("X", dtype="bfloat16", shape=(16, 8))
        Wv = pt.tensor("W", dtype="bfloat16", shape=(8, 4))
        cost = pt.sum(pt.tanh(pt.dot(Xv, Wv)) ** 2)
        assert cost.type.dtype == "bfloat16"
        return [Xv, Wv], [cost, *ptt.grad(cost, [Xv, Wv])]

    out = {}
    for name, ptt, pt in PKGS:
        ins, outs = build(pt, ptt)
        assert [o.type.dtype for o in outs] == ["bfloat16"] * 3
        f = ptt.function(ins, outs, **({"device": "cpu"} if name == "torch" else {}))
        out[name] = [_np(r) for r in f(X, W)]
    for k, (t, j) in enumerate(zip(out["torch"], out["jax"])):
        assert t.dtype == BF and int(_ulps(t, j).max()) <= (1 if k == 0 else 0)


# --- values in and out ------------------------------------------------------------------

def test_bfloat16_values_in_and_out():
    """``ml_dtypes.bfloat16`` arrays go in as inputs, constants and shared
    values (from numpy, and a torch bfloat16 tensor borrowed); outputs are
    ``torch.bfloat16``; ``to_numpy`` gives back the same bits, NaN kept; a
    Python float fills a bfloat16 input; ``floatX`` takes bfloat16."""
    x = np.array([1.5, -2.25, np.nan, -0.0, 3e38], dtype=BF)
    t = as_torch(x, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(t).view(np.int16), x.view(np.int16))
    borrowed = torch.arange(4, dtype=torch.bfloat16)
    s1 = tptt.shared(np.ones(4, dtype=BF), name="s1", device="cpu")
    s2 = tptt.shared(borrowed, name="s2", device="cpu", borrow=True)
    assert s1.type.dtype == s2.type.dtype == "bfloat16"
    assert s2.get_value(borrow=True).data_ptr() == borrowed.data_ptr()
    v = tpt.tensor("v", dtype="bfloat16", shape=(4,))
    f = tptt.function([v], v * s1 + s2 + np.asarray(0.5, BF), updates={s1: s1 * v},
                      device="cpu")
    out = f(np.array([1, 2, 3, 4], dtype=BF))
    assert out.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(out).astype("float32"), [1.5, 3.5, 5.5, 7.5])
    assert s1.get_value().dtype == torch.bfloat16
    np.testing.assert_array_equal(to_numpy(s1.get_value()).astype("float32"), [1, 2, 3, 4])
    assert to_numpy(f([0.1, 0.2, 0.3, 0.4])).dtype == BF
    assert tpt.TensorType("bfloat16", (2,)).numpy_dtype == np.dtype(BF)
    # floatX bfloat16 makes bfloat16 the default float of a variable; a
    # literal stays float32 (NumpyAutocaster's dtypes), in both packages
    from pytensor_tpu.config import config as jconfig

    with tconfig.change_flags(floatX="bfloat16"), jconfig.change_flags(floatX="bfloat16"):
        for _, _, pt in PKGS:
            assert pt.vector("v").type.dtype == "bfloat16"
            assert pt.as_tensor_variable(0.5).type.dtype == "float32"


# --- the models -------------------------------------------------------------------------

def _ops(fgraph):
    """Op names, each FusedElemwise, Elemwise and CAReduce by its scalar
    ops, each scan's inner graph counted in."""
    c = Counter()
    for node in fgraph.apply_nodes:
        name = type(node.op).__name__
        c[str(node.op) if name in ("FusedElemwise", "Elemwise") else name] += 1
        if name == "Scan":
            c.update(f"Scan/{k}" for k in _ops(node.op.fgraph).elements())
    return c


def _weights(f):
    return sorted(f.shared_vars, key=lambda v: v.name)


@pytest.mark.parametrize("steps", [1, 2], ids=["function", "train_loop"])
def test_mlp_mfu_step(steps):
    """The bfloat16 MFU step (batch 64, d 64, depth 2, lr 0.5 so that the
    update shows in bfloat16) and its 2-step loop: the JAX package's ops
    after FAST_RUN (K1's bfloat16 fusion groups the same nodes), its
    losses and weights bit for bit after 3 calls, the port's weights
    taking the JAX package's as ``ml_dtypes`` arrays first (the float32
    loss within ``2**-8``: XLA keeps ``h - T`` in float32 where the graph
    casts it from bfloat16, and sums the mean in another order); and one
    step against ``mlp_mfu_reference(..., bf16=True)``, float64 rounded
    where the graph rounds."""
    kw = dict(batch=64, d=64, depth=2, lr=0.5, n_steps_per_call=steps)
    jf, jflops, (jX, jT) = jmlp.make_mlp_mfu_step(**kw)
    tf, tflops, (tX, tT) = tmlp.make_mlp_mfu_step(**kw, device="cpu")
    assert jflops == tflops == 2 * 3 * 2 * 64 * 64 * 64
    assert _ops(tf.fgraph) == _ops(jf.maker.fgraph)
    assert tf.linked.host_reads == []
    jX, jT = np.asarray(jX), np.asarray(jT)
    # the ramps agree; the port takes the JAX package's values all the same
    assert int(_ulps(to_numpy(tX), jX).max()) == 0
    for jw, tw in zip(_weights(jf), _weights(tf)):
        tw.set_value(np.asarray(jw.get_value()))
    init = [to_numpy(w.get_value()) for w in _weights(tf)]
    for _ in range(3):
        jl, tl = jf(jX, jT), tf(as_torch(jX, "cpu"), as_torch(jT, "cpu"))
        assert tl.dtype == torch.float32
        assert abs(float(tl) - float(np.asarray(jl))) <= 2.0 ** -8 * float(np.asarray(jl))
    for jw, tw in zip(_weights(jf), _weights(tf)):
        assert tw.get_value().dtype == torch.bfloat16
        assert int(_ulps(to_numpy(tw.get_value()), np.asarray(jw.get_value())).max()) == 0
    if steps == 1:
        # one step from the initial weights against the float64 step that
        # rounds to bfloat16 where the graph does: the loss to float32's
        # sums, every weight within 1 ulp (a product summed in float32
        # rounds to the other side of a tie now and then)
        fresh, _, (X, T) = tmlp.make_mlp_mfu_step(64, 64, 2, lr=0.5, device="cpu")
        for w, v in zip(_weights(fresh), init):
            w.set_value(v)
        loss = float(fresh(X, T))
        losses, after, _ = tmlp.mlp_mfu_reference(X, T, init, 0.5, 1, bf16=True)
        assert abs(loss - losses[0]) <= 1e-6 * losses[0]
        for w, r in zip(_weights(fresh), after[0]):
            assert int(_ulps(to_numpy(w.get_value()), r.astype("float32")).max()) <= 1


def _chain_reference(d, nmat, batch, calls, steps):
    """The GEMM chain in float64 NumPy, each op rounded to bfloat16 (the
    products) or float32 (the renormalisation) as its graph says; the last
    scale of each call."""
    def bf(a):
        return a.astype("float32").astype(BF).astype("float64")

    x = bf(tmlp.dev_ramp(batch * d, 0.31, 1.0, "float32", "cpu").numpy().reshape(batch, d))
    Ws = [bf((torch.sin(torch.arange(d * d, dtype=torch.float32) * (0.7 + 0.13 * i))
              / float(np.sqrt(d))).numpy().reshape(d, d)) for i in range(nmat)]
    scales = []
    for _ in range(calls):
        for _ in range(steps):
            y = x
            for W in Ws:
                y = bf(y @ W)
            s = np.float32(np.sqrt(np.float32(np.mean(y ** 2)))) + np.float32(1e-6)
            x = bf((y.astype("float32") / s).astype("float64"))
        scales.append(float(s))
    return scales


def test_gemm_chain():
    """The bfloat16 GEMM chain (batch 64, d 64, 2 matrices, 2 applications
    a call): the JAX package's ops; each call's scale bit for bit the
    float64 chain rounded op by op, and within ``2**-7`` of the JAX
    package's (which keeps excess precision at the cast to float32)."""
    jf, jflops = jmlp.make_gemm_chain(64, 64, 2, n_steps_per_call=2)
    tf, tflops = tmlp.make_gemm_chain(64, 64, 2, n_steps_per_call=2, device="cpu")
    assert jflops == tflops
    assert _ops(tf.fgraph) == _ops(jf.maker.fgraph)
    ref = _chain_reference(64, 2, 64, 3, 2)
    for k in range(3):
        t, j = float(tf()), float(jf())
        assert abs(t - ref[k]) <= 1e-6 * ref[k], (k, t, ref[k])
        assert abs(t - j) <= BF16_EPS * j, (k, t, j)


# --- K1's bfloat16 source on the host -------------------------------------------------

def test_k1_bfloat16_table_matches_plain(k1_host):  # noqa: F811
    """Every op of K1's table in bfloat16, one fused node, through the
    host build: the exact ops bit for bit against the plain version
    (torch's bfloat16 ops), the others within 1 bfloat16 ulp (the host's
    libm against torch's, each rounded once), on numpy's edges; numpy's
    floor division of bfloat16 is left to the plain version."""
    ins, outs, labels = cases.bf16_op_group()
    kern = fused_kernel.FusedElemwiseKernel(FusedElemwise(ins, outs).fgraph, "cpu")
    assert "k2_rbf(" in kern.unit and "__nv_bfloat16" in kern.unit
    assert not fused_kernel.emittable(tpt.int_div(ins[0], ins[1]).owner)
    lib = k1_host([kern])
    vals = [as_torch(v, "cpu") for v in cases.op_group_inputs("bfloat16", ins, 4099)]
    got, _ = _host_launch(lib, kern, vals)
    want = kern.plain(*vals)
    for label, g, w in zip(labels, got, want):
        assert g.dtype == w.dtype, label
        if g.dtype == torch.bool:
            assert torch.equal(g, w), label
            continue
        ulps = _ulps(to_numpy(g), to_numpy(w))
        exact = label in cases.BF16_EXACT_OPS
        assert int(ulps.max()) <= (0 if exact else 1), (label, int(ulps.max()))
        zero = w == 0
        assert torch.equal(torch.signbit(g[zero]), torch.signbit(w[zero])), label


@pytest.mark.parametrize("n,offset", [(8 * 300 + 5, 0), (8 * 300 + 5, 3), (7, 0)],
                         ids=["vectors_and_tail", "misaligned", "tail_only"])
def test_k1_bfloat16_vector_path(k1_host, n, offset):  # noqa: F811
    """A node of the MFU step's class (relu's gradient and the SGD update,
    all bfloat16): eight values a 16-byte vector, a tail, and a pointer
    off a 16-byte boundary (no vectors), bit for bit the plain version."""
    a, g, w = (tpt.tensor(k, dtype="bfloat16", shape=(None,)) for k in "agw")
    lr = np.asarray(1e-3, BF)
    out = [w - lr * tpt.switch(a >= 0, g, np.asarray(0, BF)), tpt.maximum(a, np.asarray(0, BF))]
    kern = fused_kernel.FusedElemwiseKernel(FusedElemwise([a, g, w], out).fgraph, "cpu")
    assert kern.vector == 8
    lib = k1_host([kern])
    vals = [as_torch(_bf16_values(n + offset, s), "cpu")[offset:] for s in (6, 7, 8)]
    got, _ = _host_launch(lib, kern, vals)
    for gv, wv in zip(got, kern.plain(*vals)):
        assert int(_ulps(to_numpy(gv), to_numpy(wv)).max()) == 0


def test_k1_bfloat16_host_value_in_its_pointer(k1_host):  # noqa: F811
    """A 0-d bfloat16 value from the host passed in its pointer's place
    (its 16 bits), as a ``mean`` passes its count; the layout is the
    card's (the kernel made for the ``meta`` device, as
    ``tests/test_torch_fused.py`` does)."""
    x = tpt.tensor("x", dtype="bfloat16", shape=(None,))
    s = tpt.tensor("s", dtype="bfloat16", shape=())
    kern = fused_kernel.FusedElemwiseKernel(FusedElemwise([x, s], [x / s]).fgraph, "cpu")
    xv = as_torch(_bf16_values(1000, 9), "cpu")
    sv = torch.tensor(3.0, dtype=torch.bfloat16)
    kern.device = torch.device("meta")
    lay = kern._layout([xv.to("meta"), sv])
    kern.device = torch.device("cpu")
    assert lay.classes[0] == [fused_kernel.CONTIG, fused_kernel.SCALAR]
    out = torch.empty(1000, dtype=torch.bfloat16)
    ptrs = kern._ptrs_t(xv.data_ptr(), fused_kernel._host_bits(sv), out.data_ptr())
    lib = k1_host([kern])
    assert getattr(lib, f"k1_{kern.key}")(ptrs, lay.ints, None) == 0
    assert int(_ulps(to_numpy(out), to_numpy(kern.plain(xv, sv)[0])).max()) == 0


def _scipy_bf16(name, args):
    return np.asarray(cases.scipy_special(name, [a.astype("float64") for a in args])).astype(
        "float32").astype(BF)


def test_k1_bfloat16_special_functions(k1_host):  # noqa: F811
    """Every special function of ``link/cuda/special.py`` as a one-node
    bfloat16 kernel: computed in double and rounded once, within 1
    bfloat16 ulp of float64 scipy rounded to bfloat16, or of the JAX
    package's own error where that is larger (its bfloat16 ops compute in
    bfloat16 or float32), with scipy's NaN and infinities; but ``ndtr``,
    ``ndtri`` and ``ndtri_exp``, which refuse bfloat16 in both packages."""
    names = [n for n in sorted(cases.SPECIAL_GRIDS) if n not in REFUSED]
    runs = []
    for name in names:
        node = cases.special_node(name, "bfloat16")
        args = cases.special_inputs(name, "bfloat16", 61, 7)
        fn = _one_node_k1(node.op, node, "cpu")
        runs.append((name, fn.k1, args))
    lib = k1_host([k for _, k, _ in runs])
    jax_worse = {}
    for name, kern, args in runs:
        got, _ = _host_launch(lib, kern, [as_torch(a, "cpu") for a in args])
        got = to_numpy(got[0])
        want = _scipy_bf16(name, args)
        ulps = _ulps(got, want)
        ok = ulps <= 1
        if not ok.all():
            jins = [jpt.tensor(f"a{k}", dtype="bfloat16", shape=(None,))
                    for k in range(len(args))]
            jf = jptt.function(jins, _jax_special(name, jins))
            jerr = _ulps(np.asarray(jf(*args)), want)
            jax_worse[name] = int(jerr[~ok].min())
            ok |= ulps <= jerr
        assert ok.all(), (name, int(ulps.max()))
    # where the port is off by more than an ulp, the JAX package is too
    assert all(v > 1 for v in jax_worse.values()), jax_worse


# jax.scipy.special's ndtr and ndtri take float32 and float64 only
REFUSED = ("ndtr", "ndtri", "ndtri_exp")


@pytest.mark.parametrize("name", REFUSED)
def test_bfloat16_special_refusals(name):
    """``ndtr``, ``ndtri`` and ``ndtri_exp`` of bfloat16 raise TypeError in
    both packages when the function is linked (the JAX package's
    ``jax.scipy.special`` lowering refuses the dtype)."""
    x = np.linspace(0.1, 0.9, 8).astype(BF)
    for pkg, ptt, pt in PKGS:
        v = pt.tensor("v", dtype="bfloat16", shape=(8,))
        out = getattr(pt, name)(v if name != "ndtri_exp" else -v)
        with pytest.raises(TypeError):
            ptt.function([v], out, **({"device": "cpu"} if pkg == "torch" else {}))(x)


def _jax_special(name, ins):
    """The JAX package's graph of a special function on inputs ``ins``
    (a constant operand where SPECIAL_GRIDS gives a float)."""
    grid = cases.SPECIAL_GRIDS[name]
    args, it = [], iter(ins)
    for g in grid:
        args.append(np.asarray(int(g) if name == "polygamma" else g) if isinstance(g, float)
                    else next(it))
    mod = jpt.special if name in ("xlogy", "xlog1py") else jpt
    return getattr(mod, name)(*args)


# --- K2's bfloat16 source on the host -------------------------------------------------

def _ewma(pt, ptt, n, device=None):
    x = pt.tensor("x", dtype="bfloat16", shape=(n,))
    tr, _ = ptt.scan(lambda xt, acc: np.asarray(0.98, BF) * acc + np.asarray(0.02, BF) * xt,
                     sequences=[x], outputs_info=[pt.constant(np.asarray(0.0, BF))])
    return x, tr


def test_k2_bfloat16_ewma(gxx):  # noqa: F811
    """benchsuite's EWMA scan in bfloat16 (n 1,024): eligible for K2 as for
    the JAX package's kernel, bit for bit its step loop, and the JAX
    package's values (its Pallas kernel in interpret mode)."""
    from pytensor_tpu.config import config as jconfig

    n = 1024
    xv = _bf16_values(n, 11, scale=1.0, edges=False)
    with tconfig.change_flags(scan__pallas=True):
        x, tr = _ewma(tpt, tptt, n)
        f = tptt.function([x], tr, device="cpu")
    (node,) = [nd for nd in f.fgraph.apply_nodes if type(nd.op).__name__ == "Scan"]
    assert scan_kernel_eligible(node.op, node)
    got, want = _emulated_vs_loop(gxx, f, [xv])
    assert got[0].dtype == torch.bfloat16
    assert int(_ulps(to_numpy(got[0]), to_numpy(want[0])).max()) == 0
    with jconfig.change_flags(scan__pallas=True):
        jx, jtr = _ewma(jpt, jptt, n)
        jf = jptt.function([jx], jtr)
    (jnode,) = [nd for nd in jf.maker.fgraph.apply_nodes if type(nd.op).__name__ == "Scan"]
    assert pallas_scan_eligible(jnode.op, jnode)
    assert int(_ulps(to_numpy(f(xv)), np.asarray(jf(xv))).max()) == 0


def test_k2_bfloat16_products_and_reductions(gxx):  # noqa: F811
    """A bfloat16 scan of a product (a 16 x 16 constant), a sum, a max, a
    cast to float32 and an increment, in K2 against its step loop: the
    element-wise ops bit for bit, the product and the sums (in float, in
    another order) within 1 bfloat16 ulp; its slots 2 bytes an element."""
    from pytensor_tpu_torch.link.cuda.scan_kernel import ScanKernelSource

    rng = np.random.default_rng(12)
    Wc = tpt.as_tensor_variable((rng.standard_normal((16, 16)) * 0.3).astype(BF))
    v0 = tpt.tensor("v0", dtype="bfloat16", shape=(16,))

    def step(v):
        h = tpt.tanh(tpt.dot(Wc, v))
        s = tpt.sum(h)
        m = tpt.max(h)
        return h * np.asarray(0.9, BF) + s * np.asarray(0.01, BF), tpt.cast(m, "float32") + s

    with tconfig.change_flags(scan__pallas=True):
        outs, _ = tptt.scan(step, outputs_info=[v0, None], n_steps=6)
        f = tptt.function([v0], list(outs), device="cpu")
    (node,) = [nd for nd in f.fgraph.apply_nodes if type(nd.op).__name__ == "Scan"]
    src = ScanKernelSource(node.op, node)
    assert "k2_rbf(" in src.source and "__nv_bfloat16* st0_buf" in src.source
    got, want = _emulated_vs_loop(gxx, f, [rng.standard_normal(16).astype(BF)])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        if g.dtype == torch.bfloat16:
            assert int(_ulps(to_numpy(g), to_numpy(w)).max()) <= 1
        else:
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=2 * BF16_EPS)


# --- sparse ------------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_bfloat16_sparse_matvec_refused_in_both(pkg):
    """A bfloat16 ``structured_dot`` of a scipy constant runs in neither
    package: scipy has no bfloat16 (the JAX package raises converting the
    constant, the port making its canonical CSR).  K4 has no bfloat16
    form, and the JAX package's bfloat16 branch of the routed matvec is
    unreachable."""
    rng = np.random.default_rng(0)
    A = sp.random(128, 128, density=0.3, format="csr", random_state=rng, dtype="float32")
    A = sp.csr_matrix((A.data.astype(BF), A.indices, A.indptr), shape=A.shape)
    ptt, pt, sps = ((jptt, jpt, jsparse) if pkg == "jax" else (tptt, tpt, tsparse))
    x = pt.tensor("x", dtype="bfloat16", shape=(128,))
    y = sps.structured_dot(sps.as_sparse_variable(A), x)
    assert y.type.dtype == "bfloat16"
    with warnings.catch_warnings(), pytest.raises(ValueError, match="does not support dtype "
                                                                   "bfloat16"):
        warnings.simplefilter("ignore")
        f = ptt.function([x], y, **({"device": "cpu"} if pkg == "torch" else {}))
        f(rng.standard_normal(128).astype(BF))


# --- the linker's cuBLAS setting ------------------------------------------------------------

def test_linked_call_turns_reduced_precision_reductions_off(monkeypatch):
    """A plan linked for a CUDA device runs with TF32 and cuBLAS's
    reduced-precision bfloat16 reductions off, and puts the caller's
    settings back (``Plan.execute``, here with the CUDA calls stubbed)."""
    seen = []
    libs = []
    monkeypatch.setattr(torch.backends.cuda, "preferred_linalg_library",
                        lambda lib=None: libs.append(lib) or "default")
    matmul = torch.backends.cuda.matmul
    monkeypatch.setattr(matmul, "allow_bf16_reduced_precision_reduction", True)
    monkeypatch.setattr(matmul, "allow_tf32", True)
    x = tpt.tensor("x", dtype="bfloat16", shape=(4, 4))
    f = tptt.function([x], tpt.dot(x, x), device="cpu")
    plan = f.linked
    plan.device = torch.device("cuda")
    monkeypatch.setattr(plan, "run", lambda args: seen.append(
        (matmul.allow_bf16_reduced_precision_reduction, matmul.allow_tf32)) or ())
    plan.execute([torch.ones(4, 4, dtype=torch.bfloat16)])
    assert seen == [(False, False)]
    assert matmul.allow_bf16_reduced_precision_reduction and matmul.allow_tf32
    assert libs[0] is None and libs[1] == "cusolver" and libs[-1] == "default"
    monkeypatch.setattr(plan, "run", lambda args: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        plan.execute([torch.ones(4, 4, dtype=torch.bfloat16)])
    assert matmul.allow_bf16_reduced_precision_reduction and matmul.allow_tf32

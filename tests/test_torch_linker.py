"""The port's linker on the CPU: free lists, the capture rule, the
``xla__jit`` flag.

``fgraph_to_torch`` frees each intermediate after its last reader by free
lists made at link time (the oracle linker's rule,
``pytensor_tpu/link/basic.py:131-151``); the radon and sparse functions
still match the JAX package with them, at the tolerances of
``tests/test_torch_radon.py`` (float64 ``rtol 1e-10``; float32 ``rtol
1e-4``, ``atol 1e-4 * max|dlogp|``) and ``tests/test_torch_sparse.py``
(the power iteration ``rtol 2e-4``, ``atol 2e-5``).  The capture rule
decides at link time, from the plan, whether a CUDA graph may hold it;
the captures themselves run on the card (``tests/test_torch_cuda.py``).
"""

import functools
import weakref

import numpy as np
import pytest
import scipy.sparse as sp

import pytensor_tpu as jptt
import pytensor_tpu.models.radon as jradon
import pytensor_tpu.tensor as jpt
from pytensor_tpu import sparse as jsparse
from pytensor_tpu.compile.mode import FAST_RUN as J_FAST_RUN
from pytensor_tpu.config import config as jconfig
from pytensor_tpu.graph.fg import FunctionGraph as JFunctionGraph
from pytensor_tpu.link.xla.linker import fgraph_to_jax

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.models.radon as tradon
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch import sparse as tsparse
from pytensor_tpu_torch.compile.mode import FAST_RUN as T_FAST_RUN
from pytensor_tpu_torch.config import config as tconfig
from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.graph.fg import FunctionGraph as TFunctionGraph
from pytensor_tpu_torch.link.torch import linker
from pytensor_tpu_torch.link.torch.linker import Plan, TorchLinker, fgraph_to_torch
from pytensor_tpu_torch.scan.op import Scan as TScan
from pytensor_tpu_torch.tensor.basic import stack

N_OBS, N_COUNTIES, N_CHAINS = 919, 85, 8
RADON = [(dtype, batched) for dtype in ("float32", "float64") for batched in (False, True)]
RADON_IDS = [f"{d}-{'batched' if b else 'single'}" for d, b in RADON]


def _radon_graphs(pkg_radon, dtype, batched):
    if batched:
        theta, logp, dlogp, n = pkg_radon.make_radon_logp_batched(N_OBS, N_COUNTIES, dtype)
        return [theta], [logp, dlogp], n
    return pkg_radon.make_radon_graphs(N_OBS, N_COUNTIES, dtype)


@functools.lru_cache(maxsize=None)
def _radon_plan(dtype, batched):
    inputs, outputs, n = _radon_graphs(tradon, dtype, batched)
    fg = TFunctionGraph(inputs, outputs, clone=True)
    T_FAST_RUN.optimizer.rewrite(fg)
    return fgraph_to_torch(fg, "cpu"), n


def _expected_free_lists(plan):
    """The free lists by their definition: each variable a node reads that
    is no input, constant or output, at the last node that reads it."""
    fg = plan.fgraph
    order = [node for _, node, _, _ in plan.steps]
    keep = set(fg.inputs) | set(fg.outputs)
    last = {}
    for k, node in enumerate(order):
        for i in node.inputs:
            if not isinstance(i, Constant) and i not in keep:
                last[i] = k
    return [{v for v, k in last.items() if k == j} for j in range(len(order))]


# --- free lists -----------------------------------------------------------------------

def test_an_intermediate_is_released_after_its_last_reader():
    x = tpt.tensor("x", dtype="float64", shape=(5,))
    a = tpt.exp(x)
    b = a * 2.0
    d = b + x
    e = tpt.sqr(d)
    plan = fgraph_to_torch(TFunctionGraph([x], [e, b], clone=False), "cpu")
    at = {node: k for k, (_, node, _, _) in enumerate(plan.steps)}
    free = {at[node]: set(f) for k, (_, node, _, f) in enumerate(plan.steps)}
    assert free[at[b.owner]] == {a} and free[at[e.owner]] == {d}
    held = set().union(*free.values())
    # the input, the constant's broadcast, the outputs (b is read by d) stay
    assert not held & {x, b, e}

    refs = {}
    steps = list(plan.steps)

    def produce(fn):
        def wrapped(*args):
            out = fn(*args)
            refs["a"] = weakref.ref(out)
            return out
        return wrapped

    def after(fn):
        def wrapped(*args):
            refs["dead when d is computed"] = refs["a"]() is None
            return fn(*args)
        return wrapped

    for k, (fn, node, spec, f) in enumerate(steps):
        if node is a.owner:
            steps[k] = (produce(fn), node, spec, f)
        elif node is d.owner:
            steps[k] = (after(fn), node, spec, f)
    plan.steps = steps
    xv = np.linspace(-1.0, 1.0, 5)
    got_e, got_b = plan(xv)
    assert refs["dead when d is computed"]
    np.testing.assert_allclose(got_b.numpy(), 2 * np.exp(xv), rtol=1e-15)
    np.testing.assert_allclose(got_e.numpy(), (2 * np.exp(xv) + xv) ** 2, rtol=1e-15)


@pytest.mark.parametrize("dtype,batched", RADON, ids=RADON_IDS)
def test_radon_free_lists_hold_each_intermediate_at_its_last_reader(dtype, batched):
    plan, _ = _radon_plan(dtype, batched)
    got = [set(f) for f in plan.free_lists]
    assert got == _expected_free_lists(plan)
    assert all(len(f) == len(set(f)) for f in plan.free_lists)
    freed = set().union(*got)
    assert freed and not freed & (set(plan.fgraph.inputs) | set(plan.fgraph.outputs))
    assert not any(isinstance(v, Constant) for v in freed)


@pytest.mark.parametrize("dtype,batched", [("float32", False), ("float64", True)],
                         ids=["float32-single", "float64-batched"])
def test_radon_with_free_lists_matches_jax(dtype, batched):
    ji, jo, n = _radon_graphs(jradon, dtype, batched)
    jfg = JFunctionGraph(ji, jo, clone=True)
    J_FAST_RUN.optimizer.rewrite(jfg)
    plan, _ = _radon_plan(dtype, batched)
    assert any(plan.free_lists)
    rng = np.random.default_rng(0)
    theta = tradon.theta_start(n, dtype)
    if batched:
        theta = np.tile(theta, (N_CHAINS, 1))
    theta = (theta + 0.2 * rng.standard_normal(theta.shape)).astype(dtype)
    want = [np.asarray(v) for v in fgraph_to_jax(jfg)(theta)]
    got = [v.numpy() for v in plan(theta)]
    rtol, atol_scale = (1e-10, 0.0) if dtype == "float64" else (1e-4, 1e-4)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_allclose(g, w, rtol=rtol, atol=atol_scale * np.abs(want[1]).max())


def _power_iteration(ptt, pt, sparse, A, x0, n_steps, **kw):
    xsh = ptt.shared(x0.copy(), name="x", **kw)
    y = sparse.structured_dot(sparse.as_sparse_variable(A), xsh)
    g = ptt.train_loop([], pt.sum(y), {xsh: y / (pt.max(pt.abs(y)) + 1e-9)},
                       n_steps=n_steps, **kw)
    return g, xsh


def test_power_iteration_with_free_lists_matches_jax():
    rng = np.random.default_rng(13)
    A = sp.random(1500, 1500, density=0.005, format="csr", random_state=rng, dtype="float32")
    x0 = rng.standard_normal((1500, 1)).astype("float32")
    jg, jx = _power_iteration(jptt, jpt, jsparse, A, x0, 3)
    tg, tx = _power_iteration(tptt, tpt, tsparse, A, x0, 3, device="cpu")
    scan_fn = next(fn for fn, node, _, _ in tg.linked.steps if isinstance(node.op, TScan))
    assert any(scan_fn.inner.free_lists)
    j_out, t_out = float(np.asarray(jg())), float(tg())
    np.testing.assert_allclose(t_out, j_out, rtol=2e-4)
    np.testing.assert_allclose(tx.get_value().numpy(), np.asarray(jx.get_value()), atol=2e-5)


# --- the capture rule -------------------------------------------------------------------

def _sparse_gradient():
    rng = np.random.default_rng(8)
    A = sp.random(1500, 1500, density=0.005, format="csr", random_state=rng, dtype="float32")
    x = tpt.tensor("x", dtype="float32", shape=(1500,))
    cost = tpt.sum(tsparse.structured_dot(tsparse.as_sparse_variable(A), x) ** 2)
    return tptt.function([x], [cost, tptt.grad(cost, x)], device="cpu").linked


def _power():
    rng = np.random.default_rng(13)
    A = sp.random(1500, 1500, density=0.005, format="csr", random_state=rng, dtype="float32")
    x0 = rng.standard_normal((1500, 1)).astype("float32")
    return _power_iteration(tptt, tpt, tsparse, A, x0, 64, device="cpu")[0].linked


CAPTURABLE = {
    **{f"radon-{i}": (lambda c=c: _radon_plan(*c)[0]) for i, c in zip(RADON_IDS, RADON)},
    "leapfrog-chain-single": lambda: tradon.make_leapfrog_chain(
        "float32", None, 8, 40, 5, device="cpu").linked,
    "leapfrog-chain-batched": lambda: tradon.make_leapfrog_chain(
        "float32", 4, 8, 40, 5, device="cpu").linked,
    "sparse-gradient": _sparse_gradient,
    "power-iteration": _power,
}


@pytest.mark.parametrize("case", sorted(CAPTURABLE))
def test_the_main_path_is_capturable(case):
    plan = CAPTURABLE[case]()
    assert isinstance(plan, Plan)
    assert plan.capturable and plan.host_reads == []


def _v():
    return tpt.tensor("v", dtype="float32", shape=(None,))


def _dynamic_index():
    v, i = _v(), tpt.tensor("i", dtype="int64", shape=(None,))
    return [v, i], v[i], "the bounds check of index input 1 reads its min and max on the host"


def _reshape_by_input():
    v, s = _v(), tpt.tensor("s", dtype="int64", shape=(2,))
    return [v, s], v.reshape(s), "input 1 is read on the host and lives on the device"


def _slice_by_input():
    v, k = _v(), tpt.tensor("k", dtype="int64", shape=())
    return [v, k], v[:k] * 2.0, "input 1 is read on the host and lives on the device"


def _host_value_to_device():
    v = _v()
    # Shape_i is a host value; MakeVector copies it beside a device value
    return [v], stack([v.shape[0].astype("float32"), v.sum()]), \
        "is a host value copied to the device"


REFUSED = {"dynamic-AdvancedSubtensor1-index": _dynamic_index,
           "Reshape-by-an-explicit-input": _reshape_by_input,
           "Subtensor-bound-by-an-explicit-input": _slice_by_input,
           "MakeVector-of-a-host-and-a-device-value": _host_value_to_device}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_a_host_read_is_not_capturable(case):
    inputs, out, reason = REFUSED[case]()
    if case.startswith("MakeVector"):
        plan = fgraph_to_torch(TFunctionGraph(inputs, [out], clone=False), "cpu")
    else:
        plan = tptt.function(inputs, out, device="cpu").linked
    assert not plan.capturable
    assert len(plan.host_reads) == 1 and reason in plan.host_reads[0]


def test_shape_arithmetic_stays_capturable():
    """A reshape and a slice bound computed from the input's shape are host
    values: no read of the device."""
    v = tpt.tensor("v", dtype="float32", shape=(None,))
    n = v.shape[0]
    f = tptt.function([v], [v.reshape((n, 1)), v[: n - 1]], device="cpu")
    assert f.linked.capturable
    out, head = f(np.arange(6, dtype="float32"))
    assert out.shape == (6, 1) and head.numpy().tolist() == [0, 1, 2, 3, 4]


def test_the_uncapturable_plan_still_raises_on_an_index_out_of_bounds():
    inputs, out, _ = _dynamic_index()
    f = tptt.function(inputs, out, device="cpu")
    v = np.arange(4, dtype="float32")
    assert f(v, np.array([3, -4])).numpy().tolist() == [3.0, 0.0]
    with pytest.raises(IndexError, match="out of bounds"):
        f(v, np.array([0, 4]))


def test_the_scan_step_loop_carries_its_inner_plans_reads():
    v = tpt.tensor("v", dtype="float32", shape=(None,))
    i = tpt.tensor("i", dtype="int64", shape=(None,))
    res, _ = tptt.scan(lambda s: s[i] + 1.0, outputs_info=[v], n_steps=3)
    plan = tptt.function([v, i], res[-1], device="cpu").linked
    assert len(plan.host_reads) == 1 and ", a step: " in plan.host_reads[0]


# --- xla__jit -------------------------------------------------------------------------

def test_xla__jit_is_the_jax_packages_flag():
    assert tconfig.xla__jit is True
    assert tconfig._params["xla__jit"].default == jconfig._params["xla__jit"].default is True


def test_the_flag_off_gives_the_eager_values():
    x = tpt.tensor("x", dtype="float32", shape=(None,))
    outs = []
    for jit in (True, False):
        with tconfig.change_flags(xla__jit=jit):
            f = tptt.function([x], [tpt.exp(x).sum(), x * 2.0], device="cpu")
        # the CPU has no CUDA graph: both are the eager plan
        assert isinstance(f.linked, Plan)
        outs.append([o.numpy() for o in f(np.arange(5, dtype="float32"))])
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a, b)
    fg = TFunctionGraph([x], [x + 1.0], clone=True)
    assert isinstance(TorchLinker.make_torch_fn(fg, "cpu"), Plan)


def test_nodes_run_counts_a_step_loops_inner_nodes():
    v = tpt.tensor("v", dtype="float32", shape=(None,))
    res, _ = tptt.scan(lambda s: s * 2.0 + 1.0, outputs_info=[v], n_steps=4)
    f = tptt.function([v], res[-1], device="cpu")
    scan_fn = next(fn for fn, node, _, _ in f.linked.steps if isinstance(node.op, TScan))
    linker.NODES_RUN = 0
    out = f(np.ones(3, dtype="float32"))
    assert linker.NODES_RUN == len(f.linked.steps) + 4 * len(scan_fn.inner.steps)
    assert out.numpy().tolist() == [31.0, 31.0, 31.0]


def test_a_blockwise_checks_a_constant_index_when_linked():
    """A ``Blockwise{AdvancedSubtensor1}`` whose index is a constant with
    batch dimensions of 1 (the radon model's ``a[county]`` vectorized over
    a trajectory, in the multinomial HMC step) checks the index when it is
    linked, as the capture rule takes a constant to be: its core lowering
    sees the constant, and no call reads the index on the host."""
    import pytensor_tpu_torch as ptt
    import pytensor_tpu_torch.tensor as pt
    from pytensor_tpu_torch.graph.basic import Constant
    from pytensor_tpu_torch.link.torch import dispatch
    from pytensor_tpu_torch.tensor.blockwise import Blockwise
    from pytensor_tpu_torch.tensor.subtensor import AdvancedSubtensor1

    x = pt.tensor("x", dtype="float32", shape=(4, 6))
    idx = pt.as_tensor_variable(np.array([[0, 5, 2, 2, -1]]))
    out = Blockwise(AdvancedSubtensor1(), signature="(n),(k)->(k)")(x, idx)
    f = ptt.function([x], out, device="cpu")
    (node,) = [n for n in f.fgraph.toposort() if isinstance(n.op, Blockwise)]
    assert isinstance(dispatch._core_node(node).inputs[1], Constant)
    assert f.linked.host_reads == []
    reads = []
    orig = dispatch._IndexCheck.bounds
    dispatch._IndexCheck.bounds = lambda self, i: reads.append(self.const) or orig(self, i)
    try:
        xv = np.arange(24, dtype="float32").reshape(4, 6)
        got = f(xv).numpy()
    finally:
        dispatch._IndexCheck.bounds = orig
    assert reads and all(reads)
    np.testing.assert_array_equal(got, xv[:, [0, 5, 2, 2, -1]])

"""The torch port's radon slice against the JAX package, on the CPU.

The same seeded numpy inputs go through ``pytensor_tpu`` (FAST_RUN, then
``fgraph_to_jax``) and ``pytensor_tpu_torch`` (FAST_RUN, then
``fgraph_to_torch`` on the CPU) at full width: 919 observations, 85
counties.  Tolerances: float64 ``rtol 1e-10``; float32 ``rtol 1e-4`` with
an ``atol`` of ``1e-4 * max|dlogp|``, because some gradient entries are
near zero and the two packages sum in different orders.
"""

import collections

import numpy as np
import pytest
import torch

import pytensor_tpu.models.radon as jradon
from pytensor_tpu.compile.mode import FAST_RUN as J_FAST_RUN
from pytensor_tpu.graph.fg import FunctionGraph as JFunctionGraph
from pytensor_tpu.link.xla.linker import fgraph_to_jax

import pytensor_tpu_torch.models.radon as tradon
from pytensor_tpu_torch.compile.mode import FAST_RUN as T_FAST_RUN
from pytensor_tpu_torch.graph.fg import FunctionGraph as TFunctionGraph
from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch

N_OBS, N_COUNTIES, N_CHAINS = 919, 85, 8
TOL = {"float64": dict(rtol=1e-10, atol_scale=0.0), "float32": dict(rtol=1e-4, atol_scale=1e-4)}


def _graphs(pkg_radon, dtype, batched):
    if batched:
        theta, logp, dlogp, n = pkg_radon.make_radon_logp_batched(N_OBS, N_COUNTIES, dtype)
        return [theta], [logp, dlogp], n
    return pkg_radon.make_radon_graphs(N_OBS, N_COUNTIES, dtype)


def _linked(dtype, batched):
    """(jax fgraph, jax fn, torch fgraph, torch fn, n_params)."""
    ji, jo, n = _graphs(jradon, dtype, batched)
    jfg = JFunctionGraph(ji, jo, clone=True)
    J_FAST_RUN.optimizer.rewrite(jfg)
    jfn = fgraph_to_jax(jfg)
    ti, to, _ = _graphs(tradon, dtype, batched)
    tfg = TFunctionGraph(ti, to, clone=True)
    T_FAST_RUN.optimizer.rewrite(tfg)
    tfn = fgraph_to_torch(tfg, "cpu")
    return jfg, (lambda *a: [np.asarray(v) for v in jfn(*a)]), tfg, \
        (lambda *a: [v.numpy() for v in tfn(*a)]), n


def _theta(n, dtype, batched, seed=0):
    rng = np.random.default_rng(seed)
    th = tradon.theta_start(n, dtype)
    if batched:
        th = np.tile(th, (N_CHAINS, 1))
    return (th + 0.2 * rng.standard_normal(th.shape)).astype(dtype)


def _op_counts(fg):
    return collections.Counter(type(nd.op).__name__ for nd in fg.apply_nodes)


@pytest.fixture(scope="module")
def linked():
    cache = {}

    def get(dtype, batched):
        if (dtype, batched) not in cache:
            cache[dtype, batched] = _linked(dtype, batched)
        return cache[dtype, batched]

    return get


def test_synthetic_data_is_bitwise_the_same():
    for dtype in ("float32", "float64"):
        for a, b in zip(jradon.radon_synthetic_data(N_OBS, N_COUNTIES, 0, dtype),
                        tradon.radon_synthetic_data(N_OBS, N_COUNTIES, 0, dtype)):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_logp_dlogp_match_jax(linked, dtype, batched):
    _, jfn, _, tfn, n = linked(dtype, batched)
    theta = _theta(n, dtype, batched)
    (jlp, jg), (tlp, tg) = jfn(theta), tfn(theta)
    assert tlp.dtype == jlp.dtype == np.dtype(dtype) and tg.dtype == jg.dtype
    assert tlp.shape == jlp.shape and tg.shape == jg.shape == theta.shape
    tol = TOL[dtype]
    np.testing.assert_allclose(tlp, jlp, rtol=tol["rtol"])
    np.testing.assert_allclose(tg, jg, rtol=tol["rtol"],
                               atol=tol["atol_scale"] * np.max(np.abs(jg)))


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_rewritten_graph_op_counts_match_jax(linked, dtype, batched):
    jfg, _, tfg, _, _ = linked(dtype, batched)
    assert _op_counts(tfg) == _op_counts(jfg)


def test_matches_float64_closed_form(linked):
    _, _, _, tfn, n = linked("float64", False)
    theta = _theta(n, "float64", False, seed=3)
    lp, g = tfn(theta)
    rlp, rg = tradon.radon_logp_dlogp_reference(theta, N_OBS, N_COUNTIES)
    np.testing.assert_allclose(lp, rlp, rtol=1e-10)
    np.testing.assert_allclose(g, rg, rtol=1e-10, atol=1e-10 * np.max(np.abs(rg)))


def test_leapfrog_matches_jax_loop(linked):
    """Eight leapfrog() steps over the linked port function against the
    same host loop over the JAX package's linked function (float64)."""
    _, jfn, _, tfn, n = linked("float64", False)
    theta = _theta(n, "float64", False, seed=1)
    m = np.random.default_rng(2).standard_normal(n)
    eps = 1e-3
    t_theta, t_m, t_lp = tradon.leapfrog(
        lambda th: [torch.from_numpy(v) for v in tfn(th.numpy())],
        torch.from_numpy(theta), torch.from_numpy(m), 8, eps)
    j_theta, j_m = theta.copy(), m.copy()
    j_lp, g = jfn(j_theta)
    for _ in range(8):
        j_m = j_m + eps / 2 * g
        j_theta = j_theta + eps * j_m
        j_lp, g = jfn(j_theta)
        j_m = j_m + eps / 2 * g
    np.testing.assert_allclose(t_theta.numpy(), j_theta, rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(t_m.numpy(), j_m, rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(float(t_lp), float(j_lp), rtol=1e-10)


def test_entry_matches_graft_entry():
    import __graft_entry__

    from pytensor_tpu_torch.entry import entry

    jfn, (jtheta0,) = __graft_entry__.entry()
    tfn, (ttheta0,) = entry("cpu")
    assert isinstance(ttheta0, torch.Tensor) and ttheta0.dtype == torch.float32
    np.testing.assert_array_equal(ttheta0.numpy(), jtheta0)
    theta = _theta(ttheta0.shape[0], "float32", False, seed=4)
    jlp, jg = (np.asarray(v) for v in jfn(theta))
    tlp, tg = tfn(torch.from_numpy(theta))
    np.testing.assert_allclose(tlp.numpy(), jlp, rtol=1e-4)
    np.testing.assert_allclose(tg.numpy(), jg, rtol=1e-4, atol=1e-4 * np.max(np.abs(jg)))


def test_linked_function_keeps_constants_dtypes():
    """Constants reach the device once, with their dtype: the county index
    stays int64 and the float64 data stays float64."""
    inputs, outputs, n = tradon.make_radon_graphs(120, 11, "float64")
    fg = TFunctionGraph(inputs, outputs, clone=True)
    T_FAST_RUN.optimizer.rewrite(fg)
    dtypes = {str(c.type.dtype) for nd in fg.apply_nodes for c in nd.inputs
              if hasattr(c, "data") and np.ndim(c.data) == 1}
    assert {"int64", "float64"} <= dtypes
    lp, g = fgraph_to_torch(fg, "cpu")(tradon.theta_start(n))
    assert lp.dtype == g.dtype == torch.float64


def test_cuda_device_raises_without_a_card():
    from pytensor_tpu_torch.entry import entry

    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the no-card error path does not apply")
    with pytest.raises(RuntimeError, match="cuda"):
        entry("cuda")
    # the entry points run on the card unless the caller asks for the CPU
    with pytest.raises(RuntimeError, match="cuda"):
        entry()
    with pytest.raises(RuntimeError, match="cuda"):
        tradon.make_leapfrog_chain("float32", None, 2, 10, 3)


# --- the leapfrog chain through scan + function() --------------------------------

CHAIN_OBS, CHAIN_COUNTIES, CHAIN_STEPS = 40, 5, 8


@pytest.fixture(scope="module")
def chains():
    """The chain of ``bench.py:40 build_ours`` at 40 observations, 5
    counties and 8 steps, float32: the JAX package's with ``scan__pallas``
    and ``onehot_gather`` (its Pallas kernel in interpret mode), and the
    port's ``make_leapfrog_chain`` on the CPU."""
    import bench

    saved = (bench.N_OBS, bench.N_COUNTIES, bench.LEAPFROG_STEPS)
    bench.N_OBS, bench.N_COUNTIES, bench.LEAPFROG_STEPS = CHAIN_OBS, CHAIN_COUNTIES, CHAIN_STEPS
    try:
        jf, n, _ = bench.build_ours("float32", None)
    finally:
        bench.N_OBS, bench.N_COUNTIES, bench.LEAPFROG_STEPS = saved
    tf = tradon.make_leapfrog_chain("float32", None, CHAIN_STEPS, CHAIN_OBS, CHAIN_COUNTIES,
                                    device="cpu")
    th = tradon.theta_start(n, "float32")
    m = np.random.default_rng(0).standard_normal(n).astype("float32")
    return jf, tf, th, m


def _scan_node(fg):
    (node,) = [nd for nd in fg.apply_nodes if type(nd.op).__name__ == "Scan"]
    return node


def test_leapfrog_chain_matches_jax_kernel(chains):
    """Final theta, m and logp within ``rtol 1e-5`` (``atol 1e-6`` for the
    near-zero entries of theta): two float32 chains of 8 steps that sum
    in other orders."""
    jf, tf, th, m = chains
    j_out = [np.asarray(v) for v in jf(th, m)]
    t_out = [v.numpy() for v in tf(torch.from_numpy(th), torch.from_numpy(m))]
    for a, b in zip(t_out, j_out):
        assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_leapfrog_chain_graphs_match_jax(chains):
    """The rewritten outer graph and the Scan's inner graph hold the same
    ops by type and count in both packages, and both packages find the
    scan eligible for the whole-loop kernel."""
    from pytensor_tpu.link.pallas.scan_pallas import pallas_scan_eligible

    from pytensor_tpu_torch.link.cuda.scan_kernel import scan_kernel_eligible

    jf, tf, _, _ = chains
    assert _op_counts(tf.fgraph) == _op_counts(jf.fgraph)
    jn, tn = _scan_node(jf.fgraph), _scan_node(tf.fgraph)
    assert _op_counts(tn.op.fgraph) == _op_counts(jn.op.fgraph)
    assert (tn.op.info.n_untraced, tn.op.info.n_non_seqs) == (jn.op.info.n_untraced,
                                                             jn.op.info.n_non_seqs)
    assert pallas_scan_eligible(jn.op, jn) and scan_kernel_eligible(tn.op, tn)


def test_batched_chain_matches_jax_loop():
    """The batched chain (8 chains, 4 steps) takes the step loop in the
    port and lax.scan in the JAX package; logp is the sum over chains."""
    import bench

    saved = (bench.N_OBS, bench.N_COUNTIES, bench.LEAPFROG_STEPS)
    bench.N_OBS, bench.N_COUNTIES, bench.LEAPFROG_STEPS = CHAIN_OBS, CHAIN_COUNTIES, 8
    try:
        jf, n, steps = bench.build_ours("float32", 8)
    finally:
        bench.N_OBS, bench.N_COUNTIES, bench.LEAPFROG_STEPS = saved
    tf = tradon.make_leapfrog_chain("float32", 8, steps, CHAIN_OBS, CHAIN_COUNTIES, device="cpu")
    rng = np.random.default_rng(1)
    th = (np.tile(tradon.theta_start(n, "float32"), (8, 1))
          + 0.1 * rng.standard_normal((8, n))).astype("float32")
    m = rng.standard_normal((8, n)).astype("float32")
    j_out = [np.asarray(v) for v in jf(th, m)]
    t_out = [v.numpy() for v in tf(torch.from_numpy(th), torch.from_numpy(m))]
    for a, b in zip(t_out, j_out):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)

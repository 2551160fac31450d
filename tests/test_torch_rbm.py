"""The RBM Gibbs chain (``models/rbm.py``) against the JAX package's, on
the CPU.

At the JAX package's own sizes (``tests/test_ref_scan2.py:764``: 20
visible and 30 hidden units, 3 chains, 10 steps, its weights from
``default_rng(41)``): the same draws over three calls (each advancing the
stream's keys), the same rewritten graph op for op (the outer graph and
the scan's inner graph), no host read in the linked plan (so on a card a
call is one captured CUDA graph), and K2 refusing the scan in both
packages (a RandomVariable is on neither white list).  Then ``rbm_weights``'
full-width weights (``rbm.py``'s 784 x 500, 20 chains) and two steps of
the chain at that width: {0, 1} draws of the right shape, the same from the
same keys.
"""

import numpy as np
import pytest

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
from pytensor_tpu.link.pallas.scan_pallas import pallas_scan_eligible
from pytensor_tpu.scan import scan as jscan
from pytensor_tpu.tensor.math import dot as jdot
from pytensor_tpu.tensor.math import sigmoid as jsigmoid
from pytensor_tpu.tensor.random import RandomStream as JRandomStream
from pytensor_tpu_torch.link.cuda.scan_kernel import scan_kernel_eligible
from pytensor_tpu_torch.models.rbm import (
    N_CHAINS,
    N_HIDDEN,
    N_VISIBLE,
    make_gibbs_chain,
    rbm_weights,
)


def _jax_test_weights():
    lrng = np.random.default_rng(41)
    v_W = (lrng.random((20, 30)) - 0.5).astype("float32")
    v_vsample = lrng.binomial(1, 0.5, size=(3, 20)).astype("float32")
    v_bvis = (lrng.random(20) - 0.5).astype("float32")
    v_bhid = (lrng.random(30) - 0.5).astype("float32")
    return v_W, v_bhid, v_bvis, v_vsample


def _jax_chain(v_W, v_bhid, v_bvis, n_steps=10, seed=99):
    """The JAX package's test_gibbs_chain graph, as that test builds it."""
    W = jptt.shared(v_W, "vW")
    bhid = jptt.shared(v_bhid, "vbhid")
    bvis = jptt.shared(v_bvis, "vbvis")
    vsample = jpt.matrix(dtype="float32")
    trng = JRandomStream(seed)

    def fstep(vsample_tm1):
        hmean_t = jsigmoid(jdot(vsample_tm1, W) + bhid)
        hsample_t = jpt.cast(trng.binomial(1, hmean_t, size=hmean_t.shape), dtype="float32")
        vmean_t = jsigmoid(jdot(hsample_t, W.T) + bvis)
        return jpt.cast(trng.binomial(1, vmean_t, size=vmean_t.shape), dtype="float32")

    samples, updates = jscan(fstep, [], vsample, [], n_steps=n_steps)
    return jptt.function([vsample], samples[-1], updates=updates)


def _ops(fgraph):
    return [type(nd.op).__name__ for nd in fgraph.toposort()]


def _scan(fgraph):
    return next(nd for nd in fgraph.toposort() if type(nd.op).__name__ == "Scan")


@pytest.fixture(scope="module")
def chains():
    v_W, v_bhid, v_bvis, v0 = _jax_test_weights()
    fj = _jax_chain(v_W, v_bhid, v_bvis)
    ft, _ = make_gibbs_chain(v_W, v_bhid, v_bvis, n_steps=10, device="cpu")
    return fj, ft, v0


def test_gibbs_chain_draws_equal_the_jax_package(chains):
    fj, ft, v0 = chains
    for _ in range(3):
        want = np.asarray(fj(v0))
        got = ft(v0).numpy()
        assert got.shape == (3, 20) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert set(np.unique(got)) <= {0.0, 1.0}


def test_gibbs_chain_graph_op_for_op(chains):
    fj, ft, _ = chains
    jfg, tfg = fj.maker.fgraph, ft.fgraph
    assert _ops(tfg) == _ops(jfg)
    jnode, tnode = _scan(jfg), _scan(tfg)
    assert _ops(tnode.op.fgraph) == _ops(jnode.op.fgraph)
    assert "BinomialRV" in _ops(tnode.op.fgraph)


def test_gibbs_chain_capturable_and_refused_by_k2(chains):
    fj, ft, _ = chains
    assert ft.linked.host_reads == []
    jnode, tnode = _scan(fj.maker.fgraph), _scan(ft.fgraph)
    assert not pallas_scan_eligible(jnode.op, jnode)
    assert not scan_kernel_eligible(tnode.op, tnode)


def test_gibbs_chain_at_full_width():
    W, bhid, bvis, v0 = rbm_weights()
    bound = 4 * np.sqrt(6.0 / (N_HIDDEN + N_VISIBLE))
    assert W.shape == (N_VISIBLE, N_HIDDEN) and v0.shape == (N_CHAINS, N_VISIBLE)
    assert np.abs(W).max() <= bound and not bhid.any() and not bvis.any()
    assert set(np.unique(v0)) == {0.0, 1.0}
    outs = []
    for _ in range(2):
        f, _ = make_gibbs_chain(W, bhid, bvis, n_steps=2, device="cpu")
        outs.append(f(v0).numpy())
    assert outs[0].shape == (N_CHAINS, N_VISIBLE) and set(np.unique(outs[0])) <= {0.0, 1.0}
    np.testing.assert_array_equal(outs[0], outs[1])

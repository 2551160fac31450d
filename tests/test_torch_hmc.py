"""The port's HMC transitions (``models/hmc.py``) against the JAX package's,
on the CPU.

At 50 observations, 6 counties and 6 leapfrog steps, for float32 and
float64: ``make_radon_hmc`` (one chain), ``make_radon_hmc_chains`` (4
chains) and ``make_radon_multinomial_hmc``, each started from the JAX
package's keys (its shared keys' values carried into the port's with
``set_value``) and the same zero position, and run for 5 transitions.
The accept flags and the multinomial indices must be equal; ``logp`` and
the positions agree within 2e-4 relative in float32 (a float32 leapfrog
rounds differently in the two packages) and 1e-9 in float64 (the
multinomial step through ``make_multinomial_hmc_step``: the JAX package's
``make_radon_multinomial_hmc`` refuses float64, and so does the port's).
The float32 functions are linked with ``scan__pallas`` on: the rewritten
graphs hold the same draws and scans, and K2 refuses the leapfrog scans
in both packages (the position's static shape is unknown).  The entry
points run on the card unless asked for the CPU.
"""

import numpy as np
import pytest
import torch

import pytensor_tpu.models.hmc as jhmc
import pytensor_tpu.models.radon as jradon
import pytensor_tpu_torch.models.hmc as thmc
import pytensor_tpu_torch.models.radon as tradon
from pytensor_tpu.config import config as jconfig
from pytensor_tpu.link.pallas.scan_pallas import pallas_scan_eligible
from pytensor_tpu.tensor.random.type import RandomGeneratorType as JKey
from pytensor_tpu_torch.config import config as tconfig
from pytensor_tpu_torch.link.cuda.scan_kernel import scan_kernel_eligible
from pytensor_tpu_torch.tensor.random.type import RandomGeneratorType as TKey

SMALL = dict(n_obs=50, n_counties=6, n_leapfrog=6)
ENTRIES = {
    "make_radon_hmc": SMALL,
    "make_radon_hmc_chains": dict(SMALL, n_chains=4),
    "make_radon_multinomial_hmc": SMALL,
}
TOL = {"float32": 2e-4, "float64": 1e-9}


def _build(entry, dtype, pallas=False):
    if entry == "make_multinomial_hmc_step":
        args, kw = _radon_logp, dict(n_leapfrog=SMALL["n_leapfrog"], dtype=dtype)
    else:
        args, kw = (), dict(ENTRIES[entry], dtype=dtype)
    with jconfig.change_flags(scan__pallas=pallas):
        jf, jpos = getattr(jhmc, entry)(*args(jradon, dtype), **kw)[:2] if args else \
            getattr(jhmc, entry)(**kw)[:2]
    with tconfig.change_flags(scan__pallas=pallas):
        tf, tpos = getattr(thmc, entry)(*args(tradon, dtype), device="cpu", **kw)[:2] if args \
            else getattr(thmc, entry)(device="cpu", **kw)[:2]
    return (jf, jpos), (tf, tpos)


def _radon_logp(radon, dtype):
    """``(build, n_params)`` of the radon logp at the small size."""
    inputs, (logp, _), n_params = radon.make_radon_graphs(
        n_obs=SMALL["n_obs"], n_counties=SMALL["n_counties"], dtype=dtype)
    return (lambda: (inputs[0], logp)), n_params


def _keys(f, key_type):
    return [sv for sv in f.shared_vars if isinstance(sv.type, key_type)]


def _close(got, want, rtol, what):
    got, want = np.asarray(got, dtype="float64"), np.asarray(want, dtype="float64")
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=rtol, atol=rtol, err_msg=what)


def _ops(f, names):
    counts = {}
    for node in f.fgraph.toposort():
        name = type(node.op).__name__
        if name in names:
            counts[name] = counts.get(name, 0) + 1
    return counts


def _k2_refuses_the_leapfrog_scans(jf, tf):
    names = {"NormalRV", "UniformRV", "Scan"}
    assert _ops(tf, names) == _ops(jf, names)
    jscans = [n for n in jf.fgraph.toposort() if type(n.op).__name__ == "Scan"]
    tscans = [n for n in tf.fgraph.toposort() if type(n.op).__name__ == "Scan"]
    assert [n.op.name for n in tscans] == [n.op.name for n in jscans]
    for jn, tn in zip(jscans, tscans):
        # the carried position is a shared variable of unknown static shape
        assert not pallas_scan_eligible(jn.op, jn)
        assert not scan_kernel_eligible(tn.op, tn)
        assert any(d is None for d in tn.inputs[1].type.shape)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("entry", list(ENTRIES))
def test_hmc_transitions(entry, dtype):
    """float32 is linked with ``scan__pallas`` on in both packages, float64
    with the default flags."""
    if entry == "make_radon_multinomial_hmc" and dtype == "float64":
        # the JAX package's entry point leaves the step at float32 over a
        # float64 model and its scan refuses the mix (a TypeError in both);
        # the float64 step is held through make_multinomial_hmc_step
        for pkg, kw in ((jhmc, {}), (thmc, {"device": "cpu"})):
            with pytest.raises(TypeError):
                pkg.make_radon_multinomial_hmc(dtype=dtype, **SMALL, **kw)
        entry = "make_multinomial_hmc_step"
    (jf, jpos), (tf, tpos) = _build(entry, dtype, pallas=dtype == "float32")
    if dtype == "float32":
        _k2_refuses_the_leapfrog_scans(jf, tf)
    assert tf.linked.host_reads == []
    jkeys, tkeys = _keys(jf, JKey), _keys(tf, TKey)
    assert len(jkeys) == len(tkeys) == 2
    for j, t in zip(jkeys, tkeys):
        # the same RandomStream seeds: the same keys, carried over all the same
        np.testing.assert_array_equal(t.get_value().numpy(), np.asarray(j.get_value()))
        t.set_value(j.get_value())
    np.testing.assert_array_equal(tpos.get_value().numpy(), np.asarray(jpos.get_value()))
    rtol = TOL[dtype]
    for step in range(5):
        (jl, ja), (tl, ta) = jf(), tf()
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja), err_msg=f"step {step}")
        _close(tl.numpy(), jl, rtol, f"logp, step {step}")
        _close(tpos.get_value().numpy(), jpos.get_value(), rtol, f"position, step {step}")
    for j, t in zip(jkeys, tkeys):
        np.testing.assert_array_equal(t.get_value().numpy(), np.asarray(j.get_value()))


def test_the_entry_points_default_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            thmc.make_radon_hmc(**SMALL)
    with pytest.raises(NotImplementedError, match="item 16"):
        thmc.make_radon_hmc_chains(mesh=object(), device="cpu", **SMALL)

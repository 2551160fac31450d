"""K3, the radon leapfrog chain: its plain version against the JAX
package's Pallas kernel, and the host side of the CUDA wrapper.

The JAX side runs ``make_radon_leapfrog_pallas(..., interpret=True)``, as
``tests/test_benchmarks.py:185`` runs it on the CPU.  Both are float32 and
start from the same numpy ``theta0``, ``m0``.  Tolerance: ``rtol 1e-5``
with ``atol 1e-5`` for theta and m, ``rtol 1e-6`` for logp; the two sum
the observations in different orders.  The CUDA kernel needs a card:
``tests/test_torch_cuda.py`` runs it.
"""

import numpy as np
import pytest
import torch

from pytensor_tpu.models.radon_pallas import make_radon_leapfrog_pallas

from pytensor_tpu_torch.models import radon_kernel
from pytensor_tpu_torch.models.radon import radon_synthetic_data


def _both(n_steps, n_obs, n_counties):
    jrun, jth0, jm0, jn = make_radon_leapfrog_pallas(
        n_steps=n_steps, n_obs=n_obs, n_counties=n_counties, interpret=True)
    tfn, tth0, tm0, tn = radon_kernel.make_radon_leapfrog_kernel(
        n_steps=n_steps, n_obs=n_obs, n_counties=n_counties, device="cpu")
    assert jn == tn
    np.testing.assert_array_equal(jth0, tth0)
    np.testing.assert_array_equal(jm0, tm0)
    return jrun, tfn, tth0, tm0


def _check(jout, tout):
    (jt, jm, jlp), (tt, tm, tlp) = [np.asarray(v) for v in jout], [v.numpy() for v in tout]
    assert tt.dtype == tm.dtype == tlp.dtype == np.float32
    np.testing.assert_allclose(tt, jt, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(tm, jm, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tlp), float(jlp), rtol=1e-6)


@pytest.mark.parametrize("n_steps,n_obs,n_counties", [(8, 120, 11), (3, 919, 85)],
                         ids=["small", "full_width"])
def test_plain_matches_pallas_interpret(n_steps, n_obs, n_counties):
    jrun, tfn, th0, m0 = _both(n_steps, n_obs, n_counties)
    before = radon_kernel.LAUNCHES
    _check(jrun(th0, m0), tfn(th0, m0))
    assert radon_kernel.LAUNCHES == before  # CPU tensors take the plain version


def test_chains_are_independent():
    """A (chains, n_params) batch runs each chain as the single-chain call."""
    tfn, th0, m0, n = radon_kernel.make_radon_leapfrog_kernel(
        n_steps=5, n_obs=120, n_counties=11, device="cpu")
    rng = np.random.default_rng(0)
    th = (th0 + 0.1 * rng.standard_normal((3, n))).astype(np.float32)
    m = rng.standard_normal((3, n)).astype(np.float32)
    bt, bm, blp = tfn(th, m)
    assert tuple(bt.shape) == (3, n) and tuple(blp.shape) == (3,)
    for k in range(3):
        st, sm, slp = tfn(th[k], m[k])
        np.testing.assert_allclose(bt[k].numpy(), st.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(float(blp[k]), float(slp), rtol=1e-6)


def test_csr_layout_groups_each_county():
    county, floor, y = radon_synthetic_data(919, 85, 0, "float32")
    floor_s, y_s, ptr = radon_kernel.csr_layout(county, floor, y, 85)
    assert ptr.dtype == np.int32 and ptr[0] == 0 and ptr[-1] == 919
    for c in range(85):
        rows = np.flatnonzero(county == c)   # stable order within a county
        np.testing.assert_array_equal(y_s[ptr[c]:ptr[c + 1]], y[rows])
        np.testing.assert_array_equal(floor_s[ptr[c]:ptr[c + 1]], floor[rows])


def test_launch_refuses_cpu_tensors():
    tfn, th0, m0, n = radon_kernel.make_radon_leapfrog_kernel(
        n_steps=1, n_obs=120, n_counties=11, device="cpu")
    with pytest.raises(ValueError, match="CUDA"):
        radon_kernel.leapfrog_launch(torch.from_numpy(th0), torch.from_numpy(m0),
                                     tfn.data, 1, 1e-3)

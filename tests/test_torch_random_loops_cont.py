"""jax's loop samplers in the port (ROADMAP Queue 1, item 7b), against the
JAX package on the CPU: the continuous ones, all on jax's gamma loops.

gamma, beta, dirichlet, chisquare, invgamma, gengamma and t, in float32
and float64, at the shapes (7,), (3, 5) and (4096,), on grids spanning
each branch (``tests/torch_random_loops.py``: gamma's alpha 1e-3, 0.5, 1,
2.5, 100, 0 and NaN, dirichlet's 1e-2 to 10), through
``function(..., device="cpu")`` and through each RV's ``perform``: float32
within 8 ulps, float64 within 1e-12 relative (beta and dirichlet with
XLA's own ``log1p`` error through 1 / alpha added), subnormals held as 0
(XLA on the CPU flushes them).  jax draws all seven in float64 whatever
the parameters' dtype, so a float32 parameter's draw is the float64 one
rounded.
"""

import pytest

from tests.torch_random_loops import SHAPES, draw_grid, log_scale, mismatches

CONTINUOUS = ["gamma", "beta", "dirichlet", "chisquare", "invgamma", "gengamma", "t"]


@pytest.mark.parametrize("floatx", ["float32", "float64"])
@pytest.mark.parametrize("name", CONTINUOUS)
def test_continuous_sampler_against_jax(name, floatx):
    out, keys, grids = draw_grid(name, floatx)
    for j, shape in enumerate(SHAPES):
        scale = log_scale(name, keys[j], grids[j], shape)
        for path in ("torch", "perform"):
            bad = mismatches(out[path][j], out["jax"][j], scale)
            assert len(bad) == 0, (name, floatx, shape, path, bad[:8],
                                   out[path][j].reshape(-1)[bad[:8]],
                                   out["jax"][j].reshape(-1)[bad[:8]])

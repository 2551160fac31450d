"""Backprop through scan (``Scan.L_op``) in the port against the JAX
package, on the CPU: the cases of ``tests/test_ref_scan2.py:408-528``
(duplicate outputs, and the RNN costs of one and of several outputs,
with taps on sequences and states, forward and backward), held as
``test_torch_scan_grad.py`` holds its cases, with its helpers and
tolerances.
"""

import numpy as np
import pytest

from test_torch_scan_grad import _dmat, _dscalar, _dvec, _rng, _same

CASES = {}


def case(fn):
    CASES[fn.__name__] = fn
    return fn


@case
def grad_duplicate_outputs(P):
    pt = P.pt
    seq, out_init, non_seq = _dmat(P, "seq"), _dmat(P, "init"), _dvec(P, "ns")

    def inner(a, b, c):
        total = a + b + c
        return total, total

    outs = P.scan(fn=inner, sequences=seq, outputs_info=[None, dict(initial=out_init, taps=[-3])],
                  non_sequences=non_seq, return_updates=False)
    g0 = P.grad(outs[0].sum(), [seq, out_init, non_seq])
    g1 = P.grad(outs[1].sum(), [seq, out_init, non_seq])
    rng = _rng(5)
    return ([seq, out_init, non_seq], g0 + g1,
            [rng.random((10, 3)), rng.random((3, 3)), rng.random(3)])


@case
def grad_one_output(P):
    u, x0, W_in, W = _dvec(P, "u"), _dscalar(P, "x0"), _dscalar(P, "W_in"), _dscalar(P, "W")
    out = P.scan(lambda u_t, x_tm1, wi, w: u_t * wi + x_tm1 * w, u, x0, [W_in, W],
                 return_updates=False)
    cost = ((out - 1) ** 2).sum()
    rng = _rng(11)
    return ([u, x0, W_in, W], [cost, *P.grad(cost, [u, x0, W_in, W])],
            [rng.uniform(-0.5, 0.5, size=(10,)), *rng.uniform(size=3)])


def _rnn_multiple_outs(P, taps, backwards=False):
    pt = P.pt
    rng = _rng(17)
    n = 5
    W_in2 = P.shared(rng.uniform(-0.2, 0.2, size=(2,)), name="win2")
    W = P.shared(rng.uniform(-0.2, 0.2, size=(2, 2)), name="w")
    W_out = P.shared(rng.uniform(-0.2, 0.2, size=(2,)), name="wout")
    vals = [rng.uniform(-0.2, 0.2, size=(n, 2)),
            rng.uniform(-0.2, 0.2, size=(n + 2, 2) if taps else (n,)),
            rng.uniform(-0.2, 0.2, size=(2,)),
            rng.uniform(size=(3,)) if taps else np.float64(rng.uniform()),
            rng.uniform(-0.2, 0.2, size=(2, 2))]
    u1, W_in1, x0 = _dmat(P, "u1"), _dmat(P, "win"), _dvec(P, "x0")
    if taps:
        u2, y0 = _dmat(P, "u2"), _dvec(P, "y0")

        def step(u1_t, u2_tm1, u2_t, u2_tp1, x_tm1, y_tm1, y_tm3, W_in1_):
            return [pt.dot(u1_t, W_in1_) + (u2_t + u2_tm1 * u2_tp1) * W_in2
                    + pt.dot(x_tm1, W), (y_tm1 + y_tm3) * pt.dot(x_tm1, W_out)]

        outs = P.scan(step, [u1, dict(input=u2, taps=[-1, 0, 1])],
                      [x0, dict(initial=y0, taps=[-1, -3])], W_in1, go_backwards=backwards,
                      return_updates=False)
    else:
        u2, y0 = _dvec(P, "u2"), _dscalar(P, "y0")

        def step(u1_t, u2_t, x_tm1, y_tm1, W_in1_):
            return [pt.dot(u1_t, W_in1_) + u2_t * W_in2 + pt.dot(x_tm1, W),
                    pt.dot(x_tm1, W_out)]

        outs = P.scan(step, [u1, u2], [x0, y0], W_in1, return_updates=False)
    cost = sum(((o - 0.5) ** 2).sum() for o in outs)
    params = [u1, u2, x0, y0, W_in1]
    return params, [cost, *P.grad(cost, params, disconnected_inputs="ignore")], vals


@case
def grad_multiple_outs(P):
    return _rnn_multiple_outs(P, taps=False)


@case
def grad_multiple_outs_taps(P):
    return _rnn_multiple_outs(P, taps=True)


@case
def grad_multiple_outs_taps_backwards(P):
    return _rnn_multiple_outs(P, taps=True, backwards=True)


@pytest.mark.parametrize("name", sorted(CASES))
def test_grad_matches_jax(name):
    _same(CASES[name])

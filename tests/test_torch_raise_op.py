"""``CheckAndRaise`` and ``Assert`` in the port against the JAX package.

The cases of ``tests/test_subsystems.py:160-170``,
``tests/test_error_paths.py:113-120``, ``tests/test_ref_link_xla.py:76-82``
and ``tests/test_assumptions_scenarios.py:177-184``; the same exception
type and message as the JAX package's oracle (its XLA path wraps them in
a ``JaxRuntimeError`` whose text holds the message); the proven assert
removed in both (``local_remove_proven_assert``); an assert in a scan
body; and the deferred check (``link/torch/linker.py Checks``) run on the
CPU through a plan given its ``Checks``, as a plan on a card makes its
own: the failed node raised after the call, the first in topological
order, a step loop's slot ORed over the steps, the flags zeroed each
call.  Values: float64 ``rtol 1e-12``.
"""

import numpy as np
import pytest
import torch

import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.link.torch.linker import Checks, fgraph_to_torch
from pytensor_tpu_torch.raise_op import Assert, CheckAndRaise, assert_op
from tests.torch_control import JAX, PORT, both, np_, ops


def _assert_all_positive(p):
    x = p.pt.dvector("x")
    return [x], [p.raise_op.assert_op(x, p.pt.all(x > 0)).sum()]


@pytest.mark.parametrize("mode", ["FAST_COMPILE", "FAST_RUN"])
def test_assert_raises(mode):
    (out,), _ = both(_assert_all_positive, [np.ones(3)], jax_mode=mode, port_mode=mode)
    assert float(out) == 3.0
    f = PORT.function(*_assert_all_positive(PORT), mode=mode)
    with pytest.raises(AssertionError):
        f(np.array([-1.0, 1.0]))


def _message(p):
    x = p.pt.dvector("x")
    return [x], [p.raise_op.Assert("must be positive")(x, p.pt.all(x > 0))]


def test_same_exception_type_and_message_as_the_jax_package():
    for mode in ("FAST_COMPILE", "FAST_RUN"):
        raised = {}
        for pkg in (JAX, PORT):
            ins, outs = _message(pkg)
            f = pkg.function(ins, outs[0], mode=mode if pkg is PORT else "FAST_COMPILE")
            np.testing.assert_allclose(np_(f(np.ones(3))), np.ones(3))
            with pytest.raises(Exception, match="must be positive") as info:
                f(-np.ones(3))
            raised[pkg.name] = info.value
        assert type(raised["torch"]) is type(raised["jax"]) is AssertionError
        assert "Apply node that caused the error: Assert{msg=must be positive}" in str(
            raised["torch"])
    ins, outs = _message(JAX)
    jf = JAX.function(ins, outs[0])
    with pytest.raises(Exception, match="must be positive"):
        np.asarray(jf(-np.ones(3)))


def _value_exception(p):
    x = p.pt.dscalar("x")
    return [x], [p.raise_op.CheckAndRaise(ValueError, "x too big")(x, x < 1.0)]


def test_check_and_raise_with_its_own_exception_type():
    (out,), _ = both(_value_exception, [0.5], jax_mode="FAST_COMPILE")
    assert float(out) == 0.5
    ins, outs = _value_exception(PORT)
    f = PORT.function(ins, outs[0])
    with pytest.raises(ValueError, match="x too big"):
        f(2.0)


def test_checkandraise_ref_link():
    p = tpt.dscalar("p")
    f = PORT.function([p], assert_op(p, p < 1.0))
    assert float(f(0.5)) == 0.5
    with pytest.raises(AssertionError):
        f(2.0)


def _proven(p):
    x = p.pt.dvector("x")
    return [x], [p.raise_op.Assert("positive")(p.pt.exp(x).sum(), p.pt.exp(x).sum())]


def test_proven_assert_removed_in_both():
    (out,), (jf, tf) = both(_proven, [np.arange(3.0)])
    assert "Assert" not in "".join(ops(tf)) and "Assert" not in "".join(ops(jf))
    assert ops(tf) == ops(jf)
    from pytensor_tpu_torch.compile.mode import specialize

    assert "local_remove_proven_assert" in specialize._names


def _unproven(p):
    x = p.pt.dvector("x")
    return [x], [p.raise_op.Assert("positive")(x.sum(), x.sum())]


def test_unproven_assert_stays_in_both():
    _, (jf, tf) = both(_unproven, [np.arange(1.0, 4.0)])
    assert ops(tf).count("Assert") == ops(jf).count("Assert") == 1


def test_op_interface_as_the_jax_package():
    for pkg in (JAX, PORT):
        ro = pkg.raise_op
        a, b = ro.Assert("m"), ro.Assert("m")
        assert a == b and hash(a) == hash(b) and a != ro.Assert("n")
        assert ro.CheckAndRaise(ValueError, "m") != ro.CheckAndRaise(AssertionError, "m")
        assert str(a) == "Assert{msg=m}"
        assert str(ro.CheckAndRaise(ValueError, "v")) == "CheckAndRaise{ValueError(v)}"
        assert ro.CheckAndRaise.view_map == {0: [0]}
        x = pkg.pt.dvector("x")
        node = a(x, pkg.pt.all(x > 0)).owner
        assert a.connection_pattern(node) == [[True], [False]]
        assert ro.assert_(x, x.sum() > 0).owner.op == ro.assert_op


def _grad(p):
    x = p.pt.dvector("x")
    y = p.raise_op.assert_op(p.pt.exp(x), p.pt.all(x < 10))
    return [x], [p.ptt.grad(y.sum(), x)]


def test_gradient_passes_through():
    (g,), _ = both(_grad, [np.arange(3.0)], rtol=1e-10)
    np.testing.assert_allclose(g, np.exp(np.arange(3.0)))


def _in_scan(p):
    xs = p.pt.dvector("xs")

    def step(v, acc):
        return acc + p.raise_op.Assert("a step's value must be positive")(v, p.pt.gt(v, 0))

    res, _ = p.ptt.scan(step, sequences=[xs], outputs_info=[p.pt.constant(0.0, dtype="float64")])
    return [xs], [res[-1]]


def test_assert_in_a_scan_body():
    (out,), _ = both(_in_scan, [np.arange(1.0, 5.0)], jax_mode="FAST_COMPILE")
    assert float(out) == 10.0
    for pkg, mode in ((JAX, "FAST_COMPILE"), (PORT, None)):
        f = pkg.function(*_in_scan(pkg), **({"mode": mode} if mode else {}))
        with pytest.raises(AssertionError, match="a step's value must be positive"):
            f(np.array([1.0, -2.0, 3.0]))


def test_a_failed_call_writes_no_update():
    from pytensor_tpu_torch.compile.sharedvalue import shared

    w = shared(np.zeros(3), name="w", device="cpu")
    x = tpt.dvector("x")
    f = PORT.function([x], assert_op(x, tpt.all(x > 0)).sum(), updates={w: w + x})
    f(np.ones(3))
    with pytest.raises(AssertionError):
        f(-np.ones(3))
    np.testing.assert_array_equal(np_(w.get_value()), np.ones(3))


def test_host_condition_reads_nothing_back():
    x = tpt.dvector("x")
    f = PORT.function([x], assert_op(x, tpt.eq(x.shape[0], 3)) * 2.0)
    assert f.linked.host_reads == []
    np.testing.assert_array_equal(np_(f(np.ones(3))), 2 * np.ones(3))
    with pytest.raises(AssertionError):
        f(np.ones(4))


# --- the deferred check, on the CPU through a plan given its Checks ------------------------

def _deferred(inputs, outputs):
    fg = FunctionGraph(inputs, outputs, clone=True)
    checks = Checks(torch.device("cpu"))
    plan = fgraph_to_torch(fg, "cpu", checks=checks)
    checks.allocate()

    def call(*args):
        checks.zero()
        out = plan(*args)
        checks.raise_failed()
        return out

    return plan, checks, call


def test_deferred_check_raises_after_the_call_the_first_failed_node():
    x = tpt.dvector("x")
    first = Assert("first")(x, tpt.all(x > 0))
    second = Assert("second")(first * 2.0, tpt.all(x < 5))
    plan, checks, call = _deferred([x], [second])
    assert [n.op.msg for _, n in checks.nodes] == ["first", "second"]
    assert plan.host_reads == []
    np.testing.assert_array_equal(np_(call(torch.ones(3, dtype=torch.float64))[0]),
                                  2 * np.ones(3))
    # the call runs to its end; the first failed node raises, with its node
    out = plan(torch.tensor([-1.0, 9.0], dtype=torch.float64))
    assert out[0].tolist() == [-2.0, 18.0] and checks.buffer.tolist() == [True, True]
    with pytest.raises(AssertionError, match="first") as info:
        checks.raise_failed()
    assert "Apply node that caused the error: Assert{msg=first}" in str(info.value)
    with pytest.raises(AssertionError, match="second"):
        call(torch.tensor([1.0, 9.0], dtype=torch.float64))
    call(torch.ones(2, dtype=torch.float64))  # zeroed at the start of each call


def test_deferred_check_in_a_step_loop_ors_the_steps():
    xs = tpt.dvector("xs")

    def step(v, acc):
        return acc + Assert("a step's value must be positive")(v, tpt.gt(v, 0))

    res, _ = PORT.ptt.scan(step, sequences=[xs],
                           outputs_info=[tpt.constant(0.0, dtype="float64")])
    _, checks, call = _deferred([xs], [res[-1]])
    assert len(checks.nodes) == 1
    assert float(call(torch.arange(1.0, 4.0, dtype=torch.float64))[0]) == 6.0
    # a failed step in the middle stays failed through the later steps
    with pytest.raises(AssertionError, match="a step's value must be positive"):
        call(torch.tensor([1.0, -2.0, 3.0], dtype=torch.float64))


def test_check_and_raise_is_no_host_read():
    x = tpt.dvector("x")
    f = PORT.function([x], Assert("m")(x, tpt.all(x > 0)) * 2.0)
    assert f.linked.host_reads == []
    assert isinstance(next(n.op for n in f.fgraph.apply_nodes
                           if isinstance(n.op, CheckAndRaise)), Assert)


def _fit(solver, x, d):
    """``x*`` of a fit whose objective asserts that its data ``d`` is finite."""
    from pytensor_tpu_torch.tensor.optimize import minimize, root

    target = Assert("the data must be finite")(d, tpt.all(tpt.isfinite(d)))
    if solver == "minimize":
        (x_star, _), _ = minimize(tpt.sum((x - target) ** 2), x)
    else:
        (x_star, _), _ = root(x - target, x)
    return x_star


@pytest.mark.parametrize("solver", ["minimize", "root"])
def test_deferred_check_in_an_optimizer_objective(solver):
    """BFGS's evaluations and Newton's steps link inner plans; their
    asserts write into the outer plan's flags, which its caller reads."""
    x, d = tpt.dvector("x"), tpt.dvector("d")
    _, checks, call = _deferred([x, d], [_fit(solver, x, d)])
    assert checks.nodes and all(n.op.msg == "the data must be finite" for _, n in checks.nodes)
    data = torch.tensor([1.0, -2.0, 3.0], dtype=torch.float64)
    start = torch.zeros(3, dtype=torch.float64)
    np.testing.assert_allclose(np_(call(start, data)[0]), np_(data), rtol=1e-6)
    data[1] = float("nan")
    with pytest.raises(AssertionError, match="the data must be finite"):
        call(start, data)

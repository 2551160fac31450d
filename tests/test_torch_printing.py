"""``printing.py`` in both packages: ``debugprint``'s text (of a variable,
of a function's rewritten graph, the radon model's included) and
``pprint``'s, equal to the JAX package's where the op names agree (they
do on these graphs); the ``Print`` op (its message once a call, its
value passed through, a plan that holds it eager and saying why);
``pydotprint`` raising without pydot, as the JAX package's does; and the
``dprint`` methods and the ``PrintCurrentFunctionGraph`` pass."""

import io
from contextlib import redirect_stdout

import numpy as np
import pytest

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
from pytensor_tpu.models.radon import make_radon_graphs as j_radon
from pytensor_tpu.printing import Print as JPrint

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.compile.mode import FAST_RUN, PrintCurrentFunctionGraph
from pytensor_tpu_torch.models.radon import make_radon_graphs as t_radon
from pytensor_tpu_torch.printing import FunctionPrinter, PPrinter
from pytensor_tpu_torch.printing import Print as TPrint

PKGS = {"jax": (jptt, jpt, {}), "torch": (tptt, tpt, {"device": "cpu"})}


def _both(case):
    got = {k: case(*v) for k, v in PKGS.items()}
    assert got["torch"] == got["jax"], got
    return got["torch"]


def test_debugprint_of_a_variable():
    def case(ptt, pt, kw):
        x = pt.dvector("x")
        y = pt.exp(x[1:]) + pt.log(x).sum()
        return ptt.dprint(y, file="str"), y.dprint(file="str"), ptt.debugprint(
            [y, x * 2], file="str", print_type=True)

    text, method, many = _both(case)
    assert text == method and "Elemwise{exp}" in text and "Tensor(float64" in many


def test_debugprint_of_a_function():
    def case(ptt, pt, kw):
        x = pt.dvector("x")
        f = ptt.function([x], [pt.exp(x) + 1, (x * 2).sum()], **kw)
        return f.dprint(file="str")

    text = _both(case)
    assert "FusedElemwise" in text and "Inner graphs of" in text


def test_debugprint_of_the_radon_function():
    """The radon logp and dlogp at 40/5 under FAST_RUN: the same rewritten
    graph, printed alike, FusedElemwise nodes and their inner graphs."""
    def case(ptt, pt, kw):
        make = j_radon if ptt is jptt else t_radon
        ins, outs, _ = make(40, 5, "float64")
        return ptt.function(ins, outs, **kw).dprint(file="str")

    text = _both(case)
    assert text.count("FusedElemwise") >= 10


def test_pprint():
    def case(ptt, pt, kw):
        x, y, z = pt.dvector("x"), pt.dvector("y"), pt.dscalar("z")
        return [ptt.pprint(e) for e in ((x + y) * z, x + y * z,
                                        pt.exp(x[1:3]) / pt.sum(x ** 2), -x,
                                        pt.dot(pt.dmatrix("a"), pt.dmatrix("b")))]

    assert _both(case) == ["(x + y) * z", "x + y * z", "exp(x[1:3]) / sum(x ** 2)", "-x",
                           "a @ b"]
    z = tpt.dscalar("z")
    p2 = tptt.pprint.clone()
    p2.assign(lambda v: v.owner is not None
              and getattr(getattr(v.owner.op, "scalar_op", None), "name", "") == "exp",
              FunctionPrinter("EXP"))
    assert p2(tpt.exp(z)) == "EXP(z)"
    assert "+" in PPrinter()(z + z) or "add" in PPrinter()(z + z).lower()


def test_pprint_of_the_radon_logp():
    def case(ptt, pt, kw):
        make = j_radon if ptt is jptt else t_radon
        _, (logp, _), _ = make(5, 2)
        return ptt.pprint(logp)

    s = _both(case)
    assert all(tok in s for tok in ("theta", "exp", "log", "sum", "**", "/"))


def test_print_op_prints_once_a_call_and_runs_eagerly():
    x = tpt.dvector("x")
    out = TPrint("hello")(x * 2)
    f = tptt.function([x], [out.sum(), out * 3], device="cpu")
    why = [r for r in f.linked.host_reads if "Print" in r]
    assert why and "reads its value back" in why[0]
    buf = io.StringIO()
    with redirect_stdout(buf):
        s, t = f(np.arange(3.0))
        f(np.ones(2))
    assert buf.getvalue() == "hello [0. 2. 4.]\nhello [2. 2.]\n"
    assert float(s) == 6.0 and np.array_equal(np.asarray(t), [0.0, 6.0, 12.0])


def test_print_op_message_as_the_jax_package_prints_it(capsys):
    """The JAX package's oracle (``perform``) and the port print the same
    line; the gradient passes through, as in the JAX package."""
    v = np.array([1.5, -2.0])
    texts, grads = [], []
    for (ptt, pt, kw), P in ((PKGS["jax"], JPrint), (PKGS["torch"], TPrint)):
        x = pt.dvector("x")
        y = P("value")(x)
        mode = {"mode": "FAST_COMPILE"} if ptt is jptt else kw
        f = ptt.function([x], [y, ptt.grad((y ** 2).sum(), x)], **mode)
        _, g = f(v)
        texts.append(capsys.readouterr().out)
        grads.append(np.asarray(g))
    assert texts[0] == texts[1] == "value [ 1.5 -2. ]\n"
    np.testing.assert_array_equal(grads[0], grads[1])


def test_pydotprint_needs_pydot():
    for ptt, pt, _ in PKGS.values():
        with pytest.raises(ImportError, match="pydot"):
            ptt.pydotprint(pt.exp(pt.dvector("x")))


def test_print_current_function_graph_pass():
    x = tpt.dvector("x")
    buf = io.StringIO()
    with redirect_stdout(buf):
        f = tptt.function([x], tpt.exp(x) * 2,
                          mode=FAST_RUN.register(PrintCurrentFunctionGraph("after FAST_RUN")),
                          device="cpu")
    text = buf.getvalue()
    assert text.startswith("after FAST_RUN\n") and text[len("after FAST_RUN\n"):] == \
        f.dprint(file="str")

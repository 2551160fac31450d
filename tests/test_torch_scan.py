"""The port's ``scan`` against the JAX package's, on the CPU.

The same scans are built in both packages from the same numpy inputs.
The JAX package runs them with ``scan__pallas`` on, as its own tests do:
the whole-loop kernel in Pallas interpret mode.  The port runs them with
``scan__pallas`` on too: on CPU tensors K2's wrapper takes its plain
version, the step loop (the kernel itself runs only on a card,
``tests/test_torch_cuda.py``).  Every test also holds the two packages
to the same K2 eligibility decision, and builds K2's CUDA source for
each eligible scan.

Tolerances: the forward cases of ``tests/test_scan.py:703-776`` at
``rtol 1e-5, atol 1e-6`` (float32 loops that sum in other orders), the
fuzzed bodies of ``tests/test_fuzz_dualcheck.py:139-166`` at that test's
``rtol 2e-5, atol 1e-6``.
"""

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
from pytensor_tpu.config import config as jconfig
from pytensor_tpu.link.pallas.scan_pallas import pallas_scan_eligible

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.config import config as tconfig
from pytensor_tpu_torch.link.cuda.scan_kernel import ScanKernelSource, scan_kernel_eligible

RTOL, ATOL = 1e-5, 1e-6
PKGS = {"jax": (jptt, jpt, jconfig), "torch": (tptt, tpt, tconfig)}


def _scan_node(fn):
    nodes = [nd for nd in fn.fgraph.apply_nodes if type(nd.op).__name__ == "Scan"]
    assert len(nodes) == 1
    return nodes[0]


def _compile(pkg, build, pallas=True, mode=None):
    ptt, pt, config = PKGS[pkg]
    with config.change_flags(scan__pallas=pallas):
        inputs, outputs = build(ptt, pt)
        kw = {"device": "cpu"} if pkg == "torch" else {}
        return ptt.function(inputs, outputs, mode=mode, **kw)


def _run(pkg, f, values):
    if pkg == "torch":
        res = f(*[torch.as_tensor(np.asarray(v)) for v in values])
        res = res if isinstance(res, list) else [res]
        return [r.numpy() for r in res]
    res = f(*values)
    res = res if isinstance(res, list) else [res]
    return [np.asarray(r) for r in res]


def _same_decision(jf, tf):
    """Both packages decide alike on the scan; returns the decision, and
    builds K2's source where it is eligible."""
    jn, tn = _scan_node(jf), _scan_node(tf)
    decision = pallas_scan_eligible(jn.op, jn)
    assert scan_kernel_eligible(tn.op, tn) == decision
    if decision:
        src = ScanKernelSource(tn.op, tn)
        assert "k2_kernel" in src.source and src.n_ops > 0
    return decision


def _both(build, values, pallas=True):
    jf, tf = _compile("jax", build, pallas), _compile("torch", build, pallas)
    return _run("jax", jf, values), _run("torch", tf, values), _same_decision(jf, tf)


# --- the forward cases of tests/test_scan.py:703-776 -----------------------------

def _scalar_carry(ptt, pt):
    z = pt.tensor("z", dtype="float32", shape=())
    tr, _ = ptt.scan(lambda acc: acc * np.float32(1.1) + np.float32(0.5),
                     outputs_info=[z], n_steps=6)
    return [z], tr


def _vector_state_and_nitsot(ptt, pt):
    v0 = pt.tensor("v0", dtype="float32", shape=(4,))
    (tr, sq), _ = ptt.scan(lambda acc: (acc + np.float32(1.0), (acc ** 2).sum()),
                           outputs_info=[v0, None], n_steps=3)
    return [v0], [tr, sq]


_W = (np.eye(5) * 0.9 + 0.01).astype("float32")


def _tanh_dot(ptt, pt):
    v0 = pt.tensor("v0", dtype="float32", shape=(5,))
    W = pt.as_tensor_variable(_W)
    tr, _ = ptt.scan(lambda acc: pt.tanh(pt.dot(W, acc)) + np.float32(0.01),
                     outputs_info=[v0], n_steps=10)
    return [v0], tr


def _sequences(ptt, pt):
    x = pt.tensor("x", dtype="float32", shape=(4,))
    tr, _ = ptt.scan(lambda xt, acc: acc + xt, sequences=[x],
                     outputs_info=[pt.constant(np.float32(0.0))])
    return [x], tr


def test_scalar_carry():
    j, t, eligible = _both(_scalar_carry, [np.float32(1.0)])
    acc, expected = 1.0, []
    for _ in range(6):
        acc = acc * 1.1 + 0.5
        expected.append(acc)
    assert eligible
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t[0], expected, rtol=1e-6)


def test_vector_state_and_nitsot():
    j, t, eligible = _both(_vector_state_and_nitsot, [np.zeros(4, "float32")])
    assert eligible
    assert t[0].shape == j[0].shape == (3, 4)
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t[1], [0.0, 4.0, 16.0])


def test_loop_path_matches_kernel_path():
    """scan__pallas off (the loop) and on (K2's wrapper, whose plain
    version runs on CPU tensors) agree, and agree with the JAX package's
    lax.scan and Pallas paths."""
    x0 = np.random.default_rng(0).standard_normal(5).astype("float32")
    j_loop, t_loop, elig_off = _both(_tanh_dot, [x0], pallas=False)
    j_kern, t_kern, elig_on = _both(_tanh_dot, [x0], pallas=True)
    assert elig_off and elig_on
    np.testing.assert_allclose(t_kern[0], t_loop[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(j_kern[0], j_loop[0], rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(t_kern[0], j_kern[0], rtol=RTOL, atol=ATOL)


def test_sequences():
    j, t, eligible = _both(_sequences, [np.ones(4, "float32")])
    assert eligible
    np.testing.assert_allclose(t[0], [1, 2, 3, 4])
    np.testing.assert_allclose(t[0], j[0])


def test_kernel_path_takes_the_k2_wrapper():
    """With scan__pallas on, an eligible scan is linked to K2's wrapper;
    off, or ineligible, to the step loop."""
    from pytensor_tpu_torch.link.cuda.scan_kernel import ScanKernel
    from pytensor_tpu_torch.link.torch.dispatch import torch_funcify

    node = _scan_node(_compile("torch", _tanh_dot))
    for pallas in (True, False):
        with tconfig.change_flags(scan__pallas=pallas):
            lowered = torch_funcify(node.op, node=node, device="cpu")
        assert isinstance(lowered, ScanKernel) == pallas


# --- the forward half of tests/test_fuzz_dualcheck.py:139-166 ------------------------

def _random_scan_body(rng, pt):
    ops = [lambda a: pt.tanh(a) * np.float32(0.9),
           lambda a: a * np.float32(0.8) + np.float32(0.1),
           lambda a: pt.sigmoid(a) - np.float32(0.5),
           lambda a: pt.maximum(a * np.float32(0.7), -a),
           lambda a: pt.sin(a) * np.float32(0.5)]
    picks = [ops[rng.integers(len(ops))] for _ in range(int(rng.integers(1, 4)))]

    def step(acc):
        for f in picks:
            acc = f(acc)
        return acc

    init = rng.standard_normal(4).astype("float32")
    return step, init, int(rng.integers(3, 9))


@pytest.mark.parametrize("seed", range(15))
def test_fuzz_scan_paths_agree(seed):
    """The JAX package's oracle (FAST_COMPILE) and Pallas paths, and the
    port's loop and kernel paths, of the same random scan agree on the
    trace (the gradient half waits for the port's BPTT)."""
    results = {}
    fns = {}
    for label, pkg, pallas, mode in (("oracle", "jax", False, "FAST_COMPILE"),
                                     ("pallas", "jax", True, None),
                                     ("loop", "torch", False, None),
                                     ("kernel", "torch", True, None)):
        ptt, pt, _ = PKGS[pkg]
        rng = np.random.default_rng(5000 + seed)
        step, init_v, n = _random_scan_body(rng, pt)

        def build(ptt, pt, step=step, n=n):
            v0 = pt.tensor("v0", dtype="float32", shape=(4,))
            tr, _ = ptt.scan(step, outputs_info=[v0], n_steps=n)
            return [v0], tr

        fns[label] = _compile(pkg, build, pallas, mode)
        results[label] = _run(pkg, fns[label], [init_v])[0]
    assert _same_decision(fns["pallas"], fns["kernel"])
    for label in ("pallas", "loop", "kernel"):
        np.testing.assert_allclose(results[label], results["oracle"], rtol=2e-5, atol=1e-6,
                                   err_msg=label)


# --- a dynamic-shape scan: both packages refuse the kernel -------------------------

def test_dynamic_shape_scan_is_refused_by_both():
    def build(ptt, pt):
        v0 = pt.tensor("v0", dtype="float32", shape=(None,))
        (tr, s), _ = ptt.scan(lambda acc: (acc * np.float32(0.5) + np.float32(1.0),
                                           acc.sum()), outputs_info=[v0, None], n_steps=4)
        return [v0], [tr, s]

    x = np.arange(6, dtype="float32")
    j, t, eligible = _both(build, [x])
    assert not eligible
    for a, b in zip(t, j):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)


# --- the two onehot rewrites ------------------------------------------------------

_IDX = np.array([2, 0, 2, 4, 1, 4, 4], dtype="int64")


def _gather_scatter(ptt, pt):
    x = pt.tensor("x", dtype="float32", shape=(5,))
    y = pt.tensor("y", dtype="float32", shape=(7,))
    gathered = x[pt.as_tensor_variable(_IDX)] * np.float32(2.0)
    scattered = pt.inc_subtensor(x[pt.as_tensor_variable(_IDX)], y)
    return [x, y], [gathered, scattered]


@pytest.mark.parametrize("onehot", [False, True], ids=["fast_run", "onehot_gather"])
def test_onehot_rewrites(onehot):
    """``local_constant_gather_to_onehot_dot`` and
    ``local_constant_scatter_to_onehot_dot`` fire only under
    ``including("onehot_gather")``, as in the JAX package: the gather and
    the scatter-add become Dot, with the same values and ops."""
    import collections

    from pytensor_tpu.compile.mode import get_mode as jget_mode

    from pytensor_tpu_torch.compile.mode import get_mode as tget_mode

    rng = np.random.default_rng(1)
    vals = [rng.standard_normal(5).astype("float32"), rng.standard_normal(7).astype("float32")]
    outs, counts = {}, {}
    for pkg, get_mode in (("jax", jget_mode), ("torch", tget_mode)):
        mode = get_mode(None).including("onehot_gather") if onehot else None
        f = _compile(pkg, _gather_scatter, mode=mode)
        outs[pkg] = _run(pkg, f, vals)
        counts[pkg] = collections.Counter(type(n.op).__name__ for n in f.fgraph.apply_nodes)
    assert counts["torch"] == counts["jax"]
    assert (counts["torch"]["Dot"] == 2) == onehot
    # excluding the tag again takes the rewrites out
    f = _compile("torch", _gather_scatter,
                 mode=tget_mode(None).including("onehot_gather").excluding("onehot_gather"))
    assert not any(type(n.op).__name__ == "Dot" for n in f.fgraph.apply_nodes)
    assert (counts["torch"]["AdvancedSubtensor1"] == 0) == onehot
    for a, b in zip(outs["torch"], outs["jax"]):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    want = np.array(vals[0])
    np.add.at(want, _IDX, vals[1])
    np.testing.assert_allclose(outs["torch"][1], want, rtol=RTOL, atol=ATOL)


# --- what the port leaves out raises ------------------------------------------------

def test_while_scans_and_bptt_raise_not_implemented():
    """While-scans no longer raise: they are ported
    (``tests/test_torch_while_scan.py``), and this one stops after its
    third step.  Backprop through time is ported
    (``tests/test_torch_scan_grad.py``): what is left of it raises as in
    the JAX package, a not-implemented gradient through a tensor-typed
    untraced state (one the sit-sot rewrite makes)."""
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.gradient import NullTypeGradError
    from pytensor_tpu_torch.scan.op import Scan, ScanInfo
    from pytensor_tpu_torch.scan.utils import until

    v0 = tpt.tensor("v0", dtype="float32", shape=(3,))
    tw, _ = tptt.scan(
        lambda acc: (acc * np.float32(2.0), until(tpt.ge(acc.sum(), np.float32(9.0)))),
        outputs_info=[v0], n_steps=5)
    got = tptt.function([v0], tw, device="cpu")(np.ones(3, "float32"))
    np.testing.assert_array_equal(got.numpy(), np.array([[2.0] * 3, [4.0] * 3, [8.0] * 3],
                                                        "float32"))
    tr, _ = tptt.scan(lambda acc: acc * np.float32(2.0), outputs_info=[v0], n_steps=5)
    g = tptt.function([v0], tptt.grad(tr[-1].sum(), v0), device="cpu")(np.ones(3, "float32"))
    np.testing.assert_array_equal(g.numpy(), np.full(3, 32.0, "float32"))
    h = tpt.tensor("h", dtype="float32", shape=(3,))
    untraced = Scan(FunctionGraph([h], [h * np.float32(2.0)], clone=True),
                    ScanInfo(0, (), 0, 0, n_untraced=1))
    with pytest.raises(NullTypeGradError, match="untraced"):
        tptt.grad(untraced(5, v0).sum(), v0)


def test_infer_shape_and_connection_pattern():
    x = tpt.tensor("x", dtype="float32", shape=(6, 3))
    (tr, nit), _ = tptt.scan(lambda xt, acc: (acc + xt, xt.sum()), sequences=[x],
                             outputs_info=[tpt.constant(np.zeros(3, "float32")), None])
    node = tr.owner
    shapes = node.op.infer_shape(None, node, [(), (6, 3), (3,)])
    assert [len(s) for s in shapes] == [2, 1]
    assert shapes[0][1:] == (3,)
    pattern = node.op.connection_pattern(node)
    assert pattern[0] == [False, False] and all(all(row) for row in pattern[1:])
    assert tr.type.shape == (6, 3) and nit.type.shape == (6,)


def test_two_tap_state_takes_the_loop_in_both():
    """A state with taps (-2, -1): the loop keeps the window, and neither
    package runs it as a kernel (taps other than (-1,) are refused)."""
    def build(ptt, pt):
        x0 = pt.tensor("x0", dtype="float32", shape=(2, 3))
        tr, _ = ptt.scan(lambda a, b: a * np.float32(0.5) + b,
                         outputs_info=[{"initial": x0, "taps": [-2, -1]}], n_steps=6)
        return [x0], tr

    x0 = np.arange(6, dtype="float32").reshape(2, 3)
    j, t, eligible = _both(build, [x0])
    assert not eligible
    np.testing.assert_allclose(t[0], j[0], rtol=RTOL, atol=ATOL)


def test_constant_scan_is_folded_by_perform():
    """A scan of constants only is folded at rewrite time by Scan.perform,
    the numpy loop, in both packages."""
    def build(ptt, pt):
        x = pt.tensor("x", dtype="float64", shape=())
        tr, _ = ptt.scan(lambda acc: acc * 1.5 + 1.0, outputs_info=[pt.constant(1.0)],
                         n_steps=5)
        return [x], tr * x

    jf, tf = _compile("jax", build), _compile("torch", build)
    assert not any(type(n.op).__name__ == "Scan" for n in tf.fgraph.apply_nodes)
    np.testing.assert_allclose(_run("torch", tf, [2.0])[0], _run("jax", jf, [2.0])[0],
                               rtol=1e-12)

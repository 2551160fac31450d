"""The compile driver in the port against the JAX package.

Each case of the JAX package's ``tests/test_compile_contracts.py`` (In and
Out, givens, updates, ``Function.copy``, pickling, errors, ``profile``) and
``tests/test_function.py`` (the ``function`` pipeline and ``train_loop``)
is built in both packages on the same seeded numpy inputs, the JAX package
with its defaults and the port on the CPU; what each case returns (the
calls' values, the shared values after them, or the exception raised) is
held equal: float64 at ``rtol 1e-12``, float32 at ``1e-6``, integers and
errors exactly.  Beside them: the radon graph under ``FAST_COMPILE``,
``PY`` and ``FAST_RUN`` op for op against the JAX package's (93, 53 and 53
nodes at 919/85) with its logp and dlogp at ``1e-12``, ``copy`` of a
``train_loop`` (the sparse power iteration) in its three forms, a pickled
``Scan`` (``tests/test_ref_scan2.py:133``) and the leapfrog chain,
``misc/pkl_utils.py``'s round trips with a default update, ``profile=True``
under both linkers, the matmul-precision flags' mapping, a shared variable
recorded on ``"cuda"`` refusing to load where CUDA is absent, and the
compile layer's smaller modules (the mode registries, the aliasing
contracts, inner functions, the build locks).

The pinned difference: ``In(shared, update=u)`` leaves the shared
variable implicit in the port, where the JAX package also counts it as an
explicit input whose value it never reads
(``test_in_shared_update_is_implicit``).
"""

import io
import pickle
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import pytensor_tpu as jptt
import pytensor_tpu.compile.sharedvalue as jshared
import pytensor_tpu.misc.pkl_utils as jpkl
import pytensor_tpu.tensor as jpt
import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.compile.sharedvalue as tshared
import pytensor_tpu_torch.misc.pkl_utils as tpkl
import pytensor_tpu_torch.tensor as tpt


class Pkg:
    """One package's names, as the cases below use them."""

    def __init__(self, name, ptt, pt, shared_mod, pkl, kw):
        self.name, self.ptt, self.pt, self.pkl, self.kw = name, ptt, pt, pkl, kw
        self._shared = shared_mod.shared
        self.In, self.Out = ptt.In, ptt.Out

    def function(self, *args, **kw):
        return self.ptt.function(*args, **self.kw, **kw)

    def shared(self, value, name=None):
        return self._shared(value, name=name, **self.kw)

    def train_loop(self, *args, **kw):
        return self.ptt.train_loop(*args, **self.kw, **kw)


JAX = Pkg("jax", jptt, jpt, jshared, jpkl, {})
PORT = Pkg("torch", tptt, tpt, tshared, tpkl, {"device": "cpu"})


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if isinstance(v, (list, tuple)):
        return [_np(x) for x in v]
    return np.asarray(v)


def raised(call):
    """The exception's kind, or None when ``call`` returns."""
    try:
        call()
    except Exception as e:  # noqa: BLE001 - the kind is what is compared
        return "TypeError or ValueError" if isinstance(e, (TypeError, ValueError)) \
            else type(e).__name__
    return None


def held(got, want, what=""):
    if isinstance(want, (list, tuple)) and not isinstance(want, np.ndarray):
        assert isinstance(got, (list, tuple)) and len(got) == len(want), (what, got, want)
        for k, (g, w) in enumerate(zip(got, want)):
            held(g, w, f"{what}[{k}]")
        return
    if want is None or isinstance(want, (str, bool)):
        assert got == want, (what, got, want)
        return
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert str(got.dtype) == str(want.dtype), (what, got.dtype, want.dtype)
    if got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        rtol = 1e-6 if got.dtype == np.float32 else 1e-12
        np.testing.assert_allclose(got, want, rtol=rtol, atol=0, err_msg=what)


# --- tests/test_compile_contracts.py ------------------------------------------

def in_with_default_value(P):
    x, y = P.pt.dscalar("x"), P.pt.dscalar("y")
    f = P.function([x, P.In(y, value=2.0)], x + y)
    return [f(3.0), f(3.0, 10.0)]


def in_named_keyword_call(P):
    x, y = P.pt.dscalar("x"), P.pt.dscalar("y")
    f = P.function([P.In(x, name="a"), P.In(y, name="b", value=1.0)], x - y)
    return [f(5.0, b=2.0), f(a=4.0), "a" in f, "x" in f]


def strict_input_rejects_downcast(P):
    x = P.pt.tensor("x", dtype="float32", shape=(2,))
    f = P.function([P.In(x, strict=True)], x * 2)
    return [raised(lambda: f(np.zeros(2, dtype="float64"))), f(np.ones(2, dtype="float32"))]


def allow_downcast_accepts(P):
    x = P.pt.tensor("x", dtype="float32", shape=(2,))
    f = P.function([P.In(x, allow_downcast=True)], x * 2)
    g = P.function([x], x * 2, allow_input_downcast=True)
    h = P.function([x], x * 2)
    v = np.array([1.0, 2.5])
    return [f(v), g(v), raised(lambda: h(v))]


def in_update(P):
    x = P.pt.dscalar("x")
    s = P.shared(np.asarray(1.0), name="s")
    f = P.function([x], s, updates=[(s, s + x)])
    return [f(2.0), f(3.0), s.get_value()]


def givens_replaces_subgraph(P):
    x, y = P.pt.dvector("x"), P.pt.dvector("y")
    f = P.function([y], P.pt.sum(x ** 2), givens={x: y * 2})
    return [f(np.array([1.0, 2.0]))]


def givens_with_constant(P):
    x, y = P.pt.dscalar("x"), P.pt.dscalar("y")
    f = P.function([y], x + y, givens={x: np.float64(10.0)})
    return [f(1.0)]


def givens_shared_substitution(P):
    s = P.shared(np.asarray(3.0), name="s")
    t = P.shared(np.asarray(7.0), name="t")
    x = P.pt.dscalar("x")
    f = P.function([x], x * s, givens={s: t})
    return [f(2.0)]


def update_ordering_consistent(P):
    a = P.shared(np.asarray(1.0), name="a")
    b = P.shared(np.asarray(10.0), name="b")
    f = P.function([], [], updates=[(a, a + b), (b, b + a)])
    f()
    return [a.get_value(), b.get_value()]


def update_with_explicit_input_dependency(P):
    w = P.shared(np.zeros(3), name="w")
    g = P.pt.dvector("g")
    f = P.function([g], [], updates=[(w, w - 0.5 * g)])
    f(np.ones(3))
    return [w.get_value()]


def updates_dict_form(P):
    c = P.shared(np.asarray(0), name="c")
    f = P.function([], c, updates={c: c + 1})
    return [f(), f(), f(), c.get_value()]


def no_update_leak_between_functions(P):
    s = P.shared(np.asarray(5.0), name="s")
    f1 = P.function([], s, updates=[(s, s * 2)])
    f2 = P.function([], s)
    f1()
    return [f2()]


def copy_independent_updates(P):
    s = P.shared(np.asarray(1.0), name="s")
    f = P.function([], s, updates=[(s, s + 1)])
    g = f.copy(share_memory=False)
    f()
    f()
    return [g(), g(), s.get_value()]


def copy_share_memory(P):
    s = P.shared(np.asarray(1.0), name="s")
    f = P.function([], s, updates=[(s, s + 1)])
    g = f.copy(share_memory=True)
    f()
    return [g(), s.get_value()]


def copy_swap_shared(P):
    s = P.shared(np.asarray(2.0), name="s")
    t = P.shared(np.asarray(5.0), name="t")
    x = P.pt.dscalar("x")
    f = P.function([x], x * s)
    g = f.copy(swap={s: t})
    return [f(1.0), g(1.0)]


def copy_delete_updates(P):
    s = P.shared(np.asarray(1.0), name="s")
    f = P.function([], s, updates=[(s, s + 1)])
    g = f.copy(delete_updates=True, share_memory=True)
    g()
    g()
    return [s.get_value(), g.name == f.name]


def function_roundtrip(P):
    x = P.pt.dvector("x")
    s = P.shared(np.array([1.0, 2.0]), name="s")
    f = P.function([x], P.pt.sum(x * s))
    f2 = pickle.loads(pickle.dumps(f))
    v = np.array([3.0, 4.0])
    return [f(v), f2(v)]


def pickled_function_keeps_shared_value(P):
    s = P.shared(np.asarray(42.0), name="s")
    f = P.function([], s * 2)
    return [pickle.loads(pickle.dumps(f))()]


def pickled_function_updates_its_own_shared(P):
    s = P.shared(np.asarray(1.0), name="s")
    f = P.function([], s, updates=[(s, s + 1)])
    f2 = pickle.loads(pickle.dumps(f))
    return [f2(), f2(), f2(), s.get_value()]


def zip_dump_load(P):
    s = P.shared(np.arange(4.0), name="s")
    x = P.pt.dvector("x")
    f = P.function([x], P.pt.sum(x + s))
    buf = io.BytesIO()
    P.pkl.dump(f, buf)
    buf.seek(0)
    f2 = P.pkl.load(buf)
    v = np.ones(4)
    return [f(v), f2(v)]


def on_unused_input_raise_default(P):
    x, y = P.pt.dscalar("x"), P.pt.dscalar("y")
    return [raised(lambda: P.function([x, y], x * 2))]


def missing_input_error(P):
    x, y = P.pt.dscalar("x"), P.pt.dscalar("y")
    return [raised(lambda: P.function([x], x + y)) is not None]


def output_list_vs_single(P):
    x = P.pt.dscalar("x")
    r1 = P.function([x], x * 2)(3.0)
    r2 = P.function([x], [x * 2])(3.0)
    return [isinstance(r1, (list, tuple)), isinstance(r2, (list, tuple)) and len(r2) == 1, r1,
            r2[0]]


def duplicate_updates_rejected(P):
    s = P.shared(np.asarray(1.0), name="s")
    return [raised(lambda: P.function([], [], updates=[(s, s + 1), (s, s + 2)]))]


def profile_collects(P):
    x = P.pt.dvector("x")
    f = P.function([x], P.pt.sum(P.pt.exp(x)), profile=True)
    return [f(np.ones(4)), f.profile is not None]


def out_borrow_accepted(P):
    x = P.pt.dvector("x")
    f = P.function([x], P.Out(P.pt.exp(x), borrow=True))
    return [f(np.zeros(2))]


# --- tests/test_function.py ---------------------------------------------------

def basic_function(P):
    x, y = P.pt.dscalar("x"), P.pt.dscalar("y")
    return [P.function([x, y], x + y)(2.0, 3.0)]


def multiple_outputs(P):
    x = P.pt.dvector("x")
    return P.function([x], [x.sum(), x.max()])(np.array([1.0, 5.0, 2.0]))


def named_inputs(P):
    x, y = P.pt.dscalar("x"), P.pt.dscalar("y")
    f = P.function([x, y], x - y)
    return [f(y=1.0, x=3.0), raised(lambda: f(z=1.0, x=3.0)), raised(lambda: f(3.0))]


def shared_and_updates(P):
    acc = P.shared(np.float64(0.0), name="acc")
    inc = P.pt.dscalar("inc")
    f = P.function([inc], acc, updates={acc: acc + inc})
    out = [f(1.0), f(10.0), acc.get_value()]
    acc.set_value(100.0)
    return out + [f(1.0)]


def givens(P):
    x, y = P.pt.dscalar("x"), P.pt.dscalar("y")
    return [P.function([y], x * 2, givens={x: y + 1})(3.0)]


def unused_input_policy(P):
    x, y = P.pt.dscalar("x"), P.pt.dscalar("y")
    err = raised(lambda: P.function([x, y], x * 2))
    f = P.function([x, y], x * 2, on_unused_input="ignore")
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        g = P.function([x, y], x * 3, on_unused_input="warn")
    return [err, f(1.0, 99.0), g(1.0, 99.0), len(caught) > 0]


def no_explicit_inputs(P):
    s = P.shared(np.arange(3.0))
    return [P.function([], s.sum())()]


def input_validation(P):
    x = P.pt.dmatrix("x")
    f = P.function([x], x.sum())
    return [raised(lambda: f(np.zeros(3)))]


def default_updates(P):
    s = P.shared(np.float64(0.0), name="s")
    s.default_update = s + 1
    f = P.function([], s)
    f()
    f()
    g = P.function([], s, no_default_updates=True)
    g()
    return [s.get_value()]


def trust_input_fastpath(P):
    x = P.pt.dvector("x")
    f = P.function([x], x * 2)
    f.trust_input = True
    v = np.arange(3.0) if P is JAX else torch.arange(3.0, dtype=torch.float64)
    return [f(v)]


def constant_output(P):
    x = P.pt.dscalar("x")
    return [P.function([x], P.pt.constant(7.0), on_unused_input="ignore")(0.0)]


def shared_in_two_functions(P):
    w = P.shared(np.zeros(2), name="w")
    f1 = P.function([], w.sum(), updates={w: w + 1})
    f2 = P.function([], w.sum())
    f1()
    return [f2()]


def _train_build(P):
    rng = np.random.default_rng(0)
    Xv = rng.standard_normal((32, 4))
    yv = (rng.random(32) < 0.5).astype("float64")
    w = P.shared(np.zeros(4), name="w")
    b = P.shared(np.zeros(()), name="b")
    X, y = P.pt.dmatrix("X"), P.pt.dvector("y")
    p = P.pt.sigmoid(P.pt.dot(X, w) + b)
    loss = -P.pt.mean(y * P.pt.log(p + 1e-9) + (1 - y) * P.pt.log(1 - p + 1e-9))
    gw, gb = P.ptt.grad(loss, [w, b])
    return (X, y), loss, [(w, w - 0.1 * gw), (b, b - 0.1 * gb)], (w, b), (Xv, yv)


def train_loop_matches_k_sequential_calls(P):
    (X, y), loss, upd, (w, b), (Xv, yv) = _train_build(P)
    f = P.function([X, y], loss, updates=upd)
    losses = [f(Xv, yv) for _ in range(8)]
    out = losses + [w.get_value(), b.get_value()]
    w.set_value(np.zeros(4))
    b.set_value(np.zeros(()))
    g = P.train_loop([X, y], loss, upd, n_steps=8)
    return out + [g(Xv, yv), w.get_value(), b.get_value()]


def train_loop_no_outputs_updates_only(P):
    (X, y), _, upd, (w, b), (Xv, yv) = _train_build(P)
    P.train_loop([X, y], None, upd, n_steps=3)(Xv, yv)
    return [w.get_value(), b.get_value()]


def train_loop_requires_updates(P):
    x = P.pt.dvector("x")
    return [raised(lambda: P.train_loop([x], x.sum(), [], n_steps=3))]


def train_loop_nested_scan_body(P):
    import importlib

    rnn = importlib.import_module(P.ptt.__name__ + ".models.rnn")
    f, (Xv, yv), _ = rnn.make_elman_rnn_bptt(seq_len=8, n_in=4, n_hidden=8, dtype="float64",
                                              n_steps_per_call=4, **P.kw)
    return [f(Xv, yv), f(Xv, yv)]


def train_loop_copy(P):
    (X, y), loss, upd, (w, b), (Xv, yv) = _train_build(P)
    g = P.train_loop([X, y], loss, upd, n_steps=4)
    c = g.copy()
    first = [c(Xv, yv), w.get_value()]
    return first + [g(Xv, yv), c(Xv, yv), w.get_value()]


CASES = [in_with_default_value, in_named_keyword_call, strict_input_rejects_downcast,
         allow_downcast_accepts, in_update, givens_replaces_subgraph, givens_with_constant,
         givens_shared_substitution, update_ordering_consistent,
         update_with_explicit_input_dependency, updates_dict_form,
         no_update_leak_between_functions, copy_independent_updates, copy_share_memory,
         copy_swap_shared, copy_delete_updates, function_roundtrip,
         pickled_function_keeps_shared_value, pickled_function_updates_its_own_shared,
         zip_dump_load, on_unused_input_raise_default, missing_input_error,
         output_list_vs_single, duplicate_updates_rejected, profile_collects,
         out_borrow_accepted, basic_function, multiple_outputs, named_inputs,
         shared_and_updates, givens, unused_input_policy, no_explicit_inputs,
         input_validation, default_updates, trust_input_fastpath, constant_output,
         shared_in_two_functions, train_loop_matches_k_sequential_calls,
         train_loop_no_outputs_updates_only, train_loop_requires_updates,
         train_loop_nested_scan_body, train_loop_copy]


@pytest.mark.parametrize("case", CASES, ids=[c.__name__ for c in CASES])
def test_case_in_both_packages(case):
    want = case(JAX)
    got = case(PORT)
    held(got, want, case.__name__)


def test_in_shared_update_is_implicit():
    """``In(s, update=s + x)`` updates ``s``; the JAX package also counts
    ``s`` as an explicit input whose value it never reads (pinned)."""
    outs = {}
    for P in (JAX, PORT):
        x = P.pt.dscalar("x")
        s = P.shared(np.asarray(1.0), name="s")
        f = P.function([x, P.In(s, update=s + x)], s * 2)
        args = (2.0, 123.0) if P is JAX else (2.0,)
        outs[P.name] = [f(*args), f(*args), s.get_value()]
        with pytest.raises(TypeError):
            P.function([x, P.In(P.shared(np.asarray(1.0)))], x)
    held(outs["torch"], outs["jax"])


# --- the radon graph under each mode ----------------------------------------

@pytest.mark.parametrize("mode,n_nodes", [("FAST_COMPILE", 93), ("PY", 53), ("FAST_RUN", 53)])
def test_radon_under_each_mode_op_for_op(mode, n_nodes):
    from pytensor_tpu.models.radon import make_radon_graphs as jgraphs
    from pytensor_tpu_torch.models.radon import make_radon_graphs as tgraphs
    from pytensor_tpu_torch.models.radon import theta_start

    fns = {}
    for P, graphs in ((JAX, jgraphs), (PORT, tgraphs)):
        ins, outs, n = graphs(919, 85, "float64")
        fns[P.name] = P.function(ins, outs, mode=mode)
    ops = {k: [type(nd.op).__name__ for nd in f.fgraph.toposort()] for k, f in fns.items()}
    assert ops["torch"] == ops["jax"] and len(ops["torch"]) == n_nodes
    if mode == "FAST_COMPILE":
        assert "FusedElemwise" not in ops["torch"]
    linked = fns["torch"].linked
    assert type(linked).__name__ == "Plan"  # the "py" and the CPU's torch linker: eager
    th = theta_start(n, "float64") + 0.1 * np.random.default_rng(3).standard_normal(n)
    held(fns["torch"](th), fns["jax"](th), mode)


def test_modes_and_their_registries():
    from pytensor_tpu_torch.compile import mode as m
    from pytensor_tpu_torch.compile.maker import FunctionMaker, predict_function_backend
    from pytensor_tpu_torch.link.torch.linker import PyLinker, TorchLinker

    assert m.get_mode("FAST_COMPILE") is m.FAST_COMPILE and m.get_default_mode() is m.FAST_RUN
    assert isinstance(m.FAST_COMPILE.make_linker(), PyLinker)
    assert isinstance(m.FAST_RUN.make_linker(), TorchLinker)
    assert (m.C.linker, m.CVM, m.JAX, m.NUMBA, m.PYTORCH, m.MLX) == (
        "py", m.C, m.FAST_RUN, m.FAST_RUN, m.FAST_RUN, m.FAST_RUN)
    assert predict_function_backend("PY") == "py" == jptt.compile.maker.predict_function_backend(
        "PY")
    with pytest.raises(ValueError):
        m.get_mode("DEBUG")
    # a mode from a tag name, "None" selecting no rewrite
    x = tpt.dvector("x")
    bare = tptt.function([x], tpt.exp(x) * 1.0, mode=m.Mode("py", "None"), device="cpu")
    assert len(bare.fgraph.apply_nodes) == 2
    assert "fast_run" in m.FAST_RUN.requiring("fast_run")._optimizer.require

    class Count(m.GraphRewriter):
        runs = 0

        def apply(self, fgraph):
            Count.runs += 1

    tptt.function([x], tpt.exp(x), mode=m.FAST_RUN.register(Count()), device="cpu")
    assert Count.runs == 1
    m.register_mode("MINE", m.Mode("py", "fast_compile"))
    m.register_optimizer("mine", m.OPT_MERGE)
    m.register_linker("mine", PyLinker)
    assert m.get_mode("MINE").linker == "py" and m.predefined_optimizers["mine"] is m.OPT_MERGE
    assert isinstance(m.Mode("mine").make_linker(), PyLinker)
    f = tptt.function([x], tpt.exp(x), mode="MINE", device="cpu")
    assert float(f(np.zeros(3)).sum()) == 3.0
    maker = FunctionMaker([x], tpt.exp(x), mode="FAST_COMPILE", device="cpu")
    assert float(maker.create()(np.zeros(2)).sum()) == 2.0
    # AddFeatureOptimizer attaches its feature
    from pytensor_tpu_torch.graph.features import Feature

    feat = Feature()
    f = tptt.function([x], tpt.exp(x), mode=m.FAST_RUN.register(m.AddFeatureOptimizer(feat)),
                      device="cpu")
    assert feat in f.fgraph._features
    with tptt.config.change_flags(mode="FAST_COMPILE"):
        assert tptt.function([x], tpt.exp(x) * 2, device="cpu").mode is m.FAST_COMPILE


def test_function_records_and_accessors():
    x = tpt.dvector("x")
    s = tptt.shared(np.ones(3), name="s", device="cpu")
    f = tptt.function([tptt.In(x, name="a")], tpt.sum(x * s), name="f", device="cpu")
    assert f.maker is f and f.get_shared() == [s] and "a" in f and "b" not in f
    assert f.compile_time >= f.rewrite_time > 0 and f.rewrite_profile
    assert f._spec["name"] == "f" and f._spec["mode"] is tptt.FAST_RUN
    f(np.ones(3))
    f(a=np.ones(3))
    assert f.call_count == 2
    f.free()
    assert float(f(np.ones(3))) == 3.0
    assert str(f) == "Function(f, device=cpu)"


# --- pickling ------------------------------------------------------------------

def test_pickled_scan():
    """``tests/test_ref_scan2.py:133`` in both packages."""
    rng = np.random.default_rng(7)
    st = np.float32(rng.uniform())
    outs = {}
    for P in (JAX, PORT):
        state, n_steps = P.pt.scalar("state"), P.pt.iscalar("nsteps")
        out = P.ptt.scan(lambda x: 2 * x, [], state, [], n_steps=n_steps,
                         return_updates=False)
        f1 = pickle.loads(pickle.dumps(P.function([state, n_steps], out), protocol=-1))
        outs[P.name] = f1(st, np.int32(5))
    held(outs["torch"], outs["jax"])
    np.testing.assert_allclose(_np(outs["torch"]), [st * 2 ** (k + 1) for k in range(5)],
                               rtol=1e-6)


def test_pickled_leapfrog_chain_and_fused_graph():
    """The chain (a Scan) and the radon function (FusedElemwise nodes)
    reload and give the same bits; no pickle holds a signature cache."""
    from pytensor_tpu_torch.models.radon import make_leapfrog_chain, make_radon_graphs, \
        theta_start

    chain = make_leapfrog_chain("float32", None, 8, 40, 5, device="cpu")
    th = torch.from_numpy(theta_start(9, "float32"))
    blob = pickle.dumps(chain)
    assert len(blob) < 500_000
    again = pickle.loads(blob)
    for a, b in zip(chain(th, torch.ones(9)), again(th, torch.ones(9))):
        assert torch.equal(a, b)
    ins, outs, n = make_radon_graphs(40, 5, "float64")
    f = tptt.function(ins, outs, device="cpu")
    assert any(type(nd.op).__name__ == "FusedElemwise" for nd in f.fgraph.apply_nodes)
    g = pickle.loads(pickle.dumps(f))
    th64 = theta_start(n, "float64")
    for a, b in zip(f(th64), g(th64)):
        assert torch.equal(a, b)


def test_pkl_utils_round_trips():
    """``dump``/``load`` of a graph and of a function with a default
    update (an RNG key), ``dump_function``/``load_function`` with another
    mode, and ``StripPickler`` leaving the creation trace out."""
    x = tpt.dvector("x")
    s = tptt.shared(np.arange(3.0), name="s", device="cpu")
    s.default_update = s * 2
    y = tpt.sum(x * s)
    buf = io.BytesIO()
    tpkl.dump([x, y], buf)
    buf.seek(0)
    x2, y2 = tpkl.load(buf)
    (s2,) = [v for v in tptt.graph.traversal.graph_inputs([y2])
             if isinstance(v, tshared.SharedVariable)]
    assert s2 is not s and s2.default_update is not None and s2.name == "s"
    f = tptt.function([x], y, device="cpu")
    buf = io.BytesIO()
    tpkl.dump_function(f, buf)
    buf.seek(0)
    g = tpkl.load_function(buf, mode="FAST_COMPILE")
    v = np.ones(3)
    assert type(g.linked).__name__ == "Plan" and g.mode is tptt.FAST_COMPILE
    assert [float(g(v)), float(g(v))] == [3.0, 6.0]  # its own s, doubled each call
    assert torch.equal(s.get_value(), torch.arange(3.0, dtype=torch.float64))
    import ml_dtypes

    bf16 = tptt.shared(np.array([1.5, -2.25, 3.0], dtype=ml_dtypes.bfloat16), device="cpu")
    buf = io.BytesIO()
    tpkl.dump(bf16, buf)
    buf.seek(0)
    again = tpkl.load(buf)
    assert again.type == bf16.type and torch.equal(again.get_value(), bf16.get_value())
    out = io.BytesIO()
    tpkl.StripPickler(out).dump(y)
    assert b"trace" not in out.getvalue()
    assert pickle.loads(out.getvalue()).type == y.type


def test_shared_recorded_on_cuda_refuses_to_load_without_it():
    """A shared value pickles with its device; loading it, or a function
    recorded for that device, where the device is absent raises: nothing
    lands on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("there is a CUDA device to load onto")
    s = tptt.shared(np.arange(3.0), name="s", device="cpu")
    load, args, state = s.__reduce__()
    assert args[-1] == "cpu"

    class OnCuda:
        def __reduce__(self):
            return load, (*args[:-1], "cuda"), state

    with pytest.raises(RuntimeError, match="cuda"):
        pickle.loads(pickle.dumps(OnCuda()))
    f = tptt.function([], s * 2, device="cpu")
    rebuild, (payload,) = f.__reduce__()
    assert payload["device"] == "cpu"
    with pytest.raises(RuntimeError, match="cuda"):
        rebuild(dict(payload, device="cuda"))


# --- profiling ---------------------------------------------------------------

@pytest.mark.parametrize("mode", ["PY", "FAST_RUN"])
def test_profile_under_each_linker(mode):
    from pytensor_tpu_torch.compile.debug.profiling import ProfileStats, estimate_node_cost

    x = tpt.dmatrix("x")
    w = tpt.dmatrix("w")
    x_s = tpt.specify_shape(x, (4, 3))
    w_s = tpt.specify_shape(w, (3, 2))
    f = tptt.function([x, w], tpt.sum(tpt.exp(tpt.dot(x_s, w_s))), mode=mode, profile=True,
                      device="cpu")
    xv, wv = np.ones((4, 3)), np.ones((3, 2))
    for _ in range(3):
        got = f(xv, wv)
    np.testing.assert_allclose(float(got), 8 * np.exp(3.0), rtol=1e-12)
    stats = f.profile
    assert isinstance(stats, ProfileStats) and stats.call_count == 3 and stats.call_time > 0
    assert stats.xla_cost is None and stats.peak_bytes is None  # no card here
    assert stats.rewrite_pass_times and stats.compile_time == f.compile_time
    # the static table: the product's 2 m k n flops (both packages' rule)
    dots = [r for r in stats.op_table if "Dot" in r[0]]
    assert dots and dots[0][2] == 2 * 4 * 3 * 2
    node = next(nd for nd in f.fgraph.apply_nodes if "Dot" in type(nd.op).__name__)
    from pytensor_tpu.compile.debug.profiling import estimate_node_cost as jcost

    jx, jw = jpt.specify_shape(jpt.dmatrix("x"), (4, 3)), jpt.specify_shape(jpt.dmatrix("w"),
                                                                            (3, 2))
    assert estimate_node_cost(node)[0] == jcost(jpt.dot(jx, jw).owner)[0]
    if mode == "PY":  # each node timed, as the JAX package's oracle times each thunk
        assert sum(stats.op_calls.values()) == 3 * len(f.fgraph.apply_nodes)
    else:
        assert not stats.op_time
    text = stats.summary(file=io.StringIO())
    assert "calls: 3" in text and "per-op static cost" in text


def test_config_profile_profiles_every_function():
    x = tpt.dvector("x")
    with tptt.config.change_flags(profile=True, profile_optimizer=True):
        f = tptt.function([x], tpt.exp(x), device="cpu")
    assert f.profile is not None
    from pytensor_tpu_torch.compile.debug import profiling

    assert f.profile in profiling._all_stats
    profiling._all_stats.remove(f.profile)
    assert tptt.function([x], tpt.exp(x), device="cpu").profile is None


# --- the matmul-precision flags ----------------------------------------------

@pytest.mark.parametrize("flag,value,settings", [
    ("matmul_precision", "default", (False, False)),
    ("matmul_precision", "highest", (False, False)),
    ("matmul_precision", "float32", (False, False)),
    ("matmul_precision", "high", (True, False)),
    ("matmul_precision", "bfloat16", (True, True)),
    ("xla__matmul_precision", "tensorfloat32", (True, False)),
    ("xla__matmul_precision", "bfloat16", (True, True)),
    ("xla__matmul_precision", "highest", (False, False)),
])
def test_matmul_precision_flags(flag, value, settings):
    from pytensor_tpu_torch.config import config, matmul_settings

    assert config.matmul_precision == config.xla__matmul_precision == "default"
    assert matmul_settings() == (False, False)
    with config.change_flags(**{flag: value}):
        assert matmul_settings() == settings
        # the JAX package's flags take the same values
        assert value in jptt.config._params[flag].options
    if flag == "matmul_precision":
        # xla__matmul_precision is read first
        with config.change_flags(matmul_precision=value, xla__matmul_precision="float32"):
            assert matmul_settings() == (False, False)
    with pytest.raises(ValueError):
        config.matmul_precision = "medium"


# --- the smaller modules --------------------------------------------------------

def test_aliasing_contracts():
    from pytensor_tpu_torch.compile.aliasing import (
        Supervisor,
        add_supervisor_to_fgraph,
        infer_reuse_pattern,
        insert_deepcopy,
    )
    from pytensor_tpu_torch.graph.fg import FunctionGraph

    x = tpt.dmatrix("x")
    y = x.T[0]
    fg = FunctionGraph([x], [y], clone=False)
    add_supervisor_to_fgraph(fg, [tptt.In(x)])
    assert isinstance(fg._supervisor, Supervisor) and fg._supervisor.protected == [x]
    fg._supervisor.validate(fg)
    assert insert_deepcopy(fg, [], []) is fg
    chain = infer_reuse_pattern(fg, [y])
    assert y in chain
    jx = jpt.dmatrix("x")
    from pytensor_tpu.compile.aliasing import infer_reuse_pattern as jreuse
    from pytensor_tpu.graph.fg import FunctionGraph as JFG

    jy = jx.T[0]
    assert len(jreuse(JFG([jx], [jy], clone=False), [jy])) == len(chain)


def test_inner_function_runs_the_py_linker():
    from pytensor_tpu_torch.compile.inner_function import HasInnerFunction
    from pytensor_tpu_torch.graph.fg import FunctionGraph

    class Inner(HasInnerFunction):
        def __init__(self, fgraph):
            self.fgraph = fgraph

    x = tpt.dvector("x")
    op = Inner(FunctionGraph([x], [tpt.exp(x) * 1.0]))
    fn = op.fn("cpu")
    assert fn is op.fn("cpu") and type(fn.linked).__name__ == "Plan"
    assert len(fn.fgraph.apply_nodes) == 2  # unrewritten
    out = [[None]]
    op.perform(None, [np.zeros(2)], out)
    np.testing.assert_array_equal(out[0][0], np.ones(2))


def test_compilelock(tmp_path):
    import threading

    from pytensor_tpu_torch.compile.compilelock import force_unlock, lock_ctx

    order = []

    def hold(tag):
        with lock_ctx(tmp_path, "_k"):
            order.append((tag, "in"))
            order.append((tag, "out"))

    threads = [threading.Thread(target=hold, args=(k,)) for k in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # never two holders at once
    assert all(order[2 * k][0] == order[2 * k + 1][0] for k in range(4))
    with lock_ctx(tmp_path, "_held"):
        force_unlock(tmp_path)
        assert (tmp_path / ".lock_held").exists()
    force_unlock(tmp_path)
    assert not list(tmp_path.glob(".lock*"))


def test_copy_of_the_sparse_power_iteration():
    """``train_loop``'s function copied three ways: each copy's outputs
    are the original's from the same state, and only its own shared
    tensor moves."""
    rng = np.random.default_rng(0)
    n = 300
    A = sp.random(n, n, density=10 / n, format="csr", random_state=rng, dtype="float32")
    x0 = rng.standard_normal((n, 1)).astype("float32")
    from pytensor_tpu_torch.sparse import as_sparse_variable, structured_dot

    xsh = tptt.shared(x0, device="cpu")
    y = structured_dot(as_sparse_variable(A), xsh)
    f = tptt.train_loop([], tpt.sum(y), {xsh: y / (tpt.max(tpt.abs(y)) + 1e-9)}, n_steps=8,
                        device="cpu")
    x2 = tptt.shared(x0.copy(), device="cpu")
    plain, swapped, frozen = f.copy(), f.copy(swap={xsh: x2}), f.copy(delete_updates=True)
    want = f()
    moved = xsh.get_value()
    for g in (plain, swapped, frozen):
        assert torch.equal(g(), want)
    assert torch.equal(plain.shared_vars[0].get_value(), moved)
    assert torch.equal(x2.get_value(), moved)
    assert torch.equal(frozen.shared_vars[0].get_value(), torch.from_numpy(x0))
    assert torch.equal(xsh.get_value(), moved)  # no copy moved the original's
    assert torch.equal(frozen(), want)


def test_the_new_modules_import_no_jax():
    """The compile driver's modules, imported and run in a fresh process,
    bring in nothing of JAX or of the JAX package."""
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys, io, pickle, numpy as np; "
            "import pytensor_tpu_torch as ptt, pytensor_tpu_torch.tensor as pt; "
            "import pytensor_tpu_torch.compile.aliasing, pytensor_tpu_torch.compile.compilelock, "
            "pytensor_tpu_torch.compile.inner_function, pytensor_tpu_torch.compile.builders; "
            "from pytensor_tpu_torch.misc import pkl_utils; "
            "x = pt.dvector('x'); s = ptt.shared(np.ones(2), device='cpu'); "
            "f = ptt.function([x], ptt.Rop(pt.sum(x * s), x, x), mode='FAST_COMPILE', "
            "profile=True, device='cpu'); f(np.ones(2)); pickle.loads(pickle.dumps(f)).copy(); "
            "b = io.BytesIO(); pkl_utils.dump_function(f, b); b.seek(0); "
            "pkl_utils.load_function(b)(np.ones(2)); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pytensor_tpu')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr

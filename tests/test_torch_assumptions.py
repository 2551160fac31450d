"""The port's assumptions engine against the JAX package's, on the CPU.

Each case of ``tests/test_assumptions_inference.py`` and
``tests/test_assumptions_scenarios.py`` runs twice: as the JAX package's
test function, and as the same function with its module's names
(``pt``, ``ptl``, ``ptt``, ``holds``, ``assume``, ``holds_in``,
``AssumptionFeature``, ``FactState``) bound to the port's.  Every
``holds`` query of the two runs is recorded, and the facts must be the
same, query for query; the asserts of the case hold in both runs.  The
port's ``function`` is called with ``device="cpu"``.  The cases that
import from the JAX package inside their body are written out below for
the port (the Blockwise rule, the feature's cache).  ``Assert`` removal
(``local_remove_proven_assert``) runs in both packages in
``tests/test_torch_raise_op.py``.  Not ported, so not run on the port:
the symmetric-``eig`` dispatch (``Eig``, ROADMAP.md Queue 1 item 17),
whose port raises ``NotImplementedError``.
"""

import functools
import types

import pytest

import pytensor_tpu.assumptions as jas

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.assumptions as tas
import pytensor_tpu_torch.tensor as tpt
import pytensor_tpu_torch.tensor.linalg as tptl

import test_assumptions_inference as inference
import test_assumptions_scenarios as scenarios

# the cases whose body imports from the JAX package or runs what the
# port does not have; the first two are written out for the port below
BY_HAND = {"test_blockwise_cholesky_lower_triangular", "test_feature_caches_and_invalidates",
           "test_assert_removal", "test_symmetric_eig_dispatch"}


class _PortFunctions:
    """``pytensor_tpu_torch`` with ``function`` linked for the CPU."""

    def __getattr__(self, name):
        if name == "function":
            return functools.partial(tptt.function, device="cpu")
        return getattr(tptt, name)


def _cases():
    out = []
    for mod in (inference, scenarios):
        for cname, cls in sorted(vars(mod).items()):
            if not (cname.startswith("Test") and isinstance(cls, type)):
                continue
            for name, fn in sorted(vars(cls).items()):
                if not name.startswith("test_") or name in BY_HAND:
                    continue
                params = [{}]
                for mark in getattr(fn, "pytestmark", ()):
                    if mark.name == "parametrize":
                        names = [n.strip() for n in mark.args[0].split(",")]
                        params = [dict(zip(names, v if len(names) > 1 else (v,)))
                                  for v in mark.args[1]]
                for k, p in enumerate(params):
                    out.append(pytest.param(fn, p, id=f"{mod.__name__[5:]}::{cname}::{name}"
                                            + (f"[{k}]" if len(params) > 1 else "")))
    return out


def _recording(holds, log):
    def recorded(var, fact, *args):
        res = holds(var, fact, *args)
        log.append((fact, int(res)))
        return res

    return recorded


def _run(fn, params, port):
    """The case ``fn`` with the JAX package's names, or with the port's;
    returns its ``holds`` queries and their facts."""
    log = []
    names = dict(fn.__globals__)
    if port:
        names.update(pt=tpt, ptl=tptl, ptt=_PortFunctions(), assume=tas.assume,
                     holds=_recording(tas.holds, log), FactState=tas.FactState,
                     holds_in=tas.holds_in, AssumptionFeature=tas.AssumptionFeature)
    else:
        names.update(holds=_recording(jas.holds, log))
    case = types.FunctionType(fn.__code__, names, fn.__name__, fn.__defaults__, fn.__closure__)
    case(None, **params)
    return log


@pytest.mark.parametrize("fn,params", _cases())
def test_facts_match_jax(fn, params):
    want = _run(fn, params, port=False)
    got = _run(fn, params, port=True)
    assert got == want


def test_blockwise_cholesky_lower_triangular():
    from pytensor_tpu_torch.tensor.blockwise import Blockwise
    from pytensor_tpu_torch.tensor.linalg import Cholesky

    A = tpt.tensor("A", dtype="float64", shape=(5, 3, 3))
    L = Blockwise(Cholesky(lower=True), signature="(n,n)->(n,n)")(A)
    assert tas.holds(L, "lower_triangular") == tas.FactState.TRUE
    assert tas.holds(L, "upper_triangular") == tas.FactState.FALSE


def test_feature_caches_and_invalidates():
    from pytensor_tpu_torch.graph.fg import FunctionGraph

    A = tpt.dmatrix("A")
    L = tptl.cholesky(A)
    fg = FunctionGraph([A], [L], clone=False)
    feat = tas.AssumptionFeature()
    fg.attach_feature(feat)
    assert tas.holds_in(fg, L, "lower_triangular") == tas.FactState.TRUE
    assert (L, "lower_triangular") in feat._cache
    feat.on_import(fg, L.owner, "test")
    assert not feat._cache


def test_feature_at_the_jax_packages_position():
    """``AssumeOpt`` sits in optdb at 0.11 with the same tags, so every
    rewrite sees the facts it sees in the JAX package."""
    from pytensor_tpu.compile.mode import optdb as joptdb

    from pytensor_tpu_torch.compile.mode import optdb as toptdb

    assert toptdb.positions["AssumeOpt"] == joptdb.positions["AssumeOpt"] == 0.11
    for db in (toptdb, joptdb):
        assert {"fast_run", "fast_compile"} <= db._tags["AssumeOpt"]


def test_eig_is_not_ported():
    with pytest.raises(NotImplementedError, match="Queue 1 item 17"):
        tptl.eig(tpt.dmatrix("A"))

"""The rewrites of ROADMAP Queue 1 item 6 in both packages.

Every ``def local_*`` rewrite of the JAX package's
``tensor/rewriting/{basic,subtensor,math,shape}.py`` is in the port, and
each of them is registered in the same databases with the same tags, in
the same order among the rewrites both packages hold.  On each probe graph
of ``pytensor_tpu_torch/link/cuda/rewrite_cases.py`` (built in both
packages at a small size in float64, ``tests/torch_rewrite_probe.py``)
the rewrite fires as often in the port as in the JAX package (the
ShapeFeature saves as many nodes), the rewritten graph and the graph
without the rewrite match op for op, and the values are the JAX
package's: bit for bit for the structural rewrites, within ``MOVER_RTOL``
for the four that move a product or a reduction, within ``VALUE_ULPS``
where a transcendental function of torch and of XLA differ.  The cases of
``tests/test_ref_rewriting_subtensor.py`` that name these rewrites run in
both packages too.
"""

import numpy as np
import pytest

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
from pytensor_tpu.compile import mode as jmode

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.compile import mode as tmode
from pytensor_tpu_torch.link.cuda.rewrite_cases import CASES, REGISTERED

from tests.torch_math_probe import _fired, ulps
from tests.torch_rewrite_probe import MOVER_RTOL, MOVERS, missing_names, ops_of, run

# the largest distance in ulps between the packages' values where the graph
# keeps a transcendental function, whose torch and XLA versions differ
VALUE_ULPS = {"reshape(exp(x), exp(x).shape)": 1, "cos(-x)": 1}

DBS = ("useless", "canonicalize", "stabilize", "specialize", "uncanonicalize")


def test_no_local_rewrite_is_missing():
    assert missing_names() == {"basic": [], "subtensor": [], "math": [], "shape": []}


def _registration(mode_module, names):
    """{name: [(database, tags, position among the names)]}."""
    out = {n: [] for n in names}
    for db_name in DBS:
        db = getattr(mode_module, db_name)
        order = [n for n in db._names if n in out]
        for n in order:
            out[n].append((db_name, sorted(db._tags[n]), order.index(n)))
    return out


def test_registered_alike():
    """Each rewrite of the probe under its registered name: the same
    databases, tags and order in both packages (the order among the
    rewrites both packages hold, so a rewrite of one package only cannot
    shift it)."""
    names = sorted({REGISTERED.get(c.rewrite, c.rewrite) for c in CASES} - {"ShapeOpt"})
    common = {n for db in DBS for n in getattr(jmode, db)._names
              if n in getattr(tmode, db)._names}
    jreg, treg = _registration(jmode, common), _registration(tmode, common)
    for n in names:
        assert treg[n] == jreg[n] and treg[n], n
    assert tmode.optdb.positions["ShapeOpt"] == 0.1 and tmode.optdb.positions["UnShapeOpt"] == 10
    assert {"fast_run", "fast_compile"} <= tmode.optdb._tags["ShapeOpt"]


@pytest.mark.parametrize("case", CASES, ids=[f"{c.rewrite}:{c.label}" for c in CASES])
def test_probe_graph(case):
    r = run(case)
    (fj, oj, vj, bj), (ft, ot, vt, bt) = r["jax"], r["torch"]
    assert ft == fj, (ft, fj)
    if case.rewrite == "shape_feature":
        assert fj > 0, "the feature's graph saves no node"
    else:
        assert fj > 0, "the rewrite does not fire in the JAX package"
    assert ot == oj
    assert bt == bj
    assert vt.dtype == vj.dtype and vt.shape == vj.shape
    ref = case.reference(*case.inputs(16, "float64"))
    if case.rewrite in MOVERS:
        scale = max(1.0, float(np.abs(vj).max()))
        assert float(np.abs(vt - vj).max()) <= MOVER_RTOL * scale
    elif vt.dtype.kind == "f":
        assert ulps(vt, vj) <= VALUE_ULPS.get(case.label, 0)
    else:
        np.testing.assert_array_equal(vt, vj)
    np.testing.assert_allclose(np.asarray(vt, "float64"), np.asarray(ref, "float64"),
                               rtol=1e-6, atol=1e-9)


# the cases of tests/test_ref_rewriting_subtensor.py that name these
# rewrites and compile with function(): TestUselessIncSubtensor,
# TestAddOfSparseWrite's set at unique constant indices, and
# TestReadOfWriteSameIndices' inc at unique constant rows: the same ops and
# bits, and no write left but the one local_add_of_sparse_write makes (the
# other cases drive one rewrite through rewrite_graph and in2out, which the
# probe graphs cover through FAST_RUN)
def _useless_inc(op, s):
    def build(t, x, y):
        w = t.set_subtensor if op == "set" else t.inc_subtensor
        return w(x[:, s], t.specify_shape(y, x.shape))
    return build


ROWS = np.array([0, 2, 3], dtype="int32")
REF_CASES = [
    *[("local_useless_inc_subtensor", f"{op}_subtensor(x[:, {s}], y)", _useless_inc(op, sl),
       [np.asarray([[2.0, 3.0]]), np.asarray([[3.0, 4.0]])])
      for op in ("set", "inc") for s, sl in (("::", slice(None)), ("::-1", slice(None, None, -1)))],
    ("local_useless_inc_subtensor", "inc_subtensor(x[:, :], y) full",
     lambda t, x, y: t.inc_subtensor(x[:, :], t.specify_shape(y, x.shape)),
     [np.asarray([[1.0, 2.0], [3.0, 4.0]]), np.asarray([[10.0, 20.0], [30.0, 40.0]])]),
    ("local_add_of_sparse_write", "x + zeros(x.shape)[[1, 3]].set(v)",
     lambda t, x, v: x + t.zeros(x.shape, dtype="float64")[np.array([1, 3])].set(v),
     [np.array([1.0, 2.0, 3.0, 4.0, 5.0]), np.array([10.0, 20.0])]),
    ("local_read_of_write_same_indices", "inc_subtensor(x[rows], y)[rows]",
     lambda t, x, y: t.inc_subtensor(x[t.constant(ROWS)], y)[t.constant(ROWS)],
     [np.random.default_rng(42).random((4, 5)), np.random.default_rng(43).random((3, 5))]),
]


@pytest.mark.parametrize("rewrite,label,build,vals", REF_CASES,
                         ids=[f"{c[0]}:{c[1]}" for c in REF_CASES])
def test_reference_subtensor_cases(rewrite, label, build, vals):
    counts, undo = _fired()
    got = {}
    try:
        for key, ptt, pt, kw in (("jax", jptt, jpt, {}), ("torch", tptt, tpt, {"device": "cpu"})):
            xs = [pt.tensor(f"x{k}", dtype="float64", shape=(None,) * v.ndim)
                  for k, v in enumerate(vals)]
            f = ptt.function(xs, build(pt, *xs), **kw)
            got[key] = (ops_of(f), np.asarray(f(*vals)))
    finally:
        undo()
    # on the full slices an earlier rewrite removes the write in both
    # packages, so the named one may fire 0 times there
    assert counts["torch"][rewrite] == counts["jax"][rewrite]
    assert got["torch"][0] == got["jax"][0]
    assert not any(o.startswith(("IncSubtensor", "AdvancedIncSubtensor"))
                   for o in got["torch"][0]) or rewrite == "local_add_of_sparse_write"
    np.testing.assert_array_equal(got["torch"][1], got["jax"][1])

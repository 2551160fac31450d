"""K1, the fused elementwise kernel: its plain version against the JAX
package's FusedElemwise, and the Triton source it emits.

The JAX side runs the FusedElemwise inline path (``pytensor_tpu/tensor/
fused.py:111-116``, the path taken with ``pallas__fusion`` off; no JAX test
runs the Pallas body on the CPU).  The port side runs
``FusedElemwiseKernel`` on CPU tensors, which is its plain version.  Both
get the same seeded numpy inputs.  Tolerance: float64 ``rtol 1e-12``,
float32 ``rtol 1e-5`` with ``atol 1e-6 * max|out|`` (torch and XLA may
order an n-ary add differently).  The kernel itself needs a card:
``tests/test_torch_cuda.py`` runs it.
"""

import numpy as np
import pytest
import torch

import pytensor_tpu.models.radon as jradon
import pytensor_tpu.tensor as jpt
from pytensor_tpu.compile.mode import FAST_RUN as J_FAST_RUN
from pytensor_tpu.graph.fg import FunctionGraph as JFunctionGraph
from pytensor_tpu.link.xla.dispatch import ensure_registered, xla_funcify
from pytensor_tpu.tensor.fused import FusedElemwise as JFused

import pytensor_tpu_torch.models.radon as tradon
import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.compile.mode import FAST_RUN as T_FAST_RUN
from pytensor_tpu_torch.graph.fg import FunctionGraph as TFunctionGraph
from pytensor_tpu_torch.tensor import fused_kernel
from pytensor_tpu_torch.tensor.fused import FusedElemwise as TFused
from pytensor_tpu_torch.tensor.fused import fusable

N_CHAINS = 8
TOL = {"float64": (1e-12, 0.0), "float32": (1e-5, 1e-6)}


def _fused_nodes(pkg_radon, fgraph_cls, fast_run, fused_cls, dtype, batched):
    if batched:
        theta, logp, dlogp, _ = pkg_radon.make_radon_logp_batched(dtype=dtype)
        inputs, outputs = [theta], [logp, dlogp]
    else:
        inputs, outputs, _ = pkg_radon.make_radon_graphs(dtype=dtype)
    fg = fgraph_cls(inputs, outputs, clone=True)
    fast_run.optimizer.rewrite(fg)
    return [nd for nd in fg.toposort() if isinstance(nd.op, fused_cls)]


def _inputs(types, seed):
    """Seeded positive values (the inner graphs take exp/log/div)."""
    rng = np.random.default_rng(seed)
    return [rng.uniform(0.5, 1.5, size=tuple(N_CHAINS if s is None else s for s in t.shape))
            .astype(t.dtype) for t in types]


def _jax_inline(jnode):
    ensure_registered()
    fn = xla_funcify(jnode.op, node=jnode)

    def run(*args):
        res = fn(*args)
        return [np.asarray(r) for r in (res if len(jnode.outputs) > 1 else [res])]

    return run


def _compare(jnode, tnode, dtype, seed):
    args = _inputs([i.type for i in jnode.inputs], seed)
    want = _jax_inline(jnode)(*args)
    kern = fused_kernel.FusedElemwiseKernel(tnode.op.fgraph, "cpu")
    got = kern(*[torch.from_numpy(a) for a in args])
    rtol, atol = TOL[dtype]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.from_numpy(w).dtype and tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol,
                                   atol=atol * max(1.0, float(np.max(np.abs(w)))))


@pytest.fixture(scope="module")
def radon_pairs():
    cache = {}

    def get(dtype, batched):
        if (dtype, batched) not in cache:
            jn = _fused_nodes(jradon, JFunctionGraph, J_FAST_RUN, JFused, dtype, batched)
            tn = _fused_nodes(tradon, TFunctionGraph, T_FAST_RUN, TFused, dtype, batched)
            assert [str(n.op) for n in jn] == [str(n.op) for n in tn]
            cache[dtype, batched] = list(zip(jn, tn))
        return cache[dtype, batched]

    return get


@pytest.mark.parametrize("dtype", ["float64", "float32"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_radon_fused_nodes_match_jax_inline(radon_pairs, dtype, batched):
    pairs = radon_pairs(dtype, batched)
    assert len(pairs) == (16 if batched else 20)
    before = fused_kernel.LAUNCHES
    for k, (jn, tn) in enumerate(pairs):
        _compare(jn, tn, dtype, seed=k)
    assert fused_kernel.LAUNCHES == before  # CPU tensors take the plain version


def _broadcast_graph(pt, dtype):
    """(n,919) x (n,1) x 0-d inputs, a float literal, and an output narrower
    than the iteration space."""
    x = pt.tensor("x", dtype=dtype, shape=(None, 919))
    s = pt.tensor("s", dtype=dtype, shape=(None, 1))
    c = pt.tensor("c", dtype=dtype, shape=())
    wide = pt.exp(x * s) / c + pt.log(s) * 0.1 - x ** 2
    narrow = -(s * c)
    return [x, s, c], [wide, narrow]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_broadcast_and_0d_inputs_match_jax_inline(dtype):
    ji, jo = _broadcast_graph(jpt, dtype)
    ti, to = _broadcast_graph(tpt, dtype)
    jnode = JFused(ji, jo)(*ji)[0].owner
    tnode = TFused(ti, to)(*ti)[0].owner
    _compare(jnode, tnode, dtype, seed=7)
    kern = fused_kernel.FusedElemwiseKernel(tnode.op.fgraph, "cpu")
    narrow = kern(*[torch.ones(3, 919, dtype=getattr(torch, dtype)),
                    torch.full((3, 1), 2.0, dtype=getattr(torch, dtype)),
                    torch.tensor(4.0, dtype=getattr(torch, dtype))])[1]
    assert tuple(narrow.shape) == (3, 1) and torch.all(narrow == -8.0)


def _single_fused(dtype, build):
    x = tpt.tensor("x", dtype=dtype, shape=(None,))
    return fused_kernel.FusedElemwiseKernel(TFused([x], [build(x)]).fgraph, "cpu")


def test_float64_literals_are_exact_in_the_source():
    k64 = _single_fused("float64", lambda x: x * 0.1 + 1e-300)
    assert "tl.full([BLOCK], 0.1, tl.float64)" in k64.source
    assert "tl.full([BLOCK], 1e-300, tl.float64)" in k64.source
    k32 = _single_fused("float32", lambda x: x * 0.1)
    assert f"tl.full([BLOCK], {float(np.float32(0.1))!r}, tl.float32)" in k32.source


def test_source_is_python_and_keyed_by_structure():
    a = _single_fused("float32", lambda x: tpt.exp(-x) * 2.0)
    b = _single_fused("float32", lambda x: tpt.exp(-x) * 2.0)
    c = _single_fused("float64", lambda x: tpt.exp(-x) * 2.0)
    compile(a.source, "<k1>", "exec")
    assert "@triton.jit" in a.source and "libdevice.exp" in a.source
    assert a.key == b.key and a.key != c.key


def test_fusable_admits_only_what_k1_emits():
    x = tpt.tensor("x", dtype="float32", shape=(None,))
    n = tpt.tensor("n", dtype="int64", shape=(None,))
    assert fusable(tpt.exp(x).owner) and fusable((x * 2).owner)
    assert not fusable(tpt.second(x, 1.0).owner)           # second: excluded
    assert not fusable(tpt.cast(x, "float64").owner)       # casts: excluded
    assert not fusable((n ** 2).owner)                     # integer pow: no libdevice form
    assert fusable((n * 2).owner)                          # integer arithmetic: emitted


def test_launch_refuses_cpu_tensors():
    k = _single_fused("float32", lambda x: x * 2.0 + 1.0)
    with pytest.raises(RuntimeError, match="CUDA"):
        k.launch(torch.ones(4))

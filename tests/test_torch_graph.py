"""The torch port's graph layer against the JAX package, on the CPU.

Each ported rewrite runs alone on a small graph in both packages; the
rewritten graphs must hold the same ops and, linked (``fgraph_to_jax`` /
``fgraph_to_torch`` on the CPU), give the same values.  ``grad`` graphs
are compared by value.  Inputs are seeded numpy arrays; tolerance float64
``rtol 1e-12``, float32 ``rtol 1e-6``.  Also: the port never imports JAX,
and integer indices are checked before they reach a device.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
import pytensor_tpu.tensor.math as jtm
from pytensor_tpu.graph.fg import FunctionGraph as JFunctionGraph
from pytensor_tpu.graph.rewriting.basic import WalkingGraphRewriter as JWalking
from pytensor_tpu.link.xla.linker import fgraph_to_jax

import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt
import pytensor_tpu_torch.tensor.math as ttm
from pytensor_tpu_torch.graph.fg import FunctionGraph as TFunctionGraph
from pytensor_tpu_torch.graph.rewriting.basic import WalkingGraphRewriter as TWalking
from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch

REPO = Path(__file__).resolve().parents[1]
JAX = dict(pkg=jptt, pt=jpt, tm=jtm, fg=JFunctionGraph, walk=JWalking,
           rw="pytensor_tpu.tensor.rewriting")
TORCH = dict(pkg=tptt, pt=tpt, tm=ttm, fg=TFunctionGraph, walk=TWalking,
             rw="pytensor_tpu_torch.tensor.rewriting")


def _values(types, seed):
    rng = np.random.default_rng(seed)
    return [(rng.uniform(0.5, 1.5, size=t.shape) if t.dtype.startswith("float")
             else rng.integers(0, 3, size=t.shape)).astype(t.dtype) for t in types]


def _run(side, fg, vals):
    if side is JAX:
        return [np.asarray(v) for v in fgraph_to_jax(fg)(*vals)]
    return [v.numpy() for v in fgraph_to_torch(fg, "cpu")(*vals)]


def _ops(fg):
    return [str(n.op) for n in fg.toposort()]


# rewrite name -> (module, builder(pt, tm) -> (inputs, outputs))
def _vec(pt, name="x", dtype="float64", n=5):
    return pt.tensor(name, dtype=dtype, shape=(n,))


def _mat(pt, name="x", shape=(3, 4)):
    return pt.tensor(name, dtype="float64", shape=shape)


REWRITES = {
    "constant_folding": ("basic", lambda pt, tm: (
        lambda x: ([x], [x + tm.mul(pt.constant(np.float64(2.0)), pt.constant(np.float64(3.0)))])
    )(_vec(pt))),
    "local_dimshuffle_lift": ("basic", lambda pt, tm: (
        lambda x: ([x], [x.dimshuffle(1, 0).dimshuffle("x", 1, 0)]))(_mat(pt))),
    "local_fill_thin_carrier": ("basic", lambda pt, tm: (
        lambda x: ([x], [tm.second(pt.exp(x), 1.5)]))(_vec(pt))),
    "local_useless_fill": ("basic", lambda pt, tm: (
        lambda x, y: ([x, y], [tm.second(x, y)]))(_vec(pt), _vec(pt, "y"))),
    "local_dimshuffle_of_elemwise": ("basic", lambda pt, tm: (
        lambda x, y: ([x, y], [(x * y).dimshuffle(1, 0)]))(_mat(pt), _mat(pt, "y"))),
    "local_mul_neutral": ("math", lambda pt, tm: (
        lambda x: ([x], [x * 1.0 * pt.exp(x)]))(_vec(pt))),
    "local_flatten_assoc": ("math", lambda pt, tm: (
        lambda x, y, z: ([x, y, z], [(x + y) + z]))(_vec(pt), _vec(pt, "y"), _vec(pt, "z"))),
    "local_log_exp": ("math", lambda pt, tm: (
        lambda x: ([x], [pt.log(pt.exp(x))]))(_vec(pt))),
    "local_pow_specialize": ("math", lambda pt, tm: (
        lambda x: ([x], [x ** 2]))(_vec(pt))),
    "local_sum_of_neg": ("math", lambda pt, tm: (
        lambda x: ([x], [pt.sum(-x)]))(_vec(pt))),
    "local_mul_div_canonizer": ("math", lambda pt, tm: (
        lambda x, y: ([x, y], [(2.0 * x) / (4.0 * y)]))(_vec(pt), _vec(pt, "y"))),
    "local_add_sub_canonizer": ("math", lambda pt, tm: (
        lambda x, y: ([x, y], [(x + 2.0) - (y + 1.0)]))(_vec(pt), _vec(pt, "y"))),
    "local_mul_to_sqr": ("math", lambda pt, tm: (
        lambda x: ([x], [x * x]))(_vec(pt))),
    "local_sqrt_sqr": ("math", lambda pt, tm: (
        lambda x: ([x], [pt.sqrt(pt.sqr(x)) * 2.0]))(_vec(pt))),
    "local_abs_simplify": ("math", lambda pt, tm: (
        lambda x: ([x], [pt.abs(-x) + pt.abs(pt.exp(x))]))(_vec(pt))),
    "local_div_abs_to_sign": ("math", lambda pt, tm: (
        lambda x: ([x], [(3.0 * x) / (2.0 * pt.abs(x))]))(_vec(pt))),
    "local_sum_div_by_scalar": ("math", lambda pt, tm: (
        lambda x, s: ([x, s], [pt.sum(x / s)]))(_vec(pt), pt.tensor("s", dtype="float64", shape=()))),
    "local_div_exp_to_mul_exp": ("math", lambda pt, tm: (
        lambda x, y: ([x, y], [y / pt.exp(x)]))(_vec(pt), _vec(pt, "y"))),
    "local_useless_reshape": ("shape", lambda pt, tm: (
        lambda x: ([x], [x.reshape((3, 4)) * 2.0]))(_mat(pt))),
    "local_subtensor_remove_broadcastable_index": ("subtensor", lambda pt, tm: (
        lambda x: ([x], [x[0] * 2.0]))(_mat(pt, shape=(1, 5)))),
    "local_scatter_add_to_onehot_dot": ("subtensor", lambda pt, tm: (
        lambda v, y: ([v, y], [pt.inc_subtensor(pt.zeros_like(v)[np.array([0, 2, 2, 5])], y)])
    )(_vec(pt, "v", "float32", 6), _vec(pt, "y", "float32", 4))),
}


@pytest.mark.parametrize("name", sorted(REWRITES))
def test_rewrite_matches_jax(name):
    import importlib

    module, build = REWRITES[name]
    results = []
    for side in (JAX, TORCH):
        rewriter = getattr(importlib.import_module(f"{side['rw']}.{module}"), name)
        inputs, outputs = build(side["pt"], side["tm"])
        fg = side["fg"](inputs, outputs, clone=True)
        before = _ops(fg)
        side["walk"](rewriter).rewrite(fg)
        assert _ops(fg) != before, f"{name} did not fire"
        vals = _values([i.type for i in fg.inputs], seed=0)
        results.append((_ops(fg), _run(side, fg, vals)))
    (j_ops, j_vals), (t_ops, t_vals) = results
    assert t_ops == j_ops
    for t, j in zip(t_vals, j_vals):
        assert t.dtype == j.dtype and t.shape == j.shape
        np.testing.assert_allclose(t, j, rtol=1e-6 if t.dtype == np.float32 else 1e-12)


GRADS = {
    "elemwise": lambda pt, pkg, tm: (
        lambda x, y: ([x, y], pkg.grad(pt.sum(pt.exp(x) * y + x ** 2 / y - pt.log(y)), [x, y]))
    )(_vec(pt), _vec(pt, "y")),
    "gather": lambda pt, pkg, tm: (
        lambda x: ([x], [pkg.grad(pt.sum((x[np.array([0, 3, 3, 1])] * 2.0) ** 2), x)])
    )(_vec(pt)),
    "batched_gather": lambda pt, pkg, tm: (
        lambda x: ([x], [pkg.grad(pt.sum(pt.exp(x[:, np.array([0, 3, 3, 1])])), x)])
    )(_mat(pt, shape=(3, 4))),
    "subtensor_and_broadcast": lambda pt, pkg, tm: (
        lambda x: ([x], [pkg.grad(pt.sum(x[:2] * x[3] + pt.sum(x[1:], axis=0) ** 2), x)])
    )(_vec(pt)),
    "dot": lambda pt, pkg, tm: (
        lambda a, x: ([a, x], pkg.grad(pt.sum(pt.dot(a, x) ** 2), [a, x]))
    )(_mat(pt, "a"), _vec(pt, n=4)),
}


@pytest.mark.parametrize("name", sorted(GRADS))
def test_grad_matches_jax(name):
    results = []
    for side in (JAX, TORCH):
        inputs, outputs = GRADS[name](side["pt"], side["pkg"], side["tm"])
        fg = side["fg"](inputs, outputs, clone=True)
        results.append(_run(side, fg, _values([i.type for i in fg.inputs], seed=1)))
    for t, j in zip(*reversed(results)):
        np.testing.assert_allclose(t, j, rtol=1e-12, atol=1e-14)


def test_port_never_imports_jax():
    code = ("import sys, pytensor_tpu_torch, pytensor_tpu_torch.entry, pytensor_tpu_torch.scan, "
            "pytensor_tpu_torch.models.radon_kernel, pytensor_tpu_torch.link.torch, "
            "pytensor_tpu_torch.link.cuda.scan_kernel, pytensor_tpu_torch.sparse, "
            "pytensor_tpu_torch.compile.train, pytensor_tpu_torch.link.cuda.spmv_kernel; "
            "from pytensor_tpu_torch.models.radon import make_leapfrog_chain; "
            "import torch; "
            "f = make_leapfrog_chain('float32', None, 2, 10, 3, device='cpu'); "
            "f(torch.zeros(7), torch.ones(7)); "
            "import numpy as np, scipy.sparse as sp; "
            "A = sp.random(40, 40, density=0.1, format='csr', random_state=0, dtype='float32'); "
            "xs = pytensor_tpu_torch.shared(np.ones(40, 'float32'), device='cpu'); "
            "S = pytensor_tpu_torch.sparse; "
            "y = S.structured_dot(S.as_sparse_variable(A), xs); "
            "pytensor_tpu_torch.train_loop([], y.sum(), {xs: y}, n_steps=2, device='cpu')(); "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'pytensor_tpu')]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    pattern = re.compile(r"^\s*(import|from)\s+(jax|jaxlib|pytensor_tpu)\b", re.M)
    for path in (REPO / "pytensor_tpu_torch").rglob("*.py"):
        assert not pattern.search(path.read_text()), path


def _indexed(build):
    x = tpt.tensor("x", dtype="float64", shape=(None,))
    i = tpt.tensor("i", dtype="int64", shape=(None,))
    inputs, out = build(x, i)
    return fgraph_to_torch(TFunctionGraph(inputs, [out], clone=True), "cpu")


def test_constant_index_out_of_range_raises():
    x5 = tpt.tensor("x", dtype="float64", shape=(5,))
    with pytest.raises(IndexError):
        x5[np.array([0, 7])]   # a static axis: refused when the graph is built
    fn = _indexed(lambda x, i: ([x], x[np.array([0, 7])]))
    with pytest.raises(IndexError, match="out of bounds"):
        fn(np.arange(5.0))
    np.testing.assert_array_equal(fn(np.arange(8.0))[0].numpy(), [0.0, 7.0])


def test_dynamic_index_is_checked_and_normalised():
    fn = _indexed(lambda x, i: ([x, i], x[i]))
    np.testing.assert_array_equal(fn(np.arange(5.0), np.array([-1, 0, 4]))[0].numpy(),
                                  [4.0, 0.0, 4.0])
    with pytest.raises(IndexError, match="out of bounds"):
        fn(np.arange(5.0), np.array([0, 5]))
    with pytest.raises(IndexError, match="out of bounds"):
        fn(np.arange(5.0), np.array([-6]))


@pytest.mark.parametrize("dtype", ["int64", "int32", "int8", "float64", "float32", "bool"])
def test_as_torch_keeps_dtype_and_shape(dtype):
    import jax.numpy as jnp

    from pytensor_tpu_torch.link.torch.convert import as_torch, torch_dtype

    value = np.arange(6).reshape(2, 3).astype(dtype)
    for v in (value, jnp.asarray(value), value[:, ::-1]):
        t = as_torch(np.asarray(v), "cpu")
        assert t.dtype == torch_dtype(dtype) and tuple(t.shape) == (2, 3)
        np.testing.assert_array_equal(t.numpy(), np.asarray(v))


def test_linked_function_checks_its_inputs():
    x = tpt.tensor("x", dtype="float32", shape=(3,))
    fn = fgraph_to_torch(TFunctionGraph([x], [tpt.exp(x)], clone=True), "cpu")
    with pytest.raises(TypeError):
        fn(torch.zeros(3, dtype=torch.float64))
    with pytest.raises(TypeError):
        fn(np.zeros(4, dtype="float32"))
    with pytest.raises(TypeError):
        fn(torch.zeros(4, dtype=torch.float32))
    (out,) = fn(np.zeros(3, dtype="float32"))
    assert out.dtype == torch.float32 and torch.all(out == 1.0)

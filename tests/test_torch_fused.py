"""K1, the fused elementwise kernel: its plain version against the JAX
package's FusedElemwise, and the CUDA source it emits, run on the CPU.

The JAX side runs the FusedElemwise inline path (``pytensor_tpu/tensor/
fused.py:111-116``, the path taken with ``pallas__fusion`` off; no JAX test
runs the Pallas body on the CPU).  The port side runs
``FusedElemwiseKernel`` on CPU tensors, which is its plain version.  Both
get the same seeded numpy inputs.  Tolerance: float64 ``rtol 1e-12``,
float32 ``rtol 1e-5`` with ``atol 1e-6 * max|out|`` (torch and XLA may
order an n-ary add differently).

There is no nvcc here, but K1's generated source is C++ apart from a few
CUDA features: with ``tests/k1_host.h`` in place of ``<cuda_runtime.h>``
(a grid of blocks run in turn, the threads as a loop, ``float4`` and
``double2``), g++ compiles it into the gitignored ``build/k1_host/`` and
it runs on CPU tensors, through the layout integers and the C entry the
wrapper uses, against the plain version at ``chip_smoke.py``'s
``K1_RTOL`` (``1e-5`` for float32, ``1e-12`` for float64, over
``max(1, max|plain|)``; the host's libm and torch's may differ by an ulp).
What this cannot show is that nvcc accepts the source, or the card's
rounding: ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` show those.
"""

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
from pathlib import Path

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
K1_RTOL = {"float32": 1e-5, "float64": 1e-12}
BUILD = Path(__file__).resolve().parents[1] / "build" / "k1_host"
HEADER = Path(__file__).resolve().parent / "k1_host.h"


def _fused_nodes(pkg_radon, fgraph_cls, fast_run, fused_cls, dtype, batched, *sizes):
    if batched:
        theta, logp, dlogp, _ = pkg_radon.make_radon_logp_batched(*sizes, dtype=dtype)
        inputs, outputs = [theta], [logp, dlogp]
    else:
        inputs, outputs, _ = pkg_radon.make_radon_graphs(*sizes, dtype=dtype)
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
    assert "0x1.999999999999ap-4" in k64.source          # float64's 0.1, exactly
    assert float.hex(1e-300) in k64.source
    k32 = _single_fused("float32", lambda x: x * 0.1)
    assert float.hex(float(np.float32(0.1))) + "f" in k32.source  # 0x1.99999ap-4f
    assert "0x1.999999999999ap-4" not in k32.source


def test_source_is_cuda_and_keyed_by_structure():
    a = _single_fused("float32", lambda x: tpt.exp(-x) * 2.0)
    b = _single_fused("float32", lambda x: tpt.exp(-x) * 2.0)
    c = _single_fused("float64", lambda x: tpt.exp(-x) * 2.0)
    assert "__global__" in a.source and "expf(" in a.source and "exp(" in c.source
    assert f'extern "C" int k1_{a.key}(' in a.source and a.source.endswith(a.unit)
    assert a.key == b.key and a.unit == b.unit and a.key != c.key


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


# --- the generated CUDA source, compiled for the host -----------------------------

@pytest.fixture(scope="module")
def k1_host():
    """A function that compiles K1's library source for some kernels with
    g++ against ``tests/k1_host.h`` (once per source) and loads it."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to compile K1's source for the host")

    def lib_for(kernels):
        units = {k.key: k.unit for k in kernels}
        src = (fused_kernel.PRELUDE.replace("#include <cuda_runtime.h>", f'#include "{HEADER}"')
               + "".join(units[k] for k in sorted(units)))
        key = hashlib.sha256(src.encode() + HEADER.read_bytes()).hexdigest()[:16]
        lib = BUILD / f"libk1_host_{key}.so"
        if not lib.exists():
            BUILD.mkdir(parents=True, exist_ok=True)
            cpp = BUILD / f"k1_host_{key}.{os.getpid()}.cpp"
            cpp.write_text(src)
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([gxx, "-std=c++17", "-O1", "-w", "-fno-strict-aliasing",
                                   "-shared", "-fPIC", "-o", str(tmp), str(cpp)],
                                  capture_output=True, text=True)
            assert proc.returncode == 0, proc.stderr[:4000]
            os.replace(tmp, lib)
        handle = ctypes.CDLL(str(lib))
        for k in units:
            fn = getattr(handle, f"k1_{k}")
            fn.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), ctypes.POINTER(ctypes.c_longlong),
                           ctypes.c_void_p]
            fn.restype = ctypes.c_int
        return handle

    return lib_for


def _host_launch(lib, kern, inputs):
    """What ``FusedElemwiseKernel.launch`` does on the card, on CPU tensors
    through the host build: the layout of these inputs, outputs from
    ``torch.empty`` and one call of the C entry with the pointers."""
    lay = kern._layout(kern._args(inputs))
    outs = [torch.empty(s, dtype=dt) for s, dt in lay.outs]
    if lay.n:
        ptrs = kern._ptrs_t(*[a.data_ptr() for a in inputs], *kern._const_ptrs,
                            *[o.data_ptr() for o in outs])
        assert getattr(lib, f"k1_{kern.key}")(ptrs, lay.ints, None) == 0
        # a thread a vector or an element of the tail, else a thread an
        # element; vectors only where the pointers read or written as
        # vectors are 16-byte aligned
        contig = [p for p, c in zip(ptrs, lay.classes[0]) if c == fused_kernel.CONTIG]
        vec = (kern.vector and lay.ints[len(lay.ints) - 3]
               and all(p % 16 == 0 for p in contig + [o.data_ptr() for o in outs]))
        units = lay.n - (lay.n // kern.vector if vec else 0) * (kern.vector - 1)
        assert lib.k1_host_blocks() == min(math.ceil(units / fused_kernel.THREADS),
                                           fused_kernel.MAX_BLOCKS)
    return outs, lay


def _held(got, want, dtype):
    """got within K1_RTOL of want over max(1, max|want|), with NaN where
    want has NaN and the sign of every zero kept."""
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g.isnan(), w.isnan())
        g, w = g[~w.isnan()], w[~w.isnan()]
        if w.numel():
            err = float((g.double() - w.double()).abs().max())
            assert err / max(1.0, float(w.abs().max())) <= K1_RTOL[dtype]
            assert torch.equal(torch.signbit(g[w == 0]), torch.signbit(w[w == 0]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("batched", [False, True], ids=["single", "batched"])
def test_k1_source_matches_plain_on_radon_nodes(k1_host, dtype, batched):
    """Every fused node of the radon graphs at 40/5, the kernels of one
    graph built as the linker builds them, in one library."""
    nodes = _fused_nodes(tradon, TFunctionGraph, T_FAST_RUN, TFused, dtype, batched, 40, 5)
    kerns = [fused_kernel.FusedElemwiseKernel(nd.op.fgraph, "cpu") for nd in nodes]
    lib = k1_host(kerns)
    classes = set()
    for k, (nd, kern) in enumerate(zip(nodes, kerns)):
        args = [torch.from_numpy(a) for a in _inputs([i.type for i in nd.inputs], seed=k)]
        got, lay = _host_launch(lib, kern, args)
        _held(got, kern.plain(*args), dtype)
        classes.update(lay.classes[0])
    # the single-chain graph's inputs are contiguous or 0-d; the batched
    # graph broadcasts (chains, 1) and (n_obs,) inputs over (chains, n_obs)
    # by strides
    assert classes == ({fused_kernel.CONTIG, fused_kernel.STRIDED}
                       if batched else {fused_kernel.CONTIG, fused_kernel.SCALAR})


def _layout_case(case, dtype):
    """The inputs x, y of one layout case; x holds a NaN and a -0.0."""
    rng = np.random.default_rng(11)

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(dtype))

    x = t(*{"tail": (1001,), "misaligned": (1001,), "empty": (0, 7)}.get(case, (5, 7)))
    if x.numel():
        x.view(-1)[:2] = torch.tensor([float("nan"), -0.0])
    if case == "transposed":
        x = x.T.contiguous().T               # the same values, column-major
    elif case == "misaligned":
        x = torch.cat([t(1), x])[1:]         # one element past a 16-byte boundary
    y = {"row": t(7), "column": t(5, 1), "0d": t(), "transposed": t(5, 7), "tail": t(1001),
         "misaligned": t(1001), "empty": t(0, 7)}[case]
    return x, y


_C, _S, _X = fused_kernel.CONTIG, fused_kernel.SCALAR, fused_kernel.STRIDED
# the classes of (x, y) and of the four outputs, and the vector flag
_LAYOUTS = {"row": ([_C, _X], [_C, _C, _C, _X], 0), "column": ([_C, _X], [_C, _C, _C, _X], 0),
            "0d": ([_C, _S], [_C, _C, _C, _S], 0), "transposed": ([_X, _C], [_C] * 4, 0),
            "tail": ([_C, _C], [_C] * 4, 1), "misaligned": ([_C, _C], [_C] * 4, 1)}


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", ["row", "column", "0d", "transposed", "tail", "misaligned",
                                  "empty"])
def test_k1_source_layout_classes_match_plain(k1_host, case, dtype):
    """x * y - exp(-y) + 0.1, maximum(x, y), abs(x) and y * 2 (an output
    narrower than the iteration space where y broadcasts) for each layout
    class: a row and a column broadcast and a 0-d y (strided, strided,
    one load a thread), a column-major x, 1,001 contiguous elements (16-byte
    vectors and a tail), the same one element off a 16-byte boundary (the C
    entry refuses the vectors), and no elements at all (no launch).
    maximum keeps x's NaN, abs(-0.0) is +0.0."""
    x, y = _layout_case(case, dtype)
    tx = tpt.tensor("x", dtype=dtype, shape=(None,) * x.ndim)
    ty = tpt.tensor("y", dtype=dtype, shape=(None,) * y.ndim)
    outs = [tx * ty - tpt.exp(-ty) + 0.1, tpt.maximum(tx, ty), tpt.abs(tx), ty * 2.0]
    kern = fused_kernel.FusedElemwiseKernel(TFused([tx, ty], outs).fgraph, "cpu")
    got, lay = _host_launch(k1_host([kern]), kern, [x, y])
    _held(got, kern.plain(x, y), dtype)
    if case == "empty":
        assert lay.n == 0 and all(g.numel() == 0 for g in got)
        # y * 2 of a (7,) y would not be empty, but nothing is computed
        # over an empty iteration space: the layout refuses it
        with pytest.raises(ValueError, match="empty"):
            kern._layout([x, torch.ones(7, dtype=y.dtype)])
    else:
        xc, yc, vec = _LAYOUTS[case]
        assert list(lay.classes[0]) == xc and list(lay.classes[1]) == yc
        assert lay.ints[len(lay.ints) - 3] == vec
        assert bool(torch.isnan(got[1]).any()) and not torch.signbit(got[2]).any()


def test_k1_source_bool_results_match_plain(k1_host):
    """A fused node with bool results: ``sqr`` and ``abs`` of a bool are
    the bool itself in the source (in C a bool times a bool is an int),
    ``mul`` and ``add`` of bools are and / or."""
    b = tpt.tensor("b", dtype="bool", shape=(None,))
    c = tpt.tensor("c", dtype="bool", shape=(None,))
    outs = [tpt.sqr(b) * c, tpt.abs(b) + tpt.sqr(c)]
    assert all(fusable(o.owner) for o in outs) and fusable(tpt.sqr(b).owner)
    kern = fused_kernel.FusedElemwiseKernel(TFused([b, c], outs).fgraph, "cpu")
    assert kern.vector == 0 and "* a0" not in kern.source and "a0 < 0" not in kern.source
    rng = np.random.default_rng(12)
    bv, cv = (torch.from_numpy(rng.integers(0, 2, size=1001).astype(bool)) for _ in range(2))
    got, _ = _host_launch(k1_host([kern]), kern, [bv, cv])
    want = kern.plain(bv, cv)
    b_np, c_np = bv.numpy(), cv.numpy()
    for g, w, ref in zip(got, want, (b_np & c_np, b_np | c_np)):
        assert g.dtype == w.dtype == torch.bool and torch.equal(g, w)
        np.testing.assert_array_equal(g.numpy(), ref)


# --- the scalar ops of the expression table, in every dtype ---------------------------

# ops whose value is exact in every dtype: the host build gives the plain
# version's bits; the others are held at K1_RTOL over max(1, |plain|)
_EXACT = {"gt", "le", "eq", "neq", "lt", "ge", "isnan", "isinf", "minimum", "and_", "or_",
          "xor", "invert", "left_shift", "right_shift", "int_div", "mod", "switch", "clip",
          "identity", "floor", "ceil", "trunc", "round_half_to_even",
          "round_half_away_from_zero", "deg2rad", "rad2deg", "maximum", "abs", "neg", "sign"}


def _edge_values(dtype, n, seed):
    """n values of dtype with the edges in front: NaN, +-inf, +-0.0,
    halves and near-halves for the floats; negative values, 0, the
    extremes for the integers."""
    rng = np.random.default_rng(seed)
    if dtype == "bool":
        return rng.integers(0, 2, size=n).astype(bool)
    if dtype.startswith("float"):
        edge = [np.nan, np.inf, -np.inf, 0.0, -0.0, 0.5, -0.5, 1.5, -2.5, 2.5, 0.49999997,
                -0.49999997, 1.0, -1.0, 7.0, -7.0]
        vals = np.concatenate([edge, rng.standard_normal(n - len(edge)) * 4])
        return vals.astype(dtype)
    info = np.iinfo(dtype)
    edge = [0, 1, -1, 7, -7, 3, -3, info.min, info.max, info.min + 1]
    vals = np.concatenate([edge, rng.integers(-50, 50, size=n - len(edge))])
    return vals.astype(dtype)


def _shift_counts(dtype, n, seed):
    """Counts at, below and past the width, and negative ones."""
    w = np.iinfo(dtype).bits
    rng = np.random.default_rng(seed)
    edge = [0, 1, w - 1, w, w + 1, -1, -w, 2 * w]
    return np.concatenate([edge, rng.integers(0, w, size=n - len(edge))]).astype(dtype)


def _identity(x):
    from pytensor_tpu_torch.scalar import basic as ps
    from pytensor_tpu_torch.tensor.elemwise import Elemwise

    return Elemwise(ps.identity)(x)


def _scalar_op_group(dtype):
    """One fused node per dtype computing every op of the table that
    takes that dtype, as outputs of its inputs."""
    if dtype == "bool":
        p, q, c = (tpt.tensor(k, dtype="bool", shape=(None,)) for k in "pqc")
        ins = [p, q, c]
        outs = [tpt.and_(p, q), tpt.or_(p, q), tpt.xor(p, q), tpt.invert(p),
                tpt.minimum(p, q), tpt.gt(p, q), tpt.le(p, q), tpt.eq(p, q), tpt.neq(p, q),
                _identity(p), tpt.switch(c, p, q)]
        names = ["and_", "or_", "xor", "invert", "minimum", "gt", "le", "eq", "neq",
                 "identity", "switch"]
    elif dtype.startswith("float"):
        x, y, z = (tpt.tensor(k, dtype=dtype, shape=(None,)) for k in "xyz")
        c = tpt.tensor("c", dtype="bool", shape=(None,))
        ins = [x, y, z, c]
        unary = ["exp2", "expm1", "log1p", "log2", "log10", "deg2rad", "rad2deg", "tan",
                 "cosh", "sinh", "arcsin", "arccos", "arctan", "arcsinh", "arccosh", "arctanh",
                 "floor", "ceil", "trunc", "round_half_to_even", "round_half_away_from_zero",
                 "isnan", "isinf", "identity"]
        outs = [getattr(tpt, k)(x) for k in unary[:-1]] + [_identity(x)]
        names = list(unary)
        for k in ("arctan2", "int_div", "mod", "minimum", "gt", "le", "eq", "neq"):
            outs.append(getattr(tpt, k)(x, y))
            names.append(k)
        outs += [tpt.clip(x, y, z), tpt.switch(c, x, y)]
        names += ["clip", "switch"]
    else:
        a, b, s = (tpt.tensor(k, dtype=dtype, shape=(None,)) for k in "abs")
        c = tpt.tensor("c", dtype="int32", shape=(None,))
        ins = [a, b, s, c]
        names = ["int_div", "mod", "and_", "or_", "xor", "minimum", "gt", "le", "eq", "neq"]
        outs = [getattr(tpt, k)(a, b) for k in names]
        outs += [tpt.left_shift(a, s), tpt.right_shift(a, s), tpt.invert(a),
                 tpt.clip(a, b, s), tpt.switch(c, a, b), tpt.round_half_to_even(a),
                 tpt.round_half_away_from_zero(a), tpt.isnan(a), tpt.isinf(a), tpt.floor(a),
                 _identity(a)]
        names += ["left_shift", "right_shift", "invert", "clip", "switch", "round_half_to_even",
                  "round_half_away_from_zero", "isnan", "isinf", "floor", "identity"]
    assert all(fusable(o.owner) for o in outs), [str(o.owner) for o in outs if not fusable(o.owner)]
    return ins, outs, names


_GROUP_DTYPES = ["float32", "float64", "bool", "int8", "int16", "int32", "int64"]


def test_k1_source_matches_plain_on_every_scalar_op(k1_host):
    """Every op of the expression table in every dtype K1 takes, as one
    fused node a dtype, the seven built into one library: the exact ops
    bit for bit (NaN where the plain version has NaN, the sign of every
    zero), the others within K1_RTOL; numpy's edges included (int_div and
    mod of negatives and by 0, shifts at and past the width, halves for the
    rounding ops, NaN, inf and -0.0)."""
    groups = {dt: _scalar_op_group(dt) for dt in _GROUP_DTYPES}
    kerns = {dt: fused_kernel.FusedElemwiseKernel(TFused(ins, outs).fgraph, "cpu")
             for dt, (ins, outs, _) in groups.items()}
    lib = k1_host(list(kerns.values()))
    n = 64
    for k, (dt, (ins, outs, names)) in enumerate(groups.items()):
        args = []
        for j, v in enumerate(ins):
            vals = (_shift_counts(dt, n, k + j) if v.name == "s" and dt.startswith("int")
                    else _edge_values(v.type.dtype, n, 100 * k + j))
            if j % 2:  # each edge of one operand meets the other's in turn
                vals = np.roll(vals, j)
            args.append(torch.from_numpy(vals))
        got, _ = _host_launch(lib, kerns[dt], args)
        want = kerns[dt].plain(*args)
        for name, g, w in zip(names, got, want):
            assert g.dtype == w.dtype and g.shape == w.shape, (dt, name)
            if not g.dtype.is_floating_point:
                assert torch.equal(g, w), (dt, name, g, w)
                continue
            assert torch.equal(g.isnan(), w.isnan()), (dt, name)
            ok = ~w.isnan()
            g, w = g[ok], w[ok]
            if name in _EXACT:
                assert torch.equal(g, w) and torch.equal(torch.signbit(g), torch.signbit(w)), \
                    (dt, name, g, w)
            else:
                assert torch.equal(g.isinf(), w.isinf()) and torch.equal(g[w.isinf()], w[w.isinf()])
                fin = ~w.isinf()
                err = (g[fin].double() - w[fin].double()).abs()
                lim = K1_RTOL[dt] * torch.clamp(w[fin].double().abs(), min=1.0)
                assert bool((err <= lim).all()), (dt, name, float(err.max()))


@pytest.mark.parametrize("n", [333, 0], ids=["vector", "0d"])
def test_k1_source_takes_a_host_scalar_in_its_pointer(k1_host, n):
    """A one-element value computed on the host (the length of a batch,
    cast) is passed in its pointer's place: its bytes in the pointer array,
    its host flag in the layout, its class 0-d even where the iteration
    space is 0-d (where every other input is contiguous), one load a
    thread of neither memory.  The layout is the card's: the kernel is
    made for the ``meta`` device, so that the CPU value counts as the
    host's."""
    for dt in ("float32", "float64"):
        shape = (None,) if n else ()
        x = tpt.tensor("x", dtype=dt, shape=shape)
        nrm = tpt.tensor("n", dtype=dt, shape=())
        kern = fused_kernel.FusedElemwiseKernel(TFused([x, nrm], [-x / nrm]).fgraph, "cpu")
        xv = torch.from_numpy(_edge_values(dt, max(n, 16), 3)[:n] if n
                              else np.asarray(-3.5, dtype=dt))
        nv = torch.tensor(8192.0, dtype=getattr(torch, dt))
        kern.device = torch.device("meta")
        lay = kern._layout([xv.to("meta"), nv])
        kern.device = torch.device("cpu")
        assert lay.classes[0] == [fused_kernel.CONTIG, fused_kernel.SCALAR]
        out = torch.empty(xv.shape, dtype=xv.dtype)
        ptrs = kern._ptrs_t(xv.data_ptr(), fused_kernel._host_bits(nv), out.data_ptr())
        lib = k1_host([kern])
        assert getattr(lib, f"k1_{kern.key}")(ptrs, lay.ints, None) == 0
        want = kern.plain(xv, nv)[0]
        assert torch.equal(out.isnan(), want.isnan())
        assert torch.equal(out[~want.isnan()], want[~want.isnan()])

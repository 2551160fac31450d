"""K1's device functions for the special functions, compiled for the host.

Every op of ``scalar/math.py`` that K1 emits (``link/cuda/special.py``),
as a one-node K1 kernel (what ``link/torch/dispatch.py`` launches on a
card where the fusion pass left the node alone: a constant operand is a
literal) in float32 and float64, its generated CUDA source compiled by
g++ against ``tests/k1_host.h`` and run through the layout integers and
the C entry the wrapper uses (``tests/test_torch_fused.py``'s harness),
against the plain version on the op's grid and numpy's edges.

CUDA's math library has functions glibc lacks: ``tests/k1_host.h``
defines ``erfinv``, ``erfcinv``, ``erfcx``, ``cyl_bessel_i0``,
``cyl_bessel_i1``, ``normcdf`` and ``normcdfinv`` (and their float
forms) for the host, to double precision; so the host build checks the
source and the hand-written functions (digamma, trigamma, polygamma, the
incomplete gamma and beta, the Bessel cores), and the card's tests
(``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 14) check CUDA's
own.  Tolerance, over ``max(1, |plain|)``: float64 ``5e-9``, float32
``2e-5`` (the tolerances the ops are held to against scipy); NaN where
the plain version gives NaN, and the same infinities.
"""

import numpy as np
import pytest
import torch

import pytensor_tpu_torch.tensor as tpt
from pytensor_tpu_torch.link.cuda import cases
from pytensor_tpu_torch.link.cuda.special import CEXPR as SPECIAL
from pytensor_tpu_torch.link.torch.dispatch import _one_node_k1
from pytensor_tpu_torch.tensor import fused_kernel

from test_torch_fused import HEADER, _host_launch, k1_host  # noqa: F401 (the fixture)

# the CUDA math-library functions that tests/k1_host.h defines for the host
HOST_DEFINED = ("erfinv", "erfcinv", "erfcx", "cyl_bessel_i0", "cyl_bessel_i1", "normcdf",
                "normcdfinv")
TOL = {"float64": 5e-9, "float32": 2e-5}


def test_every_device_function_has_a_grid():
    assert set(cases.SPECIAL_GRIDS) == set(SPECIAL)


def _node(name, dtype):
    """The op's node (a constant operand where the grid gives a float) and
    its inputs on the grid and numpy's edges (``link/cuda/cases.py``)."""
    node = cases.special_node(name, dtype)
    return node, [torch.from_numpy(v) for v in cases.special_inputs(name, dtype, 61, 7)]


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_k1_special_functions_match_the_plain_version(k1_host, dtype):  # noqa: F811
    names = sorted(cases.SPECIAL_GRIDS)
    kerns, runs = [], []
    for name in names:
        node, args = _node(name, dtype)
        fn = _one_node_k1(node.op, node, "cpu")
        kerns.append(fn.k1)
        runs.append((name, fn.k1, args))
    lib = k1_host(kerns)
    for name, kern, args in runs:
        (got,), _ = _host_launch(lib, kern, args)
        want = kern.plain(*args)[0]
        assert got.dtype == want.dtype == getattr(torch, dtype)
        g, w = got.double().numpy(), want.double().numpy()
        assert np.array_equal(np.isnan(g), np.isnan(w)), (name, g[np.isnan(g) != np.isnan(w)])
        inf = np.isinf(w)
        assert np.array_equal(g[inf], w[inf]), name
        fin = np.isfinite(w)
        err = np.abs(g[fin] - w[fin]) / np.maximum(1.0, np.abs(w[fin]))
        assert err.max(initial=0) <= TOL[dtype], (name, err.max())


def test_a_source_defines_only_the_helpers_it_calls():
    """K1's library source carries the special helpers its units call, and
    those they call in turn, and no other."""
    node, _ = _node("kve", "float32")
    src = _one_node_k1(node.op, node, "cpu").k1.source
    assert "ks_ik_core" in src and "ks_jy_core" not in src and "ks_betacf" not in src
    node, _ = _node("jv", "float64")
    src = _one_node_k1(node.op, node, "cpu").k1.source
    assert "ks_jy_core" in src and "ks_ik_core" in src  # J's reflection calls sinpi of K's base
    node, _ = _node("erf", "float32")
    src = _one_node_k1(node.op, node, "cpu").k1.source
    assert "erff(" in src and "ks_" not in src
    assert "k2_mod" not in fused_kernel.PRELUDE


def test_the_host_header_says_which_functions_it_defines():
    header = HEADER.read_text()
    for fn in HOST_DEFINED:
        assert f"inline double {fn}(" in header
        assert f"inline float {fn}f(" in header


def test_constant_operands_are_literals():
    """kve(1.0, v): the order is a literal of the source, and the kernel
    takes v alone."""
    v = tpt.tensor("v", dtype="float32", shape=(None,))
    node = tpt.kve(1.0, v).owner
    fn = _one_node_k1(node.op, node, "cpu")
    assert len(fn.k1.inputs) == 1 and "ks_kve(0x1.0000000000000p+0f, a0)" in fn.k1.source
    x = torch.linspace(1.5, 2.5, 9)
    torch.testing.assert_close(fn(torch.tensor(1.0), x), fn.k1.plain(x)[0], rtol=0, atol=0)

"""The parity harness of the tests of the tensor library's tail
(``tests/test_torch_extra_ops.py``, ``test_torch_einsum.py``,
``test_torch_fft_signal.py``): the same graph built in both packages,
``build(ptt, pt)`` giving its inputs and outputs, each compiled by
``function()`` (the JAX package with its defaults, the XLA path; the port
on the CPU) and run on the same numpy inputs.

Tolerances: integer, bool and index results exactly; float64 results of
elementwise compositions at ``rtol 1e-12``; float64 results of products,
running sums and products, FFTs and convolutions within ``1e-10`` of
``max|ref|``; float32 results within ``1e-5`` of ``max|ref|``.  NaN must
sit at the same places.
"""

import warnings

import numpy as np
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt

PKGS = {"jax": (jptt, jpt), "torch": (tptt, tpt)}
SCALED = {"float32": 1e-5, "float64": 1e-10}


def as_np(v):
    return v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def compile_both(build, oracle=False):
    """``{"jax": f, "torch": f}`` (and ``"oracle"``, the JAX package's numpy
    oracle, with ``oracle``) of the graph ``build(ptt, pt)`` gives."""
    fns = {}
    for name, (ptt, pt) in PKGS.items():
        inputs, outputs = build(ptt, pt)
        kw = {"device": "cpu"} if name == "torch" else {}
        fns[name] = ptt.function(inputs, outputs, **kw)
        if oracle and name == "jax":
            fns["oracle"] = ptt.function(inputs, outputs, mode="FAST_COMPILE")
    return fns


def run(fn, values):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out = fn(*values)
    return [as_np(o) for o in (out if isinstance(out, (list, tuple)) else [out])]


def held(got, want, kind="elem", what=""):
    """``got`` (the port's) against ``want`` at the tolerance of ``kind``:
    ``"elem"`` (an elementwise composition) or ``"prod"`` (products, running
    sums, FFTs, convolutions); integer and bool results exactly."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert str(got.dtype) == str(want.dtype), (what, got.dtype, want.dtype)
    if got.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want), err_msg=what + ": NaN")
    ok = ~np.isnan(want)
    g, w = got[ok].astype("float64"), want[ok].astype("float64")
    if str(want.dtype) == "float64" and kind == "elem":
        np.testing.assert_allclose(g, w, rtol=1e-12, atol=0, err_msg=what)
        return
    fin = np.isfinite(w)
    np.testing.assert_array_equal(g[~fin], w[~fin], err_msg=what + ": infinities")
    scale = float(np.max(np.abs(w[fin]), initial=0.0))
    err = float(np.max(np.abs(g[fin] - w[fin]), initial=0.0))
    assert err <= SCALED[str(want.dtype)] * scale, (what, err, scale)


def check(build, values, kind="elem", kinds=None):
    """The port's outputs against the JAX package's on ``values``; ``kinds``
    gives a kind an output where they differ.  Returns the port's."""
    fns = compile_both(build)
    want, got = run(fns["jax"], values), run(fns["torch"], values)
    assert len(got) == len(want)
    for k, (g, w) in enumerate(zip(got, want)):
        held(g, w, kinds[k] if kinds else kind, f"output {k}")
    return got

"""The harness of the control and debug tests (``test_torch_ifelse.py``,
``test_torch_raise_op.py``, ``test_torch_debug_modes.py``,
``test_torch_typed_list.py``, ``test_torch_breakpoint_d3viz.py``): each
package's namespaces by the names the cases use, and the tolerances.

A case is built in both packages from the same seeded numpy inputs; the
port runs on the CPU.  Outputs are held for shape, dtype and value:
float64 at ``rtol 1e-12`` (gradients ``1e-10``), float32 within ``2e-6``
of the largest magnitude, integers and bools equal.
"""

import importlib

import numpy as np
import torch

import pytensor_tpu as jptt
import pytensor_tpu.tensor as jpt
import pytensor_tpu_torch as tptt
import pytensor_tpu_torch.tensor as tpt


class Pkg:
    """One package's namespaces, by the names the cases use."""

    def __init__(self, name, ptt, pt, kw):
        self.name, self.ptt, self.pt, self.kw = name, ptt, pt, kw
        root = ptt.__name__
        self.ifelse_mod = importlib.import_module(root + ".ifelse")
        self.raise_op = importlib.import_module(root + ".raise_op")
        self.tl = importlib.import_module(root + ".typed_list")
        self.mode = importlib.import_module(root + ".compile.mode")
        self.debug = importlib.import_module(root + ".compile.debug")

    def function(self, inputs, outputs, **kw):
        return self.ptt.function(inputs, outputs, **self.kw, **kw)


JAX = Pkg("jax", jptt, jpt, {})
PORT = Pkg("torch", tptt, tpt, {"device": "cpu"})


def np_(v):
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if isinstance(v, (list, tuple)):
        return [np_(x) for x in v]
    return np.asarray(v)


def ops(f):
    return [type(n.op).__name__ for n in f.fgraph.toposort()]


def op_strs(f):
    return [str(n.op) for n in f.fgraph.toposort()]


def held(got, want, rtol=1e-12, what=""):
    got, want = np_(got), np_(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    assert got.dtype == want.dtype, (what, got.dtype, want.dtype)
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=what)
    elif want.dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2e-6 * max(1.0, float(np.max(np.abs(want), initial=0))),
                                   err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-300, err_msg=what)


def both(build, values, rtol=1e-12, jax_mode=None, port_mode=None):
    """``build(pkg) -> (inputs, outputs)`` in each package, compiled and
    called on ``values``; the port's outputs are held to the JAX package's
    (in ``jax_mode``, by default ``FAST_RUN``) and returned, with the two
    functions (the JAX package's first)."""
    res, fns = [], []
    for pkg, mode in ((JAX, jax_mode), (PORT, port_mode)):
        ins, outs = build(pkg)
        f = pkg.function(ins, outs, **({"mode": mode} if mode else {}))
        got = f(*values)
        res.append([np_(o) for o in (got if isinstance(got, (list, tuple)) else [got])])
        fns.append(f)
    for k, (g, w) in enumerate(zip(res[1], res[0])):
        held(g, w, rtol, what=f"output {k}")
    return res[1], fns

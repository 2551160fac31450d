"""The probe of the rewrites of ROADMAP Queue 1 item 6, both packages.

A sibling of ``tests/torch_math_probe.py`` for the graphs of
``pytensor_tpu_torch/link/cuda/rewrite_cases.py``: the ShapeFeature and
the ``local_*`` rewrites of ``tensor/rewriting/{basic,subtensor,math}.py``
that the port took in item 6.  Each graph is built in both packages from
the same graph function, on float64 inputs of unknown shape made from a seed
(``side`` 16: 256-element vectors and 16 x 16 matrices), and compiled with
the default ``FAST_RUN`` (and the case's ``exclude``), and with the
case's rewrite excluded too.  ``probe()`` gives one row a graph: how often
the rewrite fired in each package (``_fired``; the ShapeFeature's row
counts the nodes it saves instead), both packages' ops, and their values.

Run it to print the table (``python tests/torch_rewrite_probe.py``), and
the names of the JAX package's three files' ``local_*`` rewrites that the
port lacks (none).
"""

from __future__ import annotations

import os
import re

import numpy as np

SIDE = 16
FILES = ("basic", "subtensor", "math", "shape")

# the rewrites that move a product or a reduction: their values are held
# within MOVER_RTOL of the JAX package's, the structural ones bit for bit
MOVERS = ("local_subtensor_of_dot", "local_advanced_subtensor1_of_dot",
          "local_extract_diag_of_dot", "local_subtensor_of_reduce")
MOVER_RTOL = 1e-12


def local_names(root, name):
    """The ``def local_*`` names of ``<root>/tensor/rewriting/<name>.py``."""
    with open(os.path.join(root, "tensor", "rewriting", f"{name}.py")) as fh:
        return set(re.findall(r"^def (local_\w+)", fh.read(), re.M))


def missing_names():
    """{file: the JAX package's ``local_*`` names the port lacks}."""
    import pytensor_tpu
    import pytensor_tpu_torch

    jroot, troot = (os.path.dirname(m.__file__) for m in (pytensor_tpu, pytensor_tpu_torch))
    return {f: sorted(local_names(jroot, f) - local_names(troot, f)) for f in FILES}


def ops_of(f):
    """Each node's op, a FusedElemwise with its inner scalar ops."""
    out = []
    for n in f.maker.fgraph.toposort():
        name = type(n.op).__name__
        if hasattr(n.op, "scalar_op"):
            name += "{" + n.op.scalar_op.name + "}"
        elif name == "FusedElemwise":
            name += str([m.op.scalar_op.name for m in n.op.fgraph.toposort()])
        out.append(name)
    return out


def run(case, side=SIDE, dtype="float64"):
    """``{package: (fired, ops, value, ops without the rewrite)}`` of one
    case, each package with the default mode less the case's ``exclude``."""
    import pytensor_tpu as jptt
    import pytensor_tpu.tensor as jpt
    from pytensor_tpu.compile.mode import get_mode as jget_mode

    import pytensor_tpu_torch as tptt
    import pytensor_tpu_torch.tensor as tpt
    from pytensor_tpu_torch.compile.mode import get_mode as tget_mode
    from tests.torch_math_probe import _fired

    vals = case.inputs(side, dtype)
    counts, undo = _fired()
    out = {}
    try:
        for key, ptt, pt, get_mode, kw in (("jax", jptt, jpt, jget_mode, {}),
                                           ("torch", tptt, tpt, tget_mode, {"device": "cpu"})):
            mode = get_mode(None).excluding(*case.exclude) if case.exclude else get_mode(None)

            def link(m):
                ins = [pt.tensor(f"x{k}", dtype=np.asarray(v).dtype, shape=(None,) * np.ndim(v))
                       for k, v in enumerate(vals)]
                return ptt.function(ins, case.build(pt, side, *ins), mode=m, **kw)

            counts[key].clear()
            f = link(mode)
            fired = counts[key][case.rewrite]
            bare = link(mode.excluding(*case.without))
            if case.rewrite == "shape_feature":
                fired = len(bare.maker.fgraph.apply_nodes) - len(f.maker.fgraph.apply_nodes)
            out[key] = (fired, ops_of(f), np.asarray(f(*vals)), ops_of(bare))
    finally:
        undo()
    return out


def probe():
    """One row a case: (rewrite, label, fired in the JAX package, in the
    port, nodes with the rewrite and without it in the port, ops equal,
    values bit for bit equal)."""
    from pytensor_tpu_torch.link.cuda.rewrite_cases import CASES

    rows = []
    for case in CASES:
        r = run(case)
        (fj, oj, vj, _), (ft, ot, vt, bare) = r["jax"], r["torch"]
        rows.append((case.rewrite, case.label, fj, ft, len(ot), len(bare), oj == ot,
                     bool(np.array_equal(vj, vt, equal_nan=True))))
    return rows


if __name__ == "__main__":
    import sys

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.environ.setdefault("JAX_PLATFORMS", "cpu")
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    print("missing from the port:", missing_names())
    print(f"{'rewrite':46s} {'graph':58s} jax port nodes bare  ops  bits")
    for name, label, fj, ft, n, nb, same, bits in probe():
        print(f"{name:46s} {label[:58]:58s} {fj:3d} {ft:4d} {n:5d} {nb:4d}  {same!s:5s} {bits}")

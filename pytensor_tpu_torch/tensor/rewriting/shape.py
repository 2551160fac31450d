"""Shape rewrites.

Counterpart of ``pytensor_tpu/tensor/rewriting/shape.py`` (PyTensor's
tensor/rewriting/shape.py local_useless_reshape), cut to the rewrite that
fires on the radon logp+dlogp graphs.  Its ShapeFeature branch, which
proves a reshape useless on graphs with unknown dims, is not ported: the
radon graphs have static shapes, and the static branch is the one that
fires there.
"""

from __future__ import annotations

from pytensor_tpu_torch.compile.mode import register_specialize, register_useless
from pytensor_tpu_torch.graph.rewriting.basic import node_rewriter
from pytensor_tpu_torch.tensor.shape import Reshape


@node_rewriter([Reshape])
def local_useless_reshape(fgraph, node):
    """reshape(x, shape-of-x) -> x when the static types prove it."""
    x = node.inputs[0]
    out = node.outputs[0]
    if x.type == out.type and all(s is not None for s in x.type.shape):
        return [x]
    return False


register_useless(local_useless_reshape, name="local_useless_reshape")
register_specialize(local_useless_reshape, name="local_useless_reshape")

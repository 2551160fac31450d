"""Subtensor rewrites.

Counterpart of ``pytensor_tpu/tensor/rewriting/subtensor.py``, cut to the
rewrites that fire on the radon logp+dlogp graphs.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.compile.mode import register_canonicalize, register_specialize
from pytensor_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from pytensor_tpu_torch.tensor.subtensor import (
    DYN,
    AdvancedIncSubtensor,
    AdvancedIncSubtensor1,
    Subtensor,
)


def _full_slice(e, dim=None):
    """Is this idx_list entry a slice covering the whole axis?  With a
    static ``dim``, statically-full bounded slices (0:dim:1) count."""
    if not (isinstance(e, tuple) and e and e[0] == "slice"):
        return False
    start, stop, step = e[1], e[2], e[3]
    if step not in (None, 1):
        return False
    if start not in (None, 0):
        return False
    if stop is None:
        return True
    return dim is not None and isinstance(stop, int) and stop >= dim


@node_rewriter([AdvancedIncSubtensor, AdvancedIncSubtensor1])
def local_scatter_add_to_onehot_dot(fgraph, node):
    """zeros[..., idx, ...] += y  ->  moveaxis(tensordot(y, onehot), ...)
    for a constant integer-vector index.

    Ported as the JAX package has it, so that both packages rewrite the
    radon graphs alike.  It was chosen for the TPU's matrix unit; whether
    a one-hot product beats a scatter-add on Hopper is an open question
    (ROADMAP.md).  This is the hot pattern of every hierarchical-model
    gradient: the segment-sum of per-observation grads into groups."""
    from pytensor_tpu_torch.graph.basic import Constant
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable, moveaxis
    from pytensor_tpu_torch.tensor.math import tensordot
    from pytensor_tpu_torch.tensor.rewriting.math import _unique_value

    op = node.op
    if op.set_instead_of_inc or getattr(op, "ignore_duplicates", False):
        return False
    x, y, *indices = node.inputs
    out = node.outputs[0]
    if out.type.dtype not in ("float16", "bfloat16", "float32"):
        # same dtype gate as the JAX package, which chose it for the TPU
        return False
    if _unique_value(x) != 0:
        return False
    if isinstance(op, AdvancedIncSubtensor1):
        axis = 0
    else:
        # exactly one dynamic entry (the integer vector), everything else a
        # full slice
        axis = None
        n_dyn = 0
        for pos, e in enumerate(op.idx_list):
            if e == DYN:
                n_dyn += 1
                axis = pos
            elif isinstance(e, tuple) and e[0] == "slice" \
                    and e[1:] == (None, None, None):
                continue
            else:
                return False
        if n_dyn != 1 or len(indices) != 1:
            return False
    idx = indices[0]
    if not isinstance(idx, Constant) or idx.type.ndim != 1 \
            or np.asarray(idx.data).dtype.kind not in "iu":
        return False
    n_bins = x.type.shape[axis]
    if n_bins is None:
        return False
    idx_v = np.asarray(idx.data)
    if idx_v.size * n_bins > 8_000_000:
        return False  # keep the embedded one-hot constant bounded
    if idx_v.min() < -n_bins or idx_v.max() >= n_bins:
        return False
    onehot = np.zeros((idx_v.size, n_bins), dtype=out.type.dtype)
    onehot[np.arange(idx_v.size), idx_v % n_bins] = 1
    oh = as_tensor_variable(onehot)
    # y has x's ndim with length n_idx at `axis` (all other entries are
    # full slices / the leading axis); contract it against the one-hot rows
    if y.type.ndim != x.type.ndim:
        return False
    if y.type.shape[axis] != idx_v.size:
        # unknown (or mismatched) static length: keep the scatter path so
        # the runtime no-broadcast contract can raise its ValueError
        # (tensordot would fail with an opaque shape TypeError instead)
        return False
    res = tensordot(y, oh, axes=[[axis], [0]])
    res = moveaxis(res, -1, axis)
    if any(d is not None for d in out.type.shape):
        from pytensor_tpu_torch.tensor.shape import specify_shape

        res = specify_shape(res, out.type.shape)
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_scatter_add_to_onehot_dot,
                    name="local_scatter_add_to_onehot_dot")


@node_rewriter([Subtensor])
def local_subtensor_remove_broadcastable_index(fgraph, node):
    """x[..., 0, ...] on statically-length-1 dims -> a dim-dropping
    DimShuffle (reference :1048): keeps the graph in the elemwise world
    where fusion applies instead of the slicing world."""
    x = node.inputs[0]
    drop = []
    d = 0
    for e in node.op.idx_list:
        if isinstance(e, (int, np.integer)):
            if e in (0, -1) and x.type.shape[d] == 1:
                drop.append(d)
                d += 1
                continue
            return False
        if not _full_slice(e):
            return False
        d += 1
    if not drop:
        return False
    keep = [i for i in range(x.type.ndim) if i not in drop]
    res = x.dimshuffle(keep)
    out = node.outputs[0]
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_subtensor_remove_broadcastable_index,
                      name="local_subtensor_remove_broadcastable_index")
register_specialize(local_subtensor_remove_broadcastable_index,
                    name="local_subtensor_remove_broadcastable_index")

"""Subtensor rewrites.

Counterpart of ``pytensor_tpu/tensor/rewriting/subtensor.py``, cut to the
rewrites that fire on the radon logp+dlogp graphs and on the
logistic-regression and MLP steps.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.compile.mode import (
    register_canonicalize,
    register_specialize,
    specialize,
)
from pytensor_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from pytensor_tpu_torch.tensor.subtensor import (
    DYN,
    AdvancedIncSubtensor,
    AdvancedIncSubtensor1,
    AdvancedSubtensor1,
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


# Constant-index gather/scatter -> one-hot matrix products
# (``pytensor_tpu/tensor/rewriting/subtensor.py:800-903``).  When the index
# vector is a graph constant (the hierarchical-model pattern a[county]),
# x[idx] == onehot @ x and inc_subtensor(x[idx], y) == x + onehot.T @ y
# exactly.  Tagged ``onehot_gather`` only, not ``fast_run``, as in the JAX
# package: a mode opts in with ``mode.including("onehot_gather")``.  They
# are what make the radon leapfrog body eligible for the whole-loop scan
# kernel (K2), which emits Dot but not AdvancedSubtensor1.

_ONEHOT_MAX_ELEMS = 1 << 20  # onehot matrix size cap (4 MB f32)


def _onehot_constant(idx_data, n, dtype):
    from pytensor_tpu_torch.tensor.basic import constant

    idx = np.asarray(idx_data).astype(np.int64)
    if idx.ndim != 1 or idx.size == 0:
        return None
    if (idx < -n).any() or (idx >= n).any():
        return None
    idx = np.where(idx < 0, idx + n, idx)
    onehot = np.zeros((idx.size, n), dtype=dtype)
    onehot[np.arange(idx.size), idx] = 1
    return constant(onehot)


def _onehot_operands(x, ilist):
    """(n, m) of a constant-index gather/scatter the rewrite takes, or None."""
    from pytensor_tpu_torch.graph.basic import Constant

    if not isinstance(ilist, Constant):
        return None
    if x.type.ndim not in (1, 2) or not x.type.dtype.startswith(("float", "bfloat")):
        return None
    n = x.type.shape[0]
    if n is None:
        return None
    m = int(np.asarray(ilist.data).size)
    if m * n > _ONEHOT_MAX_ELEMS:
        return None
    return n, m


@node_rewriter([AdvancedSubtensor1])
def local_constant_gather_to_onehot_dot(fgraph, node):
    """x[const_ivec] -> dot(onehot, x)."""
    from pytensor_tpu_torch.tensor.math import dot

    x, ilist = node.inputs
    if _onehot_operands(x, ilist) is None:
        return False
    onehot = _onehot_constant(ilist.data, x.type.shape[0], x.type.dtype)
    if onehot is None:
        return False
    out = dot(onehot, x)
    if not node.outputs[0].type.is_super(out.type):
        return False
    copy_stack_trace(node.outputs[0], out)
    return [out]


specialize.register("local_constant_gather_to_onehot_dot",
                    local_constant_gather_to_onehot_dot, "onehot_gather")


@node_rewriter([AdvancedIncSubtensor1])
def local_constant_scatter_to_onehot_dot(fgraph, node):
    """inc_subtensor(x[const_ivec], y) -> x + dot(onehot.T, y) (exact with
    duplicate indices)."""
    from pytensor_tpu_torch.tensor.basic import transpose
    from pytensor_tpu_torch.tensor.math import dot

    if node.op.set_instead_of_inc:
        return False  # set semantics = last-write-wins, not a sum
    x, y, ilist = node.inputs
    if _onehot_operands(x, ilist) is None or y.type.ndim != x.type.ndim:
        return False
    onehot = _onehot_constant(ilist.data, x.type.shape[0], x.type.dtype)
    if onehot is None:
        return False
    out = x + dot(transpose(onehot), y)
    if not node.outputs[0].type.is_super(out.type):
        return False
    copy_stack_trace(node.outputs[0], out)
    return [out]


specialize.register("local_constant_scatter_to_onehot_dot",
                    local_constant_scatter_to_onehot_dot, "onehot_gather")


@node_rewriter([Subtensor])
def local_convert_negative_indices(fgraph, node):
    """Static negative integer indices and slice bounds on a static dim
    become their non-negative form (PyTensor's :1376): pattern matchers
    downstream reason about canonical indices only."""
    x = node.inputs[0]
    changed = False
    new_idx = []
    d = 0
    for e in node.op.idx_list:
        dim = x.type.shape[d] if d < x.type.ndim else None
        if isinstance(e, (int, np.integer)) and e < 0 and dim is not None:
            new_idx.append(int(e) + dim)
            changed = True
        elif isinstance(e, tuple) and e and e[0] == "slice" \
                and dim is not None:
            _, a, b, c = e
            step_pos = c is None or (isinstance(c, int) and c > 0)
            if step_pos and isinstance(a, int) and a < 0 and a + dim >= 0:
                a, changed = a + dim, True
            if step_pos and isinstance(b, int) and b < 0 and b + dim >= 0:
                b, changed = b + dim, True
            new_idx.append(("slice", a, b, c))
        else:
            new_idx.append(e)
        d += 1
    if not changed:
        return False
    res = Subtensor(new_idx)(*node.inputs)
    out = node.outputs[0]
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_convert_negative_indices,
                      name="local_convert_negative_indices")


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

"""Subtensor rewrites.

Counterpart of ``pytensor_tpu/tensor/rewriting/subtensor.py``, cut to the
rewrites that fire on the radon logp+dlogp graphs, on the
logistic-regression and MLP steps and on the Elman BPTT step, registered
in the JAX package's order.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.compile.mode import (
    register_canonicalize,
    register_specialize,
    register_useless,
    specialize,
)
from pytensor_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from pytensor_tpu_torch.tensor.subtensor import (
    DYN,
    AdvancedIncSubtensor,
    AdvancedIncSubtensor1,
    AdvancedSubtensor,
    AdvancedSubtensor1,
    IncSubtensor,
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


@node_rewriter([Subtensor])
def local_useless_subtensor(fgraph, node):
    """x[:, :, ...] with only full slices -> x; drop trailing full slices."""
    idx_list = node.op.idx_list
    if all(_full_slice(e) for e in idx_list):
        return [node.inputs[0]]
    # strip trailing full slices
    n = len(idx_list)
    while n > 0 and _full_slice(idx_list[n - 1]):
        n -= 1
    if n < len(idx_list):
        out = Subtensor(idx_list[:n])(*node.inputs)
        copy_stack_trace(node.outputs[0], out)
        return [out]
    return False


register_useless(local_useless_subtensor, name="local_useless_subtensor")


def _unflatten_index(idx_list, dyn_inputs):
    """idx_list (+ its dynamic node inputs) -> per-dim entries: int,
    scalar Variable, or a ``slice`` whose parts are None/int/Variable."""
    it = iter(dyn_inputs)
    out = []
    for e in idx_list:
        if e == DYN:
            out.append(next(it))
        elif isinstance(e, (int, np.integer)):
            out.append(int(e))
        else:
            _, a, b, c = e
            a = next(it) if a == DYN else a
            b = next(it) if b == DYN else b
            c = next(it) if c == DYN else c
            out.append(slice(a, b, c))
    return out


def _is_int(v):
    return isinstance(v, (int, np.integer))


def _merge_static_range(inner_sl, outer, n):
    """Exact merge of ``x[inner_sl][outer]`` (all-constant bounds, static
    dim length ``n``) using Python range arithmetic — any steps, any
    signs.  ``outer`` is an int or slice.  Returns int | slice | None."""
    parts = (inner_sl.start, inner_sl.stop, inner_sl.step)
    if not all(p is None or _is_int(p) for p in parts):
        return None
    if isinstance(outer, slice):
        oparts = (outer.start, outer.stop, outer.step)
        if not all(p is None or _is_int(p) for p in oparts):
            return None
    elif not _is_int(outer):
        return None
    r = range(*inner_sl.indices(n))
    try:
        rr = r[outer]
    except IndexError:
        return None  # static OOB: leave for the op's own error contract
    if isinstance(rr, int):
        return rr
    if len(rr) == 0:
        return slice(0, 0, None)
    start, stop, step = rr.start, rr.stop, rr.step
    if step < 0 and stop < 0:
        stop = None  # range stop -1 == "through index 0"
    return slice(start, stop, None if step == 1 else step)


def _merge_slices_shape_free(s1, s2):
    """Merge two constant-bound slices (steps in {None, 1, -1}) without
    knowing the dim length; None when the merge would need the shape.
    Ports the semantics of the reference's
    ``_merge_slice_into_slice_no_shape_ref``
    (PyTensor's tensor/rewriting/subtensor.py:652)."""
    def norm(v):
        if v is None or _is_int(v):
            return v
        return "sym"

    a1, b1, c1 = norm(s1.start), norm(s1.stop), norm(s1.step)
    a2, b2, c2 = norm(s2.start), norm(s2.stop), norm(s2.step)
    if "sym" in (a1, b1, a2, b2) or c1 not in (None, 1, -1) or \
            c2 not in (None, 1, -1):
        return None
    c1 = None if c1 == 1 else c1
    c2 = None if c2 == 1 else c2

    if c1 is None and c2 is None:
        if a2 is None or a2 >= 0:
            a2 = a2 or 0
            if a1 is None or a1 >= 0:
                a1 = a1 or 0
                if b1 is None:
                    if b2 is None:
                        return slice(a1 + a2, None)
                    return slice(a1 + a2, b2 if b2 < 0 else a1 + b2)
                if b2 is None:
                    return slice(a1 + a2, b1)
                if b2 < 0:
                    return slice(a1 + a2, b1 + b2) if b1 < 0 else None
                if b1 > 0:
                    return slice(a1 + a2, min(b1, a1 + b2))
                return None
            # a1 < 0: sound only when a2 == 0
            if a2 != 0:
                return None
            if b1 is None:
                if b2 is None:
                    return slice(a1, None)
                return slice(a1, b2) if b2 < 0 else None
            if b1 < 0:
                if b2 is None:
                    return slice(a1, b1)
                return slice(a1, b1 + b2) if b2 < 0 else None
            return None
        # a2 < 0
        if (a1 is not None and a1 < 0) and b1 is None and \
                (b2 is None or b2 < 0):
            return slice(max(a1, a2), b2)
        return None

    if c1 is None and c2 == -1:
        # [a1:b1][::-1] only
        if a2 is None and b2 is None:
            if b1 == 0:
                return slice(0, 0, -1)
            return slice(None if b1 is None else b1 - 1,
                         None if a1 in (None, 0) else a1 - 1, -1)
        return None

    if c1 == -1 and c2 is None:
        # [::-1][a2:b2] only
        if a1 is None and b1 is None:
            return slice(None if a2 is None else -a2 - 1,
                         None if b2 is None else -b2 - 1, -1)
        return None

    # c1 == c2 == -1
    if a1 is None and b1 is None:
        if a2 is None and b2 is None:
            return slice(None)
        return slice(None if a2 is None else -a2 - 1,
                     None if b2 is None else -b2 - 1, None)
    if a2 is None and b2 is None:
        if (a1 is None or a1 >= 0) and (b1 is None or b1 >= 0):
            return slice(None if b1 is None else b1 + 1,
                         None if a1 is None else a1 + 1, None)
    return None


# eager graph/arithmetic helpers: Python ints fold immediately, Variables
# build switch/min/max graphs (which the constant folder finishes off)
def _e_lt0(v):
    from pytensor_tpu_torch.tensor.math import lt

    if _is_int(v):
        return v < 0
    return lt(v, 0)


def _e_switch(cond, a, b):
    from pytensor_tpu_torch.tensor.math import switch

    if cond is True:
        return a
    if cond is False:
        return b
    if a is b:
        return a
    return switch(cond, a, b)


def _e_min(a, b):
    from pytensor_tpu_torch.tensor.math import minimum

    if _is_int(a) and _is_int(b):
        return min(a, b)
    return minimum(a, b)


def _e_max(a, b):
    from pytensor_tpu_torch.tensor.math import maximum

    if _is_int(a) and _is_int(b):
        return max(a, b)
    return maximum(a, b)


def _e_add(a, b):
    if _is_int(a) and _is_int(b):
        return a + b
    return a + b  # Variable arithmetic builds the graph


def _canon_bound(v, n, default):
    """Canonical non-negative slice bound: None -> default; negative ->
    max(v + n, 0); non-negative -> min(v, n).  Sign-eager for ints."""
    if v is None:
        return default
    if _is_int(v):
        return _e_max(_e_add(v, n), 0) if v < 0 else _e_min(v, n)
    return _e_switch(_e_lt0(v), _e_max(_e_add(v, n), 0), _e_min(v, n))


def _merge_symbolic_step1(s1, outer, n):
    """Merge ``x[s1][outer]`` for step-1 slices with symbolic (or mixed)
    bounds, given ``n`` = dim length (int or scalar Variable).  ``outer``
    is a step-1 slice or a scalar index (int or Variable).  Returns the
    merged slice / scalar index, or None.  Scalar merges follow the
    reference's shape_unsafe contract (in-bounds indices stay correct;
    PyTensor's tensor/rewriting/subtensor.py:823)."""
    if s1.step not in (None, 1):
        return None
    if isinstance(outer, slice):
        if outer.step not in (None, 1):
            return None
        sa = _canon_bound(s1.start, n, 0)
        sb = _canon_bound(s1.stop, n, n)
        len2 = _e_max(sb - sa, 0)
        oa = _canon_bound(outer.start, len2, 0)
        ob = _canon_bound(outer.stop, len2, len2)
        return slice(_e_add(sa, oa), _e_add(sa, ob), None)
    # scalar outer index: positive counts from the effective start,
    # negative counts from the effective stop (kept negative so it keeps
    # resolving against the full length)
    k = outer
    if s1.start is None:
        pos = k
    else:
        a = s1.start
        if _is_int(a):
            a_eff = _e_max(_e_add(a, n), 0) if a < 0 else a
        else:
            a_eff = _e_switch(_e_lt0(a), _e_max(_e_add(a, n), 0), a)
        pos = _e_add(a_eff, k)
    if s1.stop is None:
        neg = k
    else:
        b = s1.stop
        b_eff = b if (_is_int(b) and b < 0) else _e_min(b, n)
        neg = _e_add(b_eff, k)
    if _is_int(k):
        return neg if k < 0 else pos
    return _e_switch(_e_lt0(k), neg, pos)


@node_rewriter([Subtensor])
def local_subtensor_merge(fgraph, node):
    """Merge ``Subtensor(Subtensor(x))`` into one indexing operation,
    pairing inner/outer entries per dimension (reference
    ``_local_subtensor_merge_rewrite``,
    PyTensor's tensor/rewriting/subtensor.py:925).
    Strategies per dim, in order: exact range arithmetic when bounds and
    the dim length are static; the shape-free constant-bound table for
    steps +-1; symbolic step-1 slice/scalar merges via canonical-bound
    switch trees."""
    inner_var = node.inputs[0]
    if inner_var.owner is None or not isinstance(inner_var.owner.op,
                                                 Subtensor):
        return False
    if len(fgraph.clients.get(inner_var, ())) != 1:
        return False
    x = inner_var.owner.inputs[0]
    indices_inner = _unflatten_index(inner_var.owner.op.idx_list,
                                     inner_var.owner.inputs[1:])
    indices_outer = _unflatten_index(node.op.idx_list, node.inputs[1:])

    merged = []
    residual = []
    pos_outer = 0
    any_merged = False
    exhausted = False
    for pos_inner, e1 in enumerate(indices_inner):
        if pos_outer >= len(indices_outer):
            merged.extend(indices_inner[pos_inner:])
            exhausted = True
            break
        if not isinstance(e1, slice):
            merged.append(e1)  # scalar index: consumes dim, no output dim
            continue
        e2 = indices_outer[pos_outer]
        pos_outer += 1
        if isinstance(e2, slice) and e2 == slice(None, None, None):
            merged.append(e1)
            residual.append(slice(None))
            continue
        n_static = x.type.shape[pos_inner]
        m = None
        if e1 == slice(None, None, -1) and not isinstance(e2, slice):
            # x[::-1][i] == x[-1 - i] for every in-bounds i of either
            # sign, and out-of-bounds i maps out of bounds (reference
            # TestLocalSubtensorMerge::test_const2/test_scalar2)
            if isinstance(e2, (int, np.integer)):
                m = int(-1 - e2)
            else:
                m = -1 - e2
        if m is None and n_static is not None \
                and isinstance(e2, (slice, int, np.integer)):
            m = _merge_static_range(e1, e2, n_static)
        if m is None and isinstance(e2, slice):
            m = _merge_slices_shape_free(e1, e2)
        if m is None:
            if n_static is not None:
                n = n_static
            else:
                from pytensor_tpu_torch.tensor.shape import Shape_i

                n = Shape_i(pos_inner)(x)
            m = _merge_symbolic_step1(e1, e2, n)
        if m is not None:
            any_merged = True
            merged.append(m)
            if isinstance(m, slice):
                residual.append(slice(None))
        else:
            merged.append(e1)
            residual.append(e2)
    if not exhausted and indices_outer[pos_outer:]:
        # outer entries beyond the inner idx_list index x's untouched dims
        any_merged = True
        merged.extend(indices_outer[pos_outer:])
    if not any_merged:
        return None

    while residual and isinstance(residual[-1], slice) and \
            residual[-1] == slice(None, None, None):
        residual.pop()
    out = x[tuple(merged)]
    if residual:
        out = out[tuple(residual)]
    ref = node.outputs[0]
    if out.type.dtype != ref.type.dtype or out.type.ndim != ref.type.ndim:
        return False
    if not ref.type.is_super(out.type):
        # the merged form can lose optimistic static-shape info (e.g.
        # negative merged bounds over an unknown dim); reassert the
        # original contract so the replacement type-checks
        from pytensor_tpu_torch.tensor.shape import specify_shape

        out = specify_shape(out, ref.type.shape)
        if not ref.type.is_super(out.type):
            return False
    copy_stack_trace(ref, out)
    return [out]


register_canonicalize(local_subtensor_merge, name="local_subtensor_merge")


@node_rewriter([Subtensor])
def local_subtensor_of_dot(fgraph, node):
    """dot(a, b)[i_rows] -> dot(a[i_rows], b) (reference
    rewriting/subtensor.py local_subtensor_of_dot): indexing before the
    matmul shrinks the product's work and its memory traffic."""
    from pytensor_tpu_torch.tensor.math import Dot, dot

    x = node.inputs[0]
    if x.owner is None or not isinstance(x.owner.op, Dot):
        return False
    if len(fgraph.clients.get(x, ())) != 1:
        return False
    a, b = x.owner.inputs
    if a.type.ndim != 2:
        return False
    idx = node.op.idx_list
    if len(idx) != 1:
        return False  # only leading-dim indexing moves cleanly
    new_a = type(node.op)(node.op.idx_list)(a, *node.inputs[1:])
    res = dot(new_a, b)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_subtensor_of_dot, name="local_subtensor_of_dot")


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


# ---------------------------------------------------------------------------
# subtensor lift pack (reference tensor/rewriting/subtensor_lift.py):
# push indexing toward the leaves so downstream ops compute less.
# ---------------------------------------------------------------------------

def _entry_ndyn(e):
    """Dynamic inputs consumed by a single idx_list entry."""
    if e == DYN:
        return 1
    if isinstance(e, tuple) and e and e[0] == "slice":
        return sum(1 for b in e[1:] if b == DYN)
    return 0


def _split_dyn(idx_list, dyn):
    """Pair each entry with its dynamic inputs."""
    out = []
    it = iter(dyn)
    for e in idx_list:
        out.append((e, [next(it) for _ in range(_entry_ndyn(e))]))
    return out


FULL = ("slice", None, None, None)


@node_rewriter([Subtensor])
def local_subtensor_of_elemwise(fgraph, node):
    """elemwise(a, b, ...)[idx] -> elemwise(a[idx'], b[idx'], ...): index
    first, compute on the smaller block (reference local_subtensor_lift).
    Broadcast inputs get the entry replaced by 0 / full-slice on their
    size-1 axes."""
    from pytensor_tpu_torch.tensor.elemwise import Elemwise

    x = node.inputs[0]
    if x.owner is None or not isinstance(x.owner.op, Elemwise):
        return False
    if len(fgraph.clients.get(x, ())) != 1:
        return False
    if x.owner.op.scalar_op.name == "second":
        return False  # fill: carrier semantics, handled elsewhere
    idx_list = node.op.idx_list
    pairs = _split_dyn(idx_list, node.inputs[1:])
    new_inputs = []
    for i in x.owner.inputs:
        if i.type.ndim == 0:
            new_inputs.append(i)
            continue
        offset = x.type.ndim - i.type.ndim
        entries = []
        dyns = []
        ok = True
        for k, (e, ed) in enumerate(pairs):
            if k < offset:
                continue  # the input broadcasts over this leading dim
            d = k - offset
            if i.type.shape[d] == 1 and x.type.shape[k] != 1:
                # broadcast axis: neutral entry
                if isinstance(e, tuple) and e[0] == "slice":
                    entries.append(FULL)
                else:
                    entries.append(0)
                continue
            if i.type.shape[d] is not None and x.type.shape[k] is not None \
                    and i.type.shape[d] == x.type.shape[k]:
                entries.append(e)
                dyns.extend(ed)
                continue
            if e == FULL:
                entries.append(e)
                continue
            ok = False  # can't prove the axis isn't broadcast at runtime
            break
        if not ok:
            return False
        # strip trailing full slices
        while entries and entries[-1] == FULL:
            entries.pop()
        new_inputs.append(Subtensor(entries)(i, *dyns) if entries else i)
    res = Elemwise(x.owner.op.scalar_op)(*new_inputs)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_subtensor_of_elemwise, name="local_subtensor_of_elemwise")


@node_rewriter([Subtensor])
def local_subtensor_of_dimshuffle(fgraph, node):
    """x.dimshuffle(perm/'x')[idx] -> x[permuted idx].dimshuffle(...) for
    non-dropping DimShuffles (transpose and expand_dims)."""
    from pytensor_tpu_torch.tensor.elemwise import DimShuffle

    v = node.inputs[0]
    if v.owner is None or not isinstance(v.owner.op, DimShuffle):
        return False
    if len(fgraph.clients.get(v, ())) != 1:
        return False
    ds = v.owner.op
    x = v.owner.inputs[0]
    if sorted(o for o in ds.new_order if o != "x") != list(range(x.type.ndim)):
        return False  # drops dims: leave alone
    pairs = _split_dyn(node.op.idx_list, node.inputs[1:])
    # pad to the dimshuffled ndim
    while len(pairs) < len(ds.new_order):
        pairs.append((FULL, []))
    x_entries = {}
    kept = []  # (order_pos, 'x' or input axis) for output dims
    for k, o in enumerate(ds.new_order):
        e, ed = pairs[k]
        if o == "x":
            if e == FULL:
                kept.append((k, "x"))
                continue
            if isinstance(e, (int, np.integer)) and e in (0, -1):
                continue  # drops the inserted axis
            return False  # dynamic/sliced index into a synthetic axis
        x_entries[o] = (e, ed)
        if not isinstance(e, (int, np.integer)) and e != DYN:
            kept.append((k, o))
    # build the inner subtensor in input-axis order
    entries = []
    dyns = []
    for a in range(x.type.ndim):
        e, ed = x_entries.get(a, (FULL, []))
        entries.append(e)
        dyns.extend(ed)
    while entries and entries[-1] == FULL:
        entries.pop()
    inner = Subtensor(entries)(x, *dyns) if entries else x
    # remaining input axes in ascending order = inner's dim order
    kept_in_axes = sorted(o for _, o in kept if o != "x")
    new_order = []
    for _, o in sorted(kept):
        new_order.append("x" if o == "x" else kept_in_axes.index(o))
    res = inner
    if new_order != list(range(inner.type.ndim)):
        res = DimShuffle(inner.type.ndim, tuple(new_order))(inner)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_subtensor_of_dimshuffle,
                    name="local_subtensor_of_dimshuffle")


@node_rewriter([Subtensor])
def local_subtensor_of_alloc(fgraph, node):
    """Alloc(v, s...)[idx] -> Alloc(v, sliced lengths...) for a scalar
    fill value: never materialize the big buffer."""
    from pytensor_tpu_torch.tensor.basic import Alloc, alloc
    from pytensor_tpu_torch.tensor.subtensor import _sym_slice_len

    v0 = node.inputs[0]
    if v0.owner is None or not isinstance(v0.owner.op, Alloc):
        return False
    fill, *shape_vars = v0.owner.inputs
    if fill.type.ndim != 0:
        return False
    idx_list = node.op.idx_list
    if any(_entry_ndyn(e) for e in idx_list) or DYN in idx_list:
        return False  # dynamic bounds: net win unclear, skip
    new_shape = []
    d = 0
    for e in idx_list:
        if isinstance(e, (int, np.integer)):
            d += 1
            continue
        _, a, b, c = e
        new_shape.append(_sym_slice_len(a, b, c, shape_vars[d]))
        d += 1
    new_shape.extend(shape_vars[d:])
    out = node.outputs[0]
    res = alloc(fill, *new_shape) if new_shape else fill
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_subtensor_of_alloc, name="local_subtensor_of_alloc")


@node_rewriter([Subtensor])
def local_subtensor_of_makevector(fgraph, node):
    """MakeVector(a, b, c)[static idx] -> the element / a smaller
    MakeVector."""
    from pytensor_tpu_torch.tensor.basic import MakeVector, make_vector

    v = node.inputs[0]
    if v.owner is None or not isinstance(v.owner.op, MakeVector):
        return False
    idx_list = node.op.idx_list
    if len(idx_list) != 1:
        return False
    (e,) = idx_list
    elems = v.owner.inputs
    out = node.outputs[0]
    if isinstance(e, (int, np.integer)):
        res = elems[int(e)]
    elif isinstance(e, tuple) and e[0] == "slice" \
            and not any(b == DYN for b in e[1:]):
        picked = elems[slice(e[1], e[2], e[3])]
        if len(picked) == len(elems):
            return False
        res = MakeVector(v.owner.op.dtype)(*picked)
    else:
        return False
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_subtensor_of_makevector,
                      name="local_subtensor_of_makevector")


def _full_reversed_slice(e):
    """('slice', None, None, -1): the whole axis, reversed."""
    return (isinstance(e, tuple) and e and e[0] == "slice"
            and e[1] is None and e[2] is None and e[3] == -1)


@node_rewriter([IncSubtensor])
def local_useless_inc_subtensor(fgraph, node):
    """Writes covering every position of the buffer drop the scatter
    (reference test_local_useless_inc_subtensor): each index entry is a
    full or fully-reversed slice, so ``set(x[idx], y) -> y[idx]`` and
    ``inc(x[idx], y) -> x + y[idx]`` (reversal is self-inverse, so the
    same idx_list maps y's positions back)."""
    x, y = node.inputs[0], node.inputs[1]
    shape = x.type.shape
    entries = []
    any_rev = False
    for i, e in enumerate(node.op.idx_list):
        dim = shape[i] if i < len(shape) else None
        if _full_slice(e, dim):
            entries.append(("slice", None, None, None))
        elif _full_reversed_slice(e):
            entries.append(("slice", None, None, -1))
            any_rev = True
        else:
            return False
    out = node.outputs[0]
    if y.type.ndim != x.type.ndim:
        return False
    if any_rev:
        while entries and _full_slice(entries[-1]):
            entries.pop()
        y_view = Subtensor(tuple(entries))(y)
    else:
        y_view = y
    if node.op.set_instead_of_inc:
        res = y_view
        if res.type.dtype != out.type.dtype or not out.type.is_super(
                res.type):
            return False
    else:
        res = x + y_view
        if res.type.dtype != out.type.dtype or not out.type.is_super(
                res.type):
            return False
    copy_stack_trace(out, res)
    return [res]


register_useless(local_useless_inc_subtensor, name="local_useless_inc_subtensor")


@node_rewriter([Subtensor])
def local_subtensor_of_unbroadcast_cast(fgraph, node):
    """x.astype(d)[idx] -> x[idx].astype(d): index before the copy."""
    from pytensor_tpu_torch.tensor.basic import cast as t_cast
    from pytensor_tpu_torch.tensor.elemwise import Elemwise

    v = node.inputs[0]
    if v.owner is None or not isinstance(v.owner.op, Elemwise):
        return False
    if not v.owner.op.scalar_op.name.startswith("cast{"):
        return False
    if len(fgraph.clients.get(v, ())) != 1:
        return False
    inner = v.owner.inputs[0]
    res = t_cast(Subtensor(node.op.idx_list)(inner, *node.inputs[1:]),
                 v.type.dtype)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_subtensor_of_unbroadcast_cast,
                    name="local_subtensor_of_cast")


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
def local_subtensor_of_reduce(fgraph, node):
    """reduce(x, axis)[idx] -> reduce(x[idx'], axis') — index BEFORE
    reducing so only the consumed slice is computed (reference
    subtensor_lift.py:553).  Handles a single leading index entry."""
    from pytensor_tpu_torch.tensor.elemwise import CAReduce

    x = node.inputs[0]
    if x.owner is None or not isinstance(x.owner.op, CAReduce):
        return False
    if len(fgraph.clients.get(x, ())) > 1:
        return False  # reduction shared: lifting would recompute
    red = x.owner.op
    inner = x.owner.inputs[0]
    axes = red.axis
    if axes is None:
        axes = tuple(range(inner.type.ndim))
    idx_list = node.op.idx_list
    if not idx_list:
        return False
    # lift the FIRST NON-TRIVIAL entry (a leading full slice would
    # reproduce the same pattern and ping-pong the equilibrium pass)
    k = next((i for i, e in enumerate(idx_list) if not _full_slice(e)), None)
    if k is None or idx_list[k] == DYN:
        return False
    entry = idx_list[k]
    # map output dim k back to the k-th NON-reduced input dim
    non_reduced = [d for d in range(inner.type.ndim) if d not in axes]
    if k >= len(non_reduced):
        return False
    dk = non_reduced[k]
    dyn = node.inputs[1:]
    # count dynamic inputs consumed by one entry (full slices take none)
    def _dyn_count(e):
        if e == DYN:
            return 1
        if isinstance(e, tuple) and e[0] == "slice":
            return sum(1 for p in e[1:] if p == DYN)
        return 0

    n0 = _dyn_count(entry)
    inner_idx = [("slice", None, None, None)] * dk + [entry]
    sub_inner = Subtensor(tuple(inner_idx))(inner, *dyn[:n0])
    dropped = isinstance(entry, (int, np.integer))
    if dropped:
        new_axes = tuple(a - 1 if a > dk else a for a in axes)
    else:
        new_axes = axes
    from pytensor_tpu_torch.tensor.elemwise import CAReduce as _CR

    new_red = _CR(red.scalar_op, new_axes, red.dtype, red.acc_dtype,
                  red.upcast_discrete_output)(sub_inner)
    # remaining outer index: leading full slices kept, position k either
    # dropped (int) or turned into a full slice, tail unchanged
    full = ("slice", None, None, None)
    rest_idx = list(idx_list[:k])
    if not dropped:
        rest_idx.append(full)
    rest_idx.extend(idx_list[k + 1:])
    while rest_idx and _full_slice(rest_idx[-1]):
        rest_idx.pop()
    if rest_idx:
        new_out = Subtensor(tuple(rest_idx))(new_red, *dyn[n0:])
    else:
        new_out = new_red
    if not node.outputs[0].type.is_super(new_out.type):
        return False
    copy_stack_trace(node.outputs[0], new_out)
    return [new_out]


register_specialize(local_subtensor_of_reduce,
                    name="local_subtensor_of_reduce")


@node_rewriter(None)
def local_advanced_subtensor1_of_dot(fgraph, node):
    """dot(A, B)[rows] -> dot(A[rows], B): the gather moves to the
    small operand and the matmul shrinks (reference
    subtensor_lift.py:351 local_advanced_subtensor_of_dot, the
    row-vector case)."""
    from pytensor_tpu_torch.tensor.blas import Dot22
    from pytensor_tpu_torch.tensor.math import Dot, dot
    from pytensor_tpu_torch.tensor.subtensor import AdvancedSubtensor1

    if not isinstance(node.op, AdvancedSubtensor1):
        return False
    x, ilist = node.inputs
    if x.owner is None or not isinstance(x.owner.op, (Dot, Dot22)):
        return False
    if len(fgraph.clients.get(x, ())) > 1:
        return False  # product materialized anyway
    a, b = x.owner.inputs
    if a.type.ndim != 2 or b.type.ndim != 2:
        return False
    res = dot(AdvancedSubtensor1()(a, ilist), b)
    out = node.outputs[0]
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_advanced_subtensor1_of_dot,
                    name="local_advanced_subtensor1_of_dot")


@node_rewriter([Subtensor])
def local_subtensor_of_join(fgraph, node):
    """join(axis, a, b, ...)[idx] with the index on a NON-join axis ->
    join of the indexed pieces (reference subtensor_lift.py:1198)."""
    from pytensor_tpu_torch.graph.basic import Constant
    from pytensor_tpu_torch.tensor.basic import Join

    x = node.inputs[0]
    if x.owner is None or not isinstance(x.owner.op, Join):
        return False
    if len(fgraph.clients.get(x, ())) > 1:
        return False
    axis_var = x.owner.inputs[0]
    if not isinstance(axis_var, Constant):
        return False
    jaxis = int(np.asarray(axis_var.data))
    if jaxis < 0:
        jaxis += x.type.ndim
    idx_list = node.op.idx_list
    # index entries must leave the join axis untouched (full slice or
    # not indexed at all)
    if jaxis < len(idx_list):
        e = idx_list[jaxis]
        if not (isinstance(e, tuple) and e[:1] == ("slice",)
                and e[1:] == (None, None, None)):
            return False
    pieces = x.owner.inputs[1:]
    dyn = node.inputs[1:]
    new_pieces = [Subtensor(idx_list)(p, *dyn) for p in pieces]
    # int entries before the join axis shift it left
    n_dropped = sum(1 for i, e in enumerate(idx_list)
                    if i < jaxis and isinstance(e, (int, np.integer)))
    new_out = Join()(jaxis - n_dropped, *new_pieces)
    if not node.outputs[0].type.is_super(new_out.type):
        return False
    copy_stack_trace(node.outputs[0], new_out)
    return [new_out]


register_specialize(local_subtensor_of_join, name="local_subtensor_of_join")


@node_rewriter([Subtensor])
def local_subtensor_of_specify_shape(fgraph, node):
    """x_specified[idx] -> x[idx] when the output type keeps the static
    info, else (reference subtensor_lift.py:1077) lift integer-only
    indexing through and re-specify the trailing dims:
    ``specify_shape(x, s)[i_1..i_n] -> specify_shape(x[i_1..i_n],
    s[n:])``.  Slices stay under the SpecifyShape — numpy clips slice
    bounds, so without the runtime check the sliced length is weaker
    than the declared type."""
    from pytensor_tpu_torch.tensor.shape import SpecifyShape, specify_shape

    x = node.inputs[0]
    if x.owner is None or not isinstance(x.owner.op, SpecifyShape):
        return False
    inner = x.owner.inputs[0]
    new_out = Subtensor(node.op.idx_list)(inner, *node.inputs[1:])
    if node.outputs[0].type.is_super(new_out.type):
        copy_stack_trace(node.outputs[0], new_out)
        return [new_out]
    if any(isinstance(e, tuple) for e in node.op.idx_list):
        return False  # slice entries: the check still guards their length
    shape_args = x.owner.inputs[1:]
    if new_out.type.ndim == 0:
        copy_stack_trace(node.outputs[0], new_out)
        return [new_out]
    res = specify_shape(new_out, shape_args[len(node.op.idx_list):])
    if not node.outputs[0].type.is_super(res.type):
        return False
    copy_stack_trace(node.outputs[0], res)
    return [res]


register_specialize(local_subtensor_of_specify_shape,
                    name="local_subtensor_of_specify_shape")


@node_rewriter(None)
def local_extract_diag_of_eye(fgraph, node):
    """diagonal(eye(n, m, k)) -> ones/zeros vector (reference
    subtensor_lift.py:959) — no matrix is ever materialized."""
    from pytensor_tpu_torch.graph.basic import Constant
    from pytensor_tpu_torch.tensor.basic import (ExtractDiag, Eye, NotScalarConstantError,
                                           get_scalar_constant_value, ones, zeros)

    if not isinstance(node.op, ExtractDiag):
        return False
    x = node.inputs[0]
    if x.owner is None or not isinstance(x.owner.op, Eye):
        return False
    if (node.op.axis1, node.op.axis2) != (0, 1):
        return False
    n_v, m_v, k_v = x.owner.inputs
    try:
        n = int(get_scalar_constant_value(n_v))
        m = int(get_scalar_constant_value(m_v))
        k_eye = int(get_scalar_constant_value(k_v))
    except NotScalarConstantError:
        return False
    k_extract = node.op.offset
    # length of the extracted diagonal
    L = max(0, min(n + min(0, k_extract), m - max(0, k_extract)))
    dtype = x.type.dtype
    new_out = (ones((L,), dtype=dtype) if k_extract == k_eye
               else zeros((L,), dtype=dtype))
    if not node.outputs[0].type.is_super(new_out.type):
        return False
    copy_stack_trace(node.outputs[0], new_out)
    return [new_out]


register_canonicalize(local_extract_diag_of_eye,
                      name="local_extract_diag_of_eye")
register_specialize(local_extract_diag_of_eye,
                    name="local_extract_diag_of_eye")


# ---------------------------------------------------------------------------
# data-dependent boolean masks -> where() (the JAX package's
# tensor/rewriting/subtensor.py:1130-1355).  x[mask] has a dynamic (nnz)
# shape; these rewrites turn the size-preserving uses (a reduction over
# everything, set/inc with a broadcast value, the shape) into switch(),
# so that sum, mean and .shape of x[mask], their gradients and set/inc of
# x[mask] link with static shapes, as in the JAX package.
# ---------------------------------------------------------------------------

def _sole_bool_mask(node, n_lead):
    """The mask variable when node indexes with exactly one boolean
    mask (inputs = leading data inputs + the mask), else None."""
    idx_inputs = node.inputs[n_lead:]
    if len(idx_inputs) != 1 or idx_inputs[0].type.dtype != "bool":
        return None
    if tuple(node.op.idx_list) != (DYN,):
        return None
    return idx_inputs[0]


def _broadcast_scalar_of(y, depth=4):
    """The 0-d variable that ``y`` broadcasts, or None.  Recognizes the
    forms the gradient builder emits: DimShuffle-expand, fill/second,
    Alloc, plus a literal 0-d y."""
    from pytensor_tpu_torch.tensor.basic import Alloc
    from pytensor_tpu_torch.tensor.elemwise import DimShuffle, Elemwise

    if y.type.ndim == 0:
        return y
    if all(s == 1 for s in y.type.shape):
        # size-1 broadcast (e.g. the [1.] pullback seed): squeeze to 0-d
        return DimShuffle(y.type.ndim, [])(y)
    if depth <= 0 or y.owner is None:
        return None
    op = y.owner.op
    if isinstance(op, DimShuffle) and not op.drop \
            and y.owner.inputs[0].type.ndim == 0:
        return y.owner.inputs[0]
    if isinstance(op, Elemwise) and getattr(op.scalar_op, "name", "") == "second":
        return _broadcast_scalar_of(y.owner.inputs[1], depth - 1)
    if isinstance(op, Alloc):
        return _broadcast_scalar_of(y.owner.inputs[0], depth - 1)
    return None


def _expand_mask(mask, ndim):
    """DimShuffle a k-d mask up to ndim by appending broadcast axes."""
    from pytensor_tpu_torch.tensor.elemwise import DimShuffle

    k = mask.type.ndim
    if k == ndim:
        return mask
    return DimShuffle(k, list(range(k)) + ["x"] * (ndim - k))(mask)


def _subst_same_mask_gathers(v, mask_box, depth=8):
    """Substitute every boolean-mask gather leaf in an elemwise tree by
    its (1-d) operand, recording the common mask in ``mask_box[0]``.
    Returns the substituted variable, or None if the tree mixes masks or
    contains anything that neither broadcasts along the masked axis nor
    is an elemwise of substitutable things."""
    from pytensor_tpu_torch.tensor.elemwise import Elemwise as _EW
    from pytensor_tpu_torch.tensor.subtensor import AdvancedSubtensor

    if v.owner is not None and isinstance(v.owner.op, AdvancedSubtensor):
        mk = _sole_bool_mask(v.owner, 1)
        xk = v.owner.inputs[0]
        if mk is None or xk.type.ndim != 1:
            return None
        if mask_box[0] is None:
            mask_box[0] = mk
        elif mask_box[0] is not mk:
            return None  # mixed masks: not a single-mask fill
        return xk
    if v.type.ndim == 0 or (v.type.ndim == 1 and v.type.shape[0] == 1):
        return v  # broadcasts along the masked axis
    if depth > 0 and v.type.ndim == 1 and v.owner is not None \
            and (isinstance(v.owner.op, _EW)
                 or type(v.owner.op).__name__ == "FusedElemwise"):
        subs = [_subst_same_mask_gathers(i, mask_box, depth - 1)
                for i in v.owner.inputs]
        if any(s is None for s in subs):
            return None
        r = v.owner.op(*subs)
        return None if isinstance(r, (list, tuple)) else r
    return None


@node_rewriter([AdvancedIncSubtensor])
def local_bool_set_or_inc_to_where(fgraph, node):
    """set/inc_subtensor(x[mask], broadcast-scalar y) ->
    switch(mask, y | x+y, x): size-preserving, XLA-compilable."""
    from pytensor_tpu_torch.tensor.basic import cast as t_cast
    from pytensor_tpu_torch.tensor.math import switch

    mask = _sole_bool_mask(node, 2)
    if mask is None:
        return False
    x, y = node.inputs[:2]
    scalar = _broadcast_scalar_of(y)
    if scalar is None and x.type.ndim == 1:
        # vector y that is an elemwise tree over gathers of the SAME
        # mask (e.g. the pullback of var(x[mask]): y = f(x[mask], ...))
        mask_box = [mask]
        scalar = _subst_same_mask_gathers(y, mask_box)
    if scalar is None:
        return False
    m = _expand_mask(mask, x.type.ndim)
    if node.op.set_instead_of_inc:
        res = switch(m, scalar, x)
    else:
        res = switch(m, x + scalar, x)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype:
        res = t_cast(res, out.type.dtype)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_bool_set_or_inc_to_where,
                    name="local_bool_set_or_inc_to_where")


@node_rewriter(None)
def local_reduce_of_bool_mask_to_where(fgraph, node):
    """sum(x[mask]) / prod(x[mask]) reduced to a scalar ->
    reduce(switch(mask, x, neutral)) over all of x."""
    from pytensor_tpu_torch.tensor.elemwise import CAReduce
    from pytensor_tpu_torch.tensor.math import switch
    from pytensor_tpu_torch.tensor.subtensor import AdvancedSubtensor

    if not isinstance(node.op, CAReduce):
        return False
    if node.outputs[0].type.ndim != 0:
        return False
    name = getattr(node.op.scalar_op, "name", "")
    if name not in ("add", "mul"):
        return False
    arg = node.inputs[0]
    if arg.owner is None:
        return False
    if isinstance(arg.owner.op, AdvancedSubtensor):
        mask = _sole_bool_mask(arg.owner, 1)
        if mask is None:
            return False
        x = arg.owner.inputs[0]
        m = _expand_mask(mask, x.type.ndim)
        neutral = np.asarray(0 if name == "add" else 1, dtype=x.type.dtype)
        filled = switch(m, x, neutral)
    else:
        # sum(f(x[mask], broadcast...)) with f an elemwise TREE over 1-d
        # operands: = sum(where(mask, f(x, broadcast...), neutral)) —
        # substitute every same-mask gather leaf by its operand.  Covers
        # var/std(x[mask]) ((x[m]-mean)^2 under the Sum) and friends.
        mask_box = [None]
        new_arg = _subst_same_mask_gathers(arg, mask_box)
        mask = mask_box[0]
        if new_arg is None or mask is None:
            return False
        x = new_arg
        m = mask
        neutral = np.asarray(0 if name == "add" else 1,
                             dtype=new_arg.type.dtype)
        filled = switch(m, new_arg, neutral)
    res = CAReduce(node.op.scalar_op, axis=None, dtype=node.op.dtype,
                   acc_dtype=node.op.acc_dtype,
                   upcast_discrete_output=node.op.upcast_discrete_output)(filled)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_reduce_of_bool_mask_to_where,
                    name="local_reduce_of_bool_mask_to_where")


@node_rewriter(None)
def local_shape_of_bool_mask(fgraph, node):
    """shape(x[mask]) without the gather: nnz(mask) = sum(mask), and the
    trailing dims are x's own.  Unlocks mean/var of masked values
    (sum(where)/nnz) and any size query on a masked result."""
    from pytensor_tpu_torch.tensor.basic import cast as t_cast
    from pytensor_tpu_torch.tensor.math import sum as t_sum
    from pytensor_tpu_torch.tensor.shape import Shape, Shape_i, shape as t_shape
    from pytensor_tpu_torch.tensor.subtensor import AdvancedSubtensor

    if not isinstance(node.op, (Shape, Shape_i)):
        return False
    arg = node.inputs[0]
    if arg.owner is None or not isinstance(arg.owner.op, AdvancedSubtensor):
        return False
    mask = _sole_bool_mask(arg.owner, 1)
    if mask is None:
        return False
    x = arg.owner.inputs[0]
    k = mask.type.ndim
    nnz = t_cast(t_sum(t_cast(mask, "int64")), "int64")
    if isinstance(node.op, Shape_i):
        if node.op.i == 0:
            res = nnz
        else:
            res = t_shape(x)[k + node.op.i - 1]
            res = t_cast(res, node.outputs[0].type.dtype) \
                if res.type.dtype != node.outputs[0].type.dtype else res
    else:
        from pytensor_tpu_torch.tensor.basic import MakeVector

        rest = [t_shape(x)[d] for d in range(k, x.type.ndim)]
        res = MakeVector(dtype="int64")(nnz, *rest)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_shape_of_bool_mask,
                      name="local_shape_of_bool_mask")
register_specialize(local_shape_of_bool_mask,
                    name="local_shape_of_bool_mask")


# ---------------------------------------------------------------------------
# write/read interaction family (reference rewriting/subtensor.py:1156
# local_set_to_inc_subtensor, :1898 local_incsubtensor_of_zeros, :1923
# local_incsubtensor_of_zeros_to_setsubtensor, :1945
# local_setsubtensor_of_constants, :1980 local_read_of_write_same_indices,
# :2330 local_write_of_write_same_indices).  Each write these remove is a
# scatter kernel and a full-size copy of its operand the card does not run.
# ---------------------------------------------------------------------------

def _underlying_const(v):
    """The scalar a variable is uniformly filled with (through
    Alloc/DimShuffle/uniform Constant arrays), or None."""
    from pytensor_tpu_torch.graph.basic import Constant
    from pytensor_tpu_torch.tensor.basic import get_underlying_scalar_constant_value

    if isinstance(v, Constant):
        data = np.asarray(v.data)
        if data.size == 0:
            return None
        flat = data.reshape(-1)
        return flat[0] if np.all(flat == flat[0]) else None
    return get_underlying_scalar_constant_value(v, raise_not_constant=False)


def _mixed_sign(data):
    """Positive and negative entries together may alias (0 and -dim name
    the same position), so value-distinctness stops proving
    position-distinctness (reference rewriting/subtensor.py:294)."""
    return bool((data >= 0).any() and (data < 0).any())


def _arange_provably_unique(start, stop, step, shift=0):
    """Whether ``arange(start, stop, step) + shift`` provably names each
    position at most once: its entries are distinct VALUES by
    construction, so the only aliasing channel is sign wraparound
    (reference ``_arange_provably_unique``)."""
    from pytensor_tpu_torch.assumptions import FactState, holds
    from pytensor_tpu_torch.graph.basic import Constant

    def const(v):
        if isinstance(v, (int, np.integer)):
            return int(v)
        if isinstance(v, Constant) and np.ndim(v.data) == 0:
            return int(v.data)
        return None

    cstart, cstop, cstep = const(start), const(stop), const(step)
    if cstart is not None and cstop is not None and cstep is not None:
        vals = np.arange(cstart, cstop, cstep) + shift
        return vals.size == 0 or not _mixed_sign(vals)

    def non_neg(v):
        c = const(v)
        if c is not None:
            return c >= 0
        if getattr(v.type, "dtype", "").startswith("uint"):
            return True
        return holds(v, "non_negative") == FactState.TRUE

    if cstep is None:
        return False
    if cstep > 0:
        # ascending: entries >= start + shift
        c = const(start)
        if c is not None:
            return c + shift >= 0
        return shift >= 0 and non_neg(start)
    # descending: entries > stop + shift (first entry is start + shift)
    c = const(stop)
    if c is not None:
        return c + shift >= -1
    if shift >= -1 and non_neg(stop):
        return True
    # or all-negative: entries <= start + shift < 0
    c = const(start)
    return c is not None and c + shift < 0


def _index_provably_unique(idx):
    """Whether a single advanced index selects each position on its axis
    at most once (reference rewriting/subtensor.py:243): constants with
    single-signed duplicate-free values, boolean masks (each position
    tested once), ``arange`` forms that provably don't wrap around zero
    (possibly shifted by a constant), axis-preserving views of such, and
    indices the user declared ``unique_indices`` via ``assume``."""
    from pytensor_tpu_torch.graph.basic import Constant
    from pytensor_tpu_torch.tensor.basic import ARange
    from pytensor_tpu_torch.tensor.elemwise import DimShuffle, Elemwise

    if getattr(idx.type, "ndim", 0) == 0:
        return True
    if idx.type.dtype == "bool":
        return True
    if isinstance(idx, Constant):
        data = np.asarray(idx.data)
        if _mixed_sign(data):
            return False
        return len(np.unique(data)) == data.size
    if "unique_indices" in getattr(idx.tag, "assumptions", ()):
        return True
    owner = idx.owner
    if owner is None:
        return False
    # constant shift of an arange: arange(...) +/- c
    if isinstance(owner.op, Elemwise) and \
            getattr(owner.op.scalar_op, "name", "") in ("add", "sub") and \
            len(owner.inputs) == 2:
        name = owner.op.scalar_op.name
        for a, b in (owner.inputs, owner.inputs[::-1]):
            if a.owner is not None and isinstance(a.owner.op, ARange):
                cshift = _underlying_const(b)
                if cshift is None or not float(cshift).is_integer():
                    continue
                cshift = int(cshift)
                if name == "sub":
                    if b is owner.inputs[1]:
                        cshift = -cshift
                    else:
                        continue  # c - arange reverses sign: skip
                return _arange_provably_unique(*a.owner.inputs, shift=cshift)
        return False
    if isinstance(owner.op, ARange):
        return _arange_provably_unique(*owner.inputs)
    if isinstance(owner.op, DimShuffle):
        # DimShuffle reorders, inserts size-1 dims, or drops size-1 dims:
        # all keep the value multiset
        return _index_provably_unique(owner.inputs[0])
    return False


def _indices_jointly_unique(node_or_ilist):
    """True when a write op's index coordinates are provably duplicate-free.

    Basic IncSubtensor indices (ints/slices) are always unique.  Advanced
    integer-array indices are unique when every index is duplicate-free on
    its own axis (then the broadcast joint tuples are distinct), when they
    are all the coordinate outputs of one ``Nonzero`` (distinct by
    construction, e.g. symbolic ``tril_indices``), or when they are all
    constants whose stacked coordinate tuples have no duplicates
    (reference rewriting/subtensor.py:303).  Symbolic slice bounds among
    ``inputs[2:]`` are 0-d and basic — never mistaken for advanced
    indices."""
    from pytensor_tpu_torch.graph.basic import Constant
    from pytensor_tpu_torch.tensor.basic import Nonzero

    node = node_or_ilist
    if isinstance(node.op, IncSubtensor):
        return True
    adv = [i for i in node.inputs[2:] if getattr(i.type, "ndim", 0) > 0]
    if all(_index_provably_unique(i) for i in adv):
        return True
    if len(adv) > 1:
        owners = {i.owner for i in adv}
        if len(owners) == 1:
            owner = next(iter(owners))
            if owner is not None and isinstance(owner.op, Nonzero) and \
                    set(adv) == set(owner.outputs):
                return True
        if all(isinstance(i, Constant) for i in adv):
            datas = [np.asarray(i.data) for i in adv]
            if any(_mixed_sign(d) for d in datas):
                return False
            try:
                coords = np.broadcast_arrays(*datas)
            except ValueError:
                return False
            flat = np.stack([c.reshape(-1) for c in coords], axis=-1)
            return len(np.unique(flat, axis=0)) == flat.shape[0]
    return False


def _matching_read_of(node, write_types):
    """When ``node`` reads exactly what an inner write op wrote (same base
    structural index, identical index variables), return the write node."""
    inner = node.inputs[0]
    if inner.owner is None or not isinstance(inner.owner.op, write_types):
        return None
    wnode = inner.owner
    if isinstance(node.op, (Subtensor, AdvancedSubtensor)):
        if getattr(node.op, "idx_list", None) != getattr(wnode.op, "idx_list", None):
            return None
        read_idx = node.inputs[1:]
        write_idx = wnode.inputs[2:]
    else:  # AdvancedSubtensor1 / AdvancedIncSubtensor1
        read_idx = node.inputs[1:]
        write_idx = wnode.inputs[2:]
    if len(read_idx) != len(write_idx):
        return None
    if not all(r is w for r, w in zip(read_idx, write_idx)):
        return None
    return wnode


@node_rewriter([IncSubtensor, AdvancedIncSubtensor, AdvancedIncSubtensor1])
def local_set_to_inc_subtensor(fgraph, node):
    """set_subtensor(x[idx], x[idx] + other) -> inc_subtensor(x[idx], other)
    (reference rewriting/subtensor.py:1156).  Valid only for provably
    duplicate-free indices: set is last-write-wins, inc accumulates."""
    from pytensor_tpu_torch.tensor.elemwise import Elemwise

    if not node.op.set_instead_of_inc:
        return False
    x, y = node.inputs[0], node.inputs[1]
    if y.owner is None or not isinstance(y.owner.op, Elemwise) \
            or getattr(y.owner.op.scalar_op, "name", "") != "add" \
            or len(y.owner.inputs) != 2:
        return False
    read_type = {IncSubtensor: Subtensor,
                 AdvancedIncSubtensor: AdvancedSubtensor,
                 AdvancedIncSubtensor1: AdvancedSubtensor1}[type(node.op)]
    for a, other in (y.owner.inputs, y.owner.inputs[::-1]):
        if a.owner is None or not isinstance(a.owner.op, read_type):
            continue
        rnode = a.owner
        if rnode.inputs[0] is not x:
            continue
        if isinstance(node.op, (IncSubtensor, AdvancedIncSubtensor)):
            if rnode.op.idx_list != node.op.idx_list:
                continue
        if len(rnode.inputs[1:]) != len(node.inputs[2:]) or \
                not all(r is w for r, w in
                        zip(rnode.inputs[1:], node.inputs[2:])):
            continue
        if not _indices_jointly_unique(node):
            return False
        if isinstance(node.op, AdvancedIncSubtensor1):
            new_op = AdvancedIncSubtensor1(set_instead_of_inc=False, ignore_duplicates=node.op.ignore_duplicates)
        elif isinstance(node.op, AdvancedIncSubtensor):
            new_op = AdvancedIncSubtensor(
                node.op.idx_list, set_instead_of_inc=False,
                ignore_duplicates=node.op.ignore_duplicates)
        else:
            new_op = IncSubtensor(node.op.idx_list, set_instead_of_inc=False)
        res = new_op(x, other, *node.inputs[2:])
        out = node.outputs[0]
        if not out.type.is_super(res.type):
            return False
        copy_stack_trace(out, res)
        return [res]
    return False


register_canonicalize(local_set_to_inc_subtensor,
                      name="local_set_to_inc_subtensor")


@node_rewriter([IncSubtensor, AdvancedIncSubtensor, AdvancedIncSubtensor1])
def local_incsubtensor_of_zeros(fgraph, node):
    """inc_subtensor(x[idx], 0) -> x (reference :1898)."""
    if node.op.set_instead_of_inc:
        return False
    y = node.inputs[1]
    c = _underlying_const(y)
    if c is None or c != 0:
        return False
    x = node.inputs[0]
    out = node.outputs[0]
    if not out.type.is_super(x.type):
        return False
    return [x]


register_canonicalize(local_incsubtensor_of_zeros,
                      name="local_incsubtensor_of_zeros")
register_specialize(local_incsubtensor_of_zeros,
                    name="local_incsubtensor_of_zeros")


@node_rewriter([IncSubtensor, AdvancedIncSubtensor, AdvancedIncSubtensor1])
def local_incsubtensor_of_zeros_to_setsubtensor(fgraph, node):
    """inc_subtensor(zeros[idx], y) -> set_subtensor(zeros[idx], y)
    (reference :1923) — a set scatter needs no read of the operand.
    Sound only for duplicate-free indices (inc at a repeated position
    accumulates; set keeps one)."""
    from pytensor_tpu_torch.assumptions import FactState, holds_in

    if node.op.set_instead_of_inc:
        return False
    x = node.inputs[0]
    if holds_in(fgraph, x, "zero") != FactState.TRUE:
        return False
    if not _indices_jointly_unique(node):
        return False
    if isinstance(node.op, AdvancedIncSubtensor1):
        new_op = AdvancedIncSubtensor1(set_instead_of_inc=True, ignore_duplicates=node.op.ignore_duplicates)
    elif isinstance(node.op, AdvancedIncSubtensor):
        new_op = AdvancedIncSubtensor(node.op.idx_list,
                                      set_instead_of_inc=True)
    else:
        new_op = IncSubtensor(node.op.idx_list, set_instead_of_inc=True)
    res = new_op(*node.inputs)
    copy_stack_trace(node.outputs[0], res)
    return [res]


register_canonicalize(local_incsubtensor_of_zeros_to_setsubtensor,
                      name="local_incsubtensor_of_zeros_to_setsubtensor")


from pytensor_tpu_torch.tensor.elemwise import Elemwise as _Elemwise


@node_rewriter([_Elemwise])
def local_add_of_sparse_write(fgraph, node):
    """``x + set/inc(zeros, v, idx) -> x[idx].inc(v)`` (reference
    rewriting/subtensor.py local_add_of_sparse_write): the dense zeros
    buffer + full-size add collapses into one scatter-add on ``x``: the
    gradient-accumulation pattern (sums of scatters into zeros) updates
    one buffer instead of materializing k full-size temporaries.

    inc-into-zeros folds unconditionally (inc applies the same
    per-position delta whether the base is zeros-then-added or ``x``
    itself, so duplicate indices accumulate identically).  set-into-zeros
    needs provably duplicate-free indices: a dense set is last-wins,
    while the folded inc would accumulate at repeated positions."""
    if getattr(node.op.scalar_op, "name", "") != "add":
        return False
    out = node.outputs[0]
    for k, w in enumerate(node.inputs):
        wnode = w.owner
        if wnode is None or not isinstance(
                wnode.op,
                (IncSubtensor, AdvancedIncSubtensor, AdvancedIncSubtensor1)):
            continue
        if len(fgraph.clients.get(w, ())) != 1:
            continue
        from pytensor_tpu_torch.assumptions import FactState, holds_in

        if holds_in(fgraph, wnode.inputs[0], "zero") != FactState.TRUE:
            continue
        if wnode.op.set_instead_of_inc and \
                not _indices_jointly_unique(wnode):
            continue
        from pytensor_tpu_torch.tensor.math import add as _add

        others = [i for j, i in enumerate(node.inputs) if j != k]
        x = others[0] if len(others) == 1 else _add(*others)
        if x.type.ndim != w.type.ndim:
            continue
        if isinstance(wnode.op, AdvancedIncSubtensor1):
            new_op = AdvancedIncSubtensor1(
                set_instead_of_inc=False,
                ignore_duplicates=wnode.op.ignore_duplicates)
        elif isinstance(wnode.op, AdvancedIncSubtensor):
            new_op = AdvancedIncSubtensor(wnode.op.idx_list,
                                          set_instead_of_inc=False)
        else:
            new_op = IncSubtensor(wnode.op.idx_list, set_instead_of_inc=False)
        try:
            res = new_op(x, *wnode.inputs[1:])
        except (TypeError, ValueError):
            continue
        if not out.type.is_super(res.type):
            continue
        copy_stack_trace(out, res)
        return [res]
    return False


register_specialize(local_add_of_sparse_write,
                    name="local_add_of_sparse_write")


@node_rewriter([IncSubtensor, AdvancedIncSubtensor, AdvancedIncSubtensor1])
def local_setsubtensor_of_constants(fgraph, node):
    """set_subtensor(fill(c)[idx], fill(c)) -> the operand unchanged
    (reference :1945): writing the value that is already there."""
    if not node.op.set_instead_of_inc:
        return False
    cx = _underlying_const(node.inputs[0])
    cy = _underlying_const(node.inputs[1])
    if cx is None or cy is None or cx != cy:
        return False
    x, out = node.inputs[0], node.outputs[0]
    if not out.type.is_super(x.type):
        return False
    return [x]


register_canonicalize(local_setsubtensor_of_constants,
                      name="local_setsubtensor_of_constants")


@node_rewriter([Subtensor, AdvancedSubtensor, AdvancedSubtensor1])
def local_read_of_write_same_indices(fgraph, node):
    """set_subtensor(x[idx], v)[idx] -> v;
    inc_subtensor(x[idx], v)[idx] -> x[idx] + v (reference :1980).
    Advanced integer-array indices must be constant and duplicate-free
    (duplicates make the read order-dependent)."""
    write_types = {Subtensor: IncSubtensor,
                   AdvancedSubtensor: AdvancedIncSubtensor,
                   AdvancedSubtensor1: AdvancedIncSubtensor1}[type(node.op)]
    wnode = _matching_read_of(node, write_types)
    if wnode is None:
        return False
    x, v = wnode.inputs[0], wnode.inputs[1]
    out = node.outputs[0]

    def read_of_x():
        if isinstance(node.op, AdvancedSubtensor1):
            return AdvancedSubtensor1()(x, *node.inputs[1:])
        return type(node.op)(node.op.idx_list)(x, *node.inputs[1:])

    if wnode.op.set_instead_of_inc:
        # the set path needs no uniqueness: duplicate writes are
        # last-wins, and the read returns the surviving values -- the
        # reference fires this unconditionally under shape_unsafe
        # (reference :2020)
        from pytensor_tpu_torch.tensor.basic import cast as _cast

        res = v
        if res.type.dtype != out.type.dtype:
            res = _cast(res, out.type.dtype)
        if res.type.ndim != out.type.ndim or any(
                res.type.shape[d] == 1 and out.type.shape[d] != 1
                for d in range(out.type.ndim)):
            # v is a broadcast-smaller update (fewer dims, or size-1 dims
            # the region may exceed): fill it to the read's shape
            # (elemwise; no reference back to the replaced out)
            from pytensor_tpu_torch.tensor.math import second

            res = second(read_of_x(), res)
        elif not out.type.is_super(res.type):
            # same shape, weaker statics: recover them without a read
            from pytensor_tpu_torch.tensor.shape import specify_shape

            res = specify_shape(res, out.type.shape)
        if not out.type.is_super(res.type):
            return False
    else:
        # inc reads back base + delta, which is order-independent only
        # for duplicate-free indices
        if not _indices_jointly_unique(wnode):
            return False
        res = read_of_x() + v
        if not out.type.is_super(res.type):
            return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_read_of_write_same_indices, "shape_unsafe",
                      name="local_read_of_write_same_indices")
register_specialize(local_read_of_write_same_indices, "shape_unsafe",
                    name="local_read_of_write_same_indices")


@node_rewriter([IncSubtensor, AdvancedIncSubtensor, AdvancedIncSubtensor1])
def local_write_of_write_same_indices(fgraph, node):
    """Collapse nested writes at identical indices (reference :2330):
    outer set shadows the inner write; inc+inc accumulates; inc-of-set
    merges when indices are duplicate-free."""
    inner_x, b = node.inputs[0], node.inputs[1]
    if inner_x.owner is None or type(inner_x.owner.op) is not type(node.op):
        return False
    wnode = inner_x.owner
    if isinstance(node.op, (IncSubtensor, AdvancedIncSubtensor)):
        if wnode.op.idx_list != node.op.idx_list:
            return False
    if len(wnode.inputs[2:]) != len(node.inputs[2:]) or \
            not all(r is w for r, w in zip(wnode.inputs[2:], node.inputs[2:])):
        return False
    if len(fgraph.clients.get(inner_x, ())) != 1:
        return False
    base, a = wnode.inputs[0], wnode.inputs[1]
    outer_set = node.op.set_instead_of_inc
    inner_set = wnode.op.set_instead_of_inc
    if outer_set:
        new_val, use_set = b, True
    elif inner_set:
        if not _indices_jointly_unique(node):
            return False
        new_val, use_set = a + b, True
    else:
        new_val, use_set = a + b, False
    if isinstance(node.op, AdvancedIncSubtensor1):
        new_op = AdvancedIncSubtensor1(set_instead_of_inc=use_set, ignore_duplicates=node.op.ignore_duplicates)
    elif isinstance(node.op, AdvancedIncSubtensor):
        new_op = AdvancedIncSubtensor(node.op.idx_list,
                                      set_instead_of_inc=use_set)
    else:
        new_op = IncSubtensor(node.op.idx_list, set_instead_of_inc=use_set)
    res = new_op(base, new_val, *node.inputs[2:])
    out = node.outputs[0]
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_canonicalize(local_write_of_write_same_indices,
                      name="local_write_of_write_same_indices")


# ---------------------------------------------------------------------------
# index canonicalization / gather-to-slice family (reference
# rewriting/subtensor.py:516 local_useless_slice, :1048
# local_subtensor_remove_broadcastable_index, :1376
# local_convert_negative_indices, :1460 local_adv_idx_to_diagonal, :1577
# local_adv_idx_to_slice, :2507 local_join_subtensors).  The
# gather->slice rules are speed rules, not just cleanups: a gather is a
# kernel that reads an index a row, a slice is a view.
# ---------------------------------------------------------------------------

def _is_shape_of_dim(var, x, d, fgraph=None):
    """Whether ``var`` is symbolically ``x.shape[d]`` (the reference's
    local_useless_slice does the same bound-vs-shape match at :516):
    either a direct ``Shape_i`` of ``x``, or — through the fgraph's
    ShapeFeature — structurally equal to x's symbolic dim-d entry (so
    ``exp(x)[:x.shape[0]]`` still matches after the slice is lifted onto
    ``exp``'s output)."""
    from pytensor_tpu_torch.tensor.shape import Shape_i

    owner = getattr(var, "owner", None)
    if (owner is not None and isinstance(owner.op, Shape_i)
            and owner.op.i == d and owner.inputs[0] is x):
        return True
    if fgraph is None:
        return False
    sf = getattr(fgraph, "shape_feature", None)
    if sf is None:
        from pytensor_tpu_torch.tensor.rewriting.shape import ShapeFeature

        sf = ShapeFeature()
        fgraph.attach_feature(sf)
    entry = sf.get_shape(x, d)
    if entry is None or isinstance(entry, int):
        return False
    return sf._entry_eq(entry, var)


def local_useless_slice_parts(fgraph, node):
    """Canonicalize slice parts: start=0 -> None, step=1 -> None,
    stop >= static dim -> None, symbolic stop == x.shape[d] -> None
    (reference :516).  Exposes merges and the full-slice removals to the
    other rules."""
    x = node.inputs[0]
    changed = False
    new_idx = []
    dyn_it = iter(node.inputs[1:])
    d = 0
    for e in node.op.idx_list:
        if isinstance(e, tuple) and e and e[0] == "slice":
            _, a, b, c = e
            a = next(dyn_it) if a == DYN else a
            b = next(dyn_it) if b == DYN else b
            c = next(dyn_it) if c == DYN else c
            fwd = c is None or (isinstance(c, int) and c > 0)
            bwd = isinstance(c, int) and c < 0
            dim = x.type.shape[d] if d < x.type.ndim else None
            if a == 0 and fwd:
                # start=0 is only the default for FORWARD steps; with a
                # negative step it selects the single element 0
                a, changed = None, True
            if c == 1:
                c, changed = None, True
            if isinstance(b, int) and dim is not None and b >= dim and fwd:
                b, changed = None, True
            if fwd and b is not None and not isinstance(b, int) \
                    and _is_shape_of_dim(b, x, d, fgraph):
                # x[a:x.shape[d]] covers through the end of the axis
                b, changed = None, True
            if bwd:
                # backward defaults: start=-1 (or dim-1), stop=-dim-1
                if a == -1 or (isinstance(a, int) and dim is not None
                               and a == dim - 1):
                    a, changed = None, True
                if isinstance(b, int) and dim is not None and b == -dim - 1:
                    b, changed = None, True
            new_idx.append(("slice", a, b, c))
            d += 1
        elif e == DYN:
            new_idx.append(next(dyn_it))
            d += 1
        else:
            new_idx.append(e)
            d += 1
    while new_idx and _full_slice(new_idx[-1]):
        # a trailing full slice is a no-op placeholder
        new_idx.pop()
        changed = True
    if not changed:
        return False
    out = node.outputs[0]
    if not new_idx:
        res = node.inputs[0]
    else:
        from pytensor_tpu_torch.graph.basic import Variable

        idx_out, dyns = [], []
        for e in new_idx:
            if isinstance(e, tuple) and e and e[0] == "slice":
                parts = []
                for p in e[1:]:
                    if isinstance(p, Variable):
                        dyns.append(p)
                        parts.append(DYN)
                    else:
                        parts.append(p)
                idx_out.append(("slice", *parts))
            elif isinstance(e, Variable):
                dyns.append(e)
                idx_out.append(DYN)
            else:
                idx_out.append(e)
        res = Subtensor(tuple(idx_out))(x, *dyns)
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


local_useless_slice_parts = node_rewriter([Subtensor])(
    local_useless_slice_parts)
register_canonicalize(local_useless_slice_parts,
                      name="local_useless_slice_parts")
register_specialize(local_useless_slice_parts,
                    name="local_useless_slice_parts")


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


def _constant_arange_step1(v):
    """(start, n) when v is a constant 1-d int array equal to
    arange(start, start+n); else None."""
    m = _constant_arange(v)
    if m is None or m[2] != 1:
        return None
    start, n, _ = m
    return start, n


def _constant_arange(v):
    """(start, n, step) when v is a constant 1-d non-negative int array
    equal to arange(start, start + n*step, step) for some step != 0;
    else None (reference _constant_is_arange:354)."""
    from pytensor_tpu_torch.graph.basic import Constant

    if not isinstance(v, Constant):
        return None
    data = np.asarray(v.data)
    if data.ndim != 1 or data.size == 0 or data.dtype.kind not in "iu":
        return None
    start = int(data[0])
    if int(data.min()) < 0:
        return None  # negative entries wrap; a forward slice can't
    if data.size == 1:
        return start, 1, 1
    step = int(data[1]) - start
    if step == 0:
        return None
    if not np.array_equal(data, np.arange(start, start + data.size * step,
                                          step)):
        return None
    return start, int(data.size), step


@node_rewriter([AdvancedSubtensor1, AdvancedSubtensor])
def local_adv_idx_to_slice(fgraph, node):
    """x[arange(a, b)] -> x[a:b] (reference :1577): the gather becomes a
    strided slice.  Constant indices only, so bounds are checked here and
    the slice is exact (not shape_unsafe)."""
    x = node.inputs[0]
    if isinstance(node.op, AdvancedSubtensor1):
        indices = [node.inputs[1]]
        positions = [0]
    else:
        it = iter(node.inputs[1:])
        indices, positions = [], []
        d = 0
        for e in node.op.idx_list:
            if e == DYN:
                v = next(it)
                if v.type.ndim != 1 or v.type.dtype == "bool":
                    return False
                indices.append(v)
                positions.append(d)
            elif isinstance(e, (int, np.integer)):
                return False
            elif not _full_slice(e):
                return False
            d += 1
        if len(indices) != 1:
            return False
    m = _constant_arange(indices[0])
    if m is None:
        return False
    start, n, step = m
    axis = positions[0]
    dim = x.type.shape[axis] if axis < x.type.ndim else None
    if dim is None:
        return False  # cannot prove in-bounds -> slice would silently clip
    last = start + (n - 1) * step
    if max(start, last) >= dim:
        return False  # the gather would be out of bounds: keep its error
    if step > 0:
        sl = ("slice", start or None, last + 1, step if step != 1 else None)
    else:
        # descending: a non-negative stop would cut short; a would-be
        # negative stop must be None so the slice doesn't wrap
        stop = last + step
        sl = ("slice", start, stop if stop >= 0 else None, step)
    idx_list = [("slice", None, None, None)] * axis + [sl]
    res = Subtensor(idx_list)(x)
    out = node.outputs[0]
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_adv_idx_to_slice, name="local_adv_idx_to_slice")


@node_rewriter([AdvancedSubtensor])
def local_adv_idx_to_diagonal(fgraph, node):
    """x[arange(d), arange(d)+k] on consecutive axes -> diagonal(x, k)
    (reference :1460): the paired gather is a strided diagonal read.
    Constant full-coverage aranges only."""
    from pytensor_tpu_torch.tensor.basic import diagonal

    x = node.inputs[0]
    it = iter(node.inputs[1:])
    indices, positions = [], []
    d = 0
    for e in node.op.idx_list:
        if e == DYN:
            v = next(it)
            if v.type.ndim != 1 or v.type.dtype == "bool":
                return False
            indices.append(v)
            positions.append(d)
        elif isinstance(e, (int, np.integer)):
            return False
        elif not _full_slice(e):
            return False
        d += 1
    if len(indices) != 2 or positions[1] != positions[0] + 1:
        return False
    a1, a2 = positions
    m1 = _constant_arange_step1(indices[0])
    m2 = _constant_arange_step1(indices[1])
    if m1 is None or m2 is None or m1[1] != m2[1]:
        return False
    (r_off, n), (c_off, _) = m1, m2
    if r_off != 0 and c_off != 0:
        return False
    dim_a = x.type.shape[a1] if a1 < x.type.ndim else None
    dim_b = x.type.shape[a2] if a2 < x.type.ndim else None
    if dim_a is None or dim_b is None:
        return False
    if n != min(dim_a - r_off, dim_b - c_off):
        return False  # partial diagonal: diagonal() can't express it
    res = diagonal(x, offset=c_off - r_off, axis1=a1, axis2=a2)
    # diagonal() puts the diagonal last; numpy keeps consecutive advanced
    # axes in place
    if a1 != res.type.ndim - 1:
        from pytensor_tpu_torch.tensor.basic import moveaxis

        res = moveaxis(res, -1, a1)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_adv_idx_to_diagonal,
                    name="local_adv_idx_to_diagonal")


@node_rewriter(None)
def local_join_subtensors(fgraph, node):
    """join(axis, x[..., a:b], x[..., b:c]) -> x[..., a:c]
    (reference :2507): adjacent reads of the same base concatenate to one
    strided window — removes a copy and a concat kernel."""
    from pytensor_tpu_torch.tensor.basic import Join

    if not isinstance(node.op, Join):
        return False
    axis_in, *parts = node.inputs
    if len(parts) != 2:
        return False
    try:
        from pytensor_tpu_torch.tensor.basic import get_scalar_constant_value

        axis = int(get_scalar_constant_value(axis_in))
    except Exception:
        return False
    p0, p1 = parts
    if p0.owner is None or p1.owner is None:
        return False
    if not isinstance(p0.owner.op, Subtensor) or \
            not isinstance(p1.owner.op, Subtensor):
        return False
    if p0.owner.inputs[0] is not p1.owner.inputs[0]:
        return False
    x = p0.owner.inputs[0]
    if axis < 0:
        axis += x.type.ndim

    def static_bounds(snode):
        """(start, stop) ints of the slice at `axis` when every other
        entry is a full slice and all parts are static; else None."""
        res = None
        d = 0
        for e in snode.op.idx_list:
            if isinstance(e, tuple) and e and e[0] == "slice":
                _, a, b, c = e
                if d == axis:
                    if c not in (None, 1) or a == DYN or b == DYN:
                        return None
                    if (a is not None and a < 0) or \
                            (b is not None and b < 0):
                        return None
                    res = (a or 0, b)
                elif not _full_slice(e):
                    return None
                d += 1
            else:
                return None
        if d <= axis:
            return None
        return res

    b0 = static_bounds(p0.owner)
    b1 = static_bounds(p1.owner)
    if b0 is None or b1 is None:
        return None
    dim = x.type.shape[axis]
    (s0, e0), (s1, e1) = b0, b1
    # adjacency: first slice's stop == second slice's start.  Python
    # clamping composes consistently ([a,b) ++ [b,c) == [a,c) within
    # bounds), but a reversed slice (stop < start) would not — require
    # non-decreasing bounds.
    if e0 is None:
        if dim is None or s1 != dim:
            return None
    elif s1 != e0 or s0 > e0:
        return None
    if e1 is not None and e1 < s1:
        return None
    if (s0 or 0) == 0 and e1 is None:
        res = x
    else:
        idx_list = [("slice", None, None, None)] * axis + \
            [("slice", s0 or None, e1, None)]
        res = Subtensor(idx_list)(x)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return None
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_join_subtensors, name="local_join_subtensors")


# ---------------------------------------------------------------------------
# round-4 long tail: diag-of-dot fold, constant read-of-write lookup,
# alloc-increment elision, subtensor through Blockwise batch dims
# (reference rewriting/subtensor.py:2127,2417; subtensor_lift.py:438,983)
# ---------------------------------------------------------------------------

@node_rewriter(None)
def local_extract_diag_of_dot(fgraph, node):
    """diagonal(A @ B, k) -> (A' * B'.mT).sum(-1) (reference
    subtensor_lift.py:983 lowers ExtractDiag to a paired-arange gather
    feeding local_advanced_subtensor_of_dot; here the fold is direct).

    This removes the full O(n^3) product: only the n^2 products on the
    diagonal survive, as one elemwise product and a reduction.  Fires for
    Dot and Blockwise(Dot) when the diagonal is over the two core dims
    and the sliced extents are static.
    """
    from pytensor_tpu_torch.tensor.basic import ExtractDiag
    from pytensor_tpu_torch.tensor.blockwise import Blockwise
    from pytensor_tpu_torch.tensor.math import Dot

    if not isinstance(node.op, ExtractDiag):
        return False
    x = node.inputs[0]
    if x.owner is None:
        return False
    inner_op = x.owner.op
    if isinstance(inner_op, Dot):
        batch = 0
    elif isinstance(inner_op, Blockwise) and \
            isinstance(inner_op.core_op, Dot):
        batch = x.type.ndim - 2
    else:
        return False
    if x.type.ndim < 2:
        return False
    a1, a2 = node.op.axis1 % x.type.ndim, node.op.axis2 % x.type.ndim
    k = node.op.offset
    A, B = x.owner.inputs
    if A.type.ndim < 2 or B.type.ndim < 2:
        return False  # matrix-vector dot has no 2-d diagonal
    if {a1, a2} != {x.type.ndim - 2, x.type.ndim - 1}:
        return False
    if a1 > a2:
        # diagonal(M, k, 1, 0) == diagonal(M.T, k); (A@B).T == B.T@A.T
        A, B = B.mT if hasattr(B, "mT") else B.T, \
            A.mT if hasattr(A, "mT") else A.T
    m = A.type.shape[-2]
    n = B.type.shape[-1]
    if m is None or n is None:
        return False
    d = min(m + min(0, k), n - max(0, k))
    if d <= 0:
        return False  # empty diagonal: leave to shape machinery
    from pytensor_tpu_torch.tensor.math import sum as t_sum

    if k >= 0:
        As = A[..., :d, :]
        Bs = B[..., :, k:k + d]
    else:
        As = A[..., -k:-k + d, :]
        Bs = B[..., :, :d]
    Bt = Bs.mT if hasattr(Bs, "mT") else Bs.T
    res = t_sum(As * Bt, axis=-1)
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    if batch and out.type.ndim != res.type.ndim:
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_extract_diag_of_dot,
                    name="local_extract_diag_of_dot")


def _const_1d_int_index(v):
    """The numpy int array behind a constant 1-d integer/bool index, or
    None."""
    from pytensor_tpu_torch.graph.basic import Constant

    if not isinstance(v, Constant):
        return None
    data = np.asarray(v.data)
    if data.ndim != 1:
        return None
    if data.dtype == np.bool_:
        return np.flatnonzero(data)
    if data.dtype.kind not in "iu":
        return None
    return data.astype(np.int64)


@node_rewriter([AdvancedSubtensor1, Subtensor])
def local_advanced_read_of_write_constant_indices(fgraph, node):
    """x[w_idx].set/inc(v)[r_idx] with CONSTANT index vectors -> a
    host-computed lookup (reference rewriting/subtensor.py:2127,
    single-advanced-axis case).

    set: full coverage -> v[lookup]; none -> x[r_idx]; partial -> mix.
    inc: requires duplicate-free writes; full -> x[r_idx] + v[lookup].
    Kills both the scatter and the gather when the graph writes then
    reads disjoint or aligned constant index sets.  Also matches an
    axis-0 constant-slice read (what ``local_adv_idx_to_slice`` turns a
    constant arange read into).
    """
    from pytensor_tpu_torch.tensor.basic import alloc, as_tensor_variable, cast

    inner = node.inputs[0]
    if inner.owner is None or \
            not isinstance(inner.owner.op, AdvancedIncSubtensor1):
        return False
    if isinstance(node.op, Subtensor):
        # a single constant axis-0 slice over a statically-sized write
        idx_list = node.op.idx_list
        dim = inner.type.shape[0] if inner.type.ndim else None
        if (len(node.inputs) != 1 or dim is None or len(idx_list) != 1
                or not (isinstance(idx_list[0], tuple)
                        and idx_list[0][0] == "slice")):
            return False
        _, a, b, c = idx_list[0]
        if any(x is not None and not isinstance(x, int) for x in (a, b, c)):
            return False
        r_arr = np.arange(dim, dtype=np.int64)[slice(a, b, c)]
    else:
        r_arr = _const_1d_int_index(node.inputs[1])
    if r_arr is None or (r_arr < 0).any():
        return False
    base, v = inner.owner.inputs[0], inner.owner.inputs[1]
    w_arr = _const_1d_int_index(inner.owner.inputs[2])
    if w_arr is None or (w_arr < 0).any():
        return False
    is_set = inner.owner.op.set_instead_of_inc
    n_write = len(w_arr)
    write_dict = {}
    for kk in range(n_write):
        coord = int(w_arr[kk])
        if not is_set and coord in write_dict:
            return False  # inc with duplicate writes: keep the scatter
        write_dict[coord] = kk
    lookup = np.array([write_dict.get(int(rc), -1) for rc in r_arr],
                      dtype=np.int64)
    covered = lookup >= 0
    out = node.outputs[0]
    read_idx = as_tensor_variable(r_arr)

    # bring v to its natural (n_write, *base.shape[1:]) shape so the
    # advanced axis can be indexed directly
    def natural_v():
        vv = v
        tail = [base.shape[i] for i in range(1, base.type.ndim)]
        vv = alloc(vv, as_tensor_variable(np.int64(n_write)), *tail)
        if vv.type.dtype != out.type.dtype:
            vv = cast(vv, out.type.dtype)
        return vv

    if is_set:
        if covered.all():
            res = natural_v()[as_tensor_variable(lookup)]
        elif not covered.any():
            res = base[read_idx]
        else:
            base_part = base[read_idx]
            sub = natural_v()[as_tensor_variable(lookup[covered])]
            res = AdvancedIncSubtensor1(set_instead_of_inc=True)(
                base_part, sub,
                as_tensor_variable(np.flatnonzero(covered)))
    else:
        base_part = base[read_idx]
        if not covered.any():
            res = base_part
        elif covered.all():
            res = base_part + natural_v()[as_tensor_variable(lookup)]
        else:
            sub = natural_v()[as_tensor_variable(lookup[covered])]
            res = AdvancedIncSubtensor1(set_instead_of_inc=False)(
                base_part, sub,
                as_tensor_variable(np.flatnonzero(covered)))
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_advanced_read_of_write_constant_indices,
                    name="local_advanced_read_of_write_constant_indices")


@node_rewriter([IncSubtensor, AdvancedIncSubtensor, AdvancedIncSubtensor1])
def local_useless_inc_subtensor_alloc(fgraph, node):
    """inc/set_subtensor(x[idx], alloc(z, ...)) -> drop the alloc when
    the static shapes prove z broadcasts to x[idx] (reference
    rewriting/subtensor.py:2417; the reference adds runtime Asserts for
    unprovable dims — here the rewrite simply declines, keeping it
    shape-safe by construction)."""
    from pytensor_tpu_torch.tensor.basic import Alloc

    x, y = node.inputs[0], node.inputs[1]
    if y.owner is None or not isinstance(y.owner.op, Alloc):
        return False
    z = y.owner.inputs[0]
    # the written block x[idx]
    if isinstance(node.op, IncSubtensor):
        xi = Subtensor(node.op.idx_list)(x, *node.inputs[2:])
    elif isinstance(node.op, AdvancedIncSubtensor1):
        xi = AdvancedSubtensor1()(x, node.inputs[2])
    else:
        xi = AdvancedSubtensor(node.op.idx_list)(x, *node.inputs[2:])
    if z.type.ndim > xi.type.ndim:
        return False
    # prove every y-dim is either 1 (inc_subtensor broadcasts it) or
    # statically equal to the block's dim
    offset = xi.type.ndim - y.type.ndim
    for kk in range(y.type.ndim):
        ys = y.type.shape[kk]
        xs = xi.type.shape[kk + offset]
        if ys == 1:
            continue
        if ys is None or xs is None or ys != xs:
            return False
    # and z itself must broadcast into y's shape (alloc guarantees the
    # values; we only need shape-compatibility for the replacement)
    zoff = y.type.ndim - z.type.ndim
    for kk in range(z.type.ndim):
        zs = z.type.shape[kk]
        ys = y.type.shape[kk + zoff]
        if zs == 1 or zs == ys:
            continue
        return False
    res = node.op(x, z, *node.inputs[2:])
    out = node.outputs[0]
    if not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_useless_inc_subtensor_alloc,
                    name="local_useless_inc_subtensor_alloc")


@node_rewriter([Subtensor])
def local_subtensor_of_batch_dims(fgraph, node):
    """blockwise(a, b, ...)[batch_idx] -> blockwise(a[idx'], b[idx'])
    (reference subtensor_lift.py:438): indexing only batch dims commutes
    with the blockwise, so compute on the smaller block."""
    from pytensor_tpu_torch.tensor.blockwise import Blockwise

    x = node.inputs[0]
    if x.owner is None or not isinstance(x.owner.op, Blockwise):
        return False
    if len(fgraph.clients.get(x, ())) != 1:
        return False
    op = x.owner.op
    out_core = len(op.outputs_sig[0])
    if len(x.owner.outputs) != 1:
        return False
    batch_ndim = x.type.ndim - out_core
    idx_list = node.op.idx_list
    if len(idx_list) > batch_ndim:
        return False
    pairs = _split_dyn(idx_list, node.inputs[1:])
    in_core = [len(s) for s in op.inputs_sig]
    new_inputs = []
    for i, core in zip(x.owner.inputs, in_core):
        ib = i.type.ndim - core
        offset = batch_ndim - ib
        entries, dyns = [], []
        ok = True
        for kk, (e, ed) in enumerate(pairs):
            if kk < offset:
                continue  # input broadcasts over this leading batch dim
            d = kk - offset
            if i.type.shape[d] == 1 and x.type.shape[kk] != 1:
                if isinstance(e, tuple) and e[0] == "slice":
                    entries.append(FULL)
                else:
                    entries.append(0)
                continue
            if i.type.shape[d] is not None and \
                    x.type.shape[kk] is not None and \
                    i.type.shape[d] == x.type.shape[kk]:
                entries.append(e)
                dyns.extend(ed)
                continue
            if e == FULL:
                entries.append(e)
                continue
            ok = False
            break
        if not ok:
            return False
        while entries and entries[-1] == FULL:
            entries.pop()
        new_inputs.append(
            Subtensor(entries)(i, *dyns) if entries else i)
    res = x.owner.op(*new_inputs)
    if isinstance(res, (list, tuple)):
        res = res[0]
    out = node.outputs[0]
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_subtensor_of_batch_dims,
                    name="local_subtensor_of_batch_dims")

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


def _is_shape_of_dim(var, x, d, fgraph=None):
    """Whether ``var`` is ``x.shape[d]``: a direct ``Shape_i`` of ``x``.
    The JAX package also matches x's symbolic dim-d entry through the
    fgraph's ShapeFeature, which the port has not yet (ROADMAP.md Queue 1
    item 6)."""
    from pytensor_tpu_torch.tensor.shape import Shape_i

    owner = getattr(var, "owner", None)
    if (owner is not None and isinstance(owner.op, Shape_i)
            and owner.op.i == d and owner.inputs[0] is x):
        return True
    return False


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

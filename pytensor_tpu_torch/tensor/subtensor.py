"""Indexing ops: Subtensor, IncSubtensor, advanced variants.

Counterpart of ``pytensor_tpu/tensor/subtensor.py`` (PyTensor's
tensor/subtensor.py Subtensor:868, IncSubtensor:1441,
AdvancedSubtensor:1932, AdvancedIncSubtensor:2275, take, take_along_axis,
flip).  ``idx_list`` holds
the static structure of the index expression (ints/slices with None or
the dynamic marker); dynamic scalar/array values are extra node inputs in
order of appearance.  The torch lowerings are in ``link/torch/dispatch.py``.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable
from pytensor_tpu_torch.graph.null_type import DisconnectedType
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.tensor.basic import as_tensor_variable, cast, zeros_like
from pytensor_tpu_torch.tensor.type import TensorType

# dynamic-entry marker inside idx_list
DYN = "dyn"


class AdvancedIndexingError(TypeError):
    pass


def _norm_int(v):
    """Classify an index component: returns ('static', int) |
    ('dyn', Variable) for scalar ints."""
    if v is None:
        return ("none", None)
    if isinstance(v, (int, np.integer)):
        return ("static", int(v))
    if isinstance(v, Constant) and v.type.ndim == 0 and v.type.dtype.startswith(("int", "uint")):
        return ("static", int(v.data))
    if isinstance(v, Variable):
        if v.type.ndim != 0:
            raise TypeError("slice components must be scalars")
        return ("dyn", cast(v, "int64") if v.type.dtype != "int64" else v)
    raise TypeError(f"invalid index component {v!r}")


class Subtensor(Op):
    """Basic indexing: ints and slices (static structure in idx_list)."""

    __props__ = ("idx_list",)
    view_map = {0: [0]}

    def __init__(self, idx_list):
        # entries: int | DYN | (slice-tuple: ('slice', start, stop, step))
        # where each bound is None | int | DYN
        self.idx_list = tuple(idx_list)

    def make_node(self, x, *dyn_inputs):
        x = as_tensor_variable(x)
        dyn_inputs = [as_tensor_variable(d) for d in dyn_inputs]
        n_dyn = _count_dyn(self.idx_list)
        if len(dyn_inputs) != n_dyn:
            raise ValueError(f"Subtensor expected {n_dyn} dynamic inputs")
        # static integer indices check against known axis lengths at
        # graph-build time (numpy/reference semantics)
        for axis, entry in enumerate(self.idx_list):
            if isinstance(entry, (int, np.integer)) and \
                    axis < len(x.type.shape):
                dim = x.type.shape[axis]
                if dim is not None and not (-dim <= int(entry) < dim):
                    raise IndexError(
                        f"index {int(entry)} is out of bounds for axis "
                        f"{axis} with size {dim}")
        out_shape = _static_out_shape(self.idx_list, x.type.shape, dyn_inputs)
        out = TensorType(x.type.dtype, out_shape)()
        return Apply(self, [x, *dyn_inputs], [out])

    def perform(self, node, inputs, output_storage):
        x, *dyn = inputs
        idx = _build_index(self.idx_list, dyn)
        output_storage[0][0] = np.asarray(x[idx])

    def infer_shape(self, fgraph, node, input_shapes):
        from pytensor_tpu_torch.tensor import math as tm
        from pytensor_tpu_torch.tensor.basic import constant

        xshp = input_shapes[0]
        dyn = list(node.inputs[1:])
        out = []
        it = iter(dyn)
        d = 0
        for entry in self.idx_list:
            if entry == DYN:
                next(it)
                d += 1
                continue
            if isinstance(entry, (int, np.integer)):
                d += 1
                continue
            # slice entry
            _, start, stop, step = entry
            sv = next(it) if start == DYN else start
            ov = next(it) if stop == DYN else stop
            ev = next(it) if step == DYN else step
            length = _sym_slice_len(sv, ov, ev, xshp[d])
            out.append(length)
            d += 1
        # remaining dims pass through
        for dd in range(d, len(xshp)):
            out.append(xshp[dd])
        return [tuple(out)]

    def connection_pattern(self, node):
        return [[True]] + [[False] for _ in node.inputs[1:]]

    def L_op(self, inputs, outputs, output_grads):
        x, *dyn = inputs
        (gz,) = output_grads
        g = IncSubtensor(self.idx_list, set_instead_of_inc=False)(
            zeros_like(x), gz, *dyn
        )
        return [g] + [DisconnectedType()() for _ in dyn]

    def __str__(self):
        return f"Subtensor{{{_idx_str(self.idx_list)}}}"


def _static_out_shape(idx_list, xshape, dyn_inputs):
    """Static output shape of a basic-index expression."""
    out = []
    d = 0
    for e in idx_list:
        if e == DYN or isinstance(e, (int, np.integer)):
            d += 1  # integer index drops the dim
            continue
        _, a, b, c = e
        out.append(_static_slice_len(a, b, c, xshape[d]))
        d += 1
    out.extend(xshape[d:])
    return tuple(out)


def _count_dyn(idx_list) -> int:
    n = 0
    for e in idx_list:
        if e == DYN:
            n += 1
        elif isinstance(e, tuple) and e and e[0] == "slice":
            n += sum(1 for b in e[1:] if b == DYN)
    return n


def _build_index(idx_list, dyn):
    it = iter(dyn)
    idx = []
    for e in idx_list:
        if e == DYN:
            idx.append(int(next(it)))
        elif isinstance(e, (int, np.integer)):
            idx.append(int(e))
        else:
            _, start, stop, step = e
            s = int(next(it)) if start == DYN else start
            o = int(next(it)) if stop == DYN else stop
            p = int(next(it)) if step == DYN else step
            idx.append(slice(s, o, p))
    return tuple(idx)


def _broadcast_index_shapes(shapes):
    """None-aware broadcast of advanced-index static shapes.

    None broadcasts optimistically against known dims (PyTensor's rule
    assumes the runtime value will match); two distinct known non-1 dims
    are a definite error (PyTensor's raises IndexError at build time).
    """
    shapes = [tuple(s) for s in shapes]
    nd = max((len(s) for s in shapes), default=0)
    out = []
    for i in range(nd):
        dims = [s[len(s) - nd + i] if len(s) - nd + i >= 0 else 1
                for s in shapes]
        non1 = {dm for dm in dims if dm is not None and dm != 1}
        if len(non1) > 1:
            raise IndexError(
                "shape mismatch: indexing tensors could not be broadcast "
                f"together with shapes {[s for s in shapes]}")
        if non1:
            out.append(next(iter(non1)))
        elif any(dm is None for dm in dims):
            out.append(None)
        else:
            out.append(1)
    return tuple(out)


def _static_slice_len(start, stop, step, dim):
    """Static length of a slice over a (possibly unknown) dim."""
    if start == DYN or stop == DYN or step == DYN:
        return None
    if dim is None:
        # numpy CLIPS slice bounds to the axis length, so with the dim
        # unknown even fully static bounds give no static length
        # (x[:5] of a 3-row input has 3 rows; claiming 5 poisons every
        # downstream consumer of the static type)
        return None
    return len(range(*slice(start, stop, step).indices(dim)))


def _sym_slice_len(start, stop, step, dim_var):
    """Symbolic length of a slice (ints or scalar Variables)."""
    from pytensor_tpu_torch.tensor import math as tm
    from pytensor_tpu_torch.tensor.basic import constant, as_tensor_variable

    def val(v, default):
        if v is None:
            return None
        return v

    step_v = 1 if step is None else step
    if isinstance(step_v, Variable) or isinstance(start, Variable) or isinstance(stop, Variable) \
            or isinstance(dim_var, Variable) or True:
        n = as_tensor_variable(dim_var) if not isinstance(dim_var, Variable) else dim_var
        st = as_tensor_variable(step_v if not isinstance(step_v, Variable) else step_v)
        # normalize start/stop with numpy slice semantics
        def norm(v, default_pos, default_neg):
            if v is None:
                return tm.switch(tm.ge(st, 0), default_pos, default_neg)
            v = as_tensor_variable(v)
            vneg = v + n
            v = tm.switch(tm.lt(v, 0), vneg, v)
            return tm.clip(v, tm.switch(tm.ge(st, 0), 0, -1),
                           tm.switch(tm.ge(st, 0), n, n - 1))

        zero = as_tensor_variable(np.int64(0))
        a = norm(start, zero, n - 1)
        b = norm(stop, n, zero - 1)
        diff = b - a
        q = tm.switch(
            tm.ge(st, 0),
            (diff + st - 1) // st,
            (diff + st + 1) // st,
        )
        return tm.maximum(tm.cast(q, "int64"), zero)


class IncSubtensor(Op):
    """x with x[idx] set to / incremented by y (functional update).

    The torch lowering clones ``x`` and writes the region in place.
    """

    __props__ = ("idx_list", "set_instead_of_inc")

    def __init__(self, idx_list, set_instead_of_inc=False, inplace=False):
        self.idx_list = tuple(idx_list)
        self.set_instead_of_inc = bool(set_instead_of_inc)

    def make_node(self, x, y, *dyn_inputs):
        x = as_tensor_variable(x)
        y = as_tensor_variable(y)
        dyn_inputs = [as_tensor_variable(d) for d in dyn_inputs]
        if y.type.dtype != x.type.dtype:
            y = cast(y, x.type.dtype)
        out = TensorType(x.type.dtype, x.type.shape)()
        return Apply(self, [x, y, *dyn_inputs], [out])

    def perform(self, node, inputs, output_storage):
        x, y, *dyn = inputs
        idx = _build_index(self.idx_list, dyn)
        out = np.array(x, copy=True)
        if self.set_instead_of_inc:
            out[idx] = y
        else:
            out[idx] += y
        output_storage[0][0] = out

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def connection_pattern(self, node):
        return [[True], [True]] + [[False] for _ in node.inputs[2:]]

    def L_op(self, inputs, outputs, output_grads):
        x, y, *dyn = inputs
        (gz,) = output_grads
        if self.set_instead_of_inc:
            gx = IncSubtensor(self.idx_list, set_instead_of_inc=True)(
                gz, zeros_like(y), *dyn
            )
        else:
            gx = gz
        gy = Subtensor(self.idx_list)(gz, *dyn)
        gy = _sum_extra_dims(gy, y)
        return [gx, gy] + [DisconnectedType()() for _ in dyn]

    def __str__(self):
        verb = "Set" if self.set_instead_of_inc else "Inc"
        return f"{verb}Subtensor{{{_idx_str(self.idx_list)}}}"


def _sum_extra_dims(g, y):
    """Reduce a sliced gradient down to y's shape (y may have broadcast)."""
    from pytensor_tpu_torch.tensor.elemwise import _sum_grad_over_bcasted_dims

    return _sum_grad_over_bcasted_dims(y, g)


def _idx_str(idx_list):
    parts = []
    for e in idx_list:
        if e == DYN:
            parts.append("int64")
        elif isinstance(e, (int, np.integer)):
            parts.append(str(e))
        else:
            _, a, b, c = e
            f = lambda v: "" if v is None else ("?" if v == DYN else str(v))
            parts.append(f"{f(a)}:{f(b)}" + (f":{f(c)}" if c is not None else ""))
    return ", ".join(parts)


class AdvancedSubtensor1(Op):
    """x[ivec] along axis 0 (gather)."""

    __props__ = ()

    def make_node(self, x, ilist):
        x = as_tensor_variable(x)
        ilist = as_tensor_variable(ilist)
        if ilist.type.ndim != 1:
            raise TypeError("AdvancedSubtensor1 index must be a vector")
        if not ilist.type.dtype.startswith(("int", "uint")):
            raise TypeError("index must be integer typed")
        from pytensor_tpu_torch.graph.basic import Constant as _Const

        dim = x.type.shape[0]
        if dim is not None and isinstance(ilist, _Const):
            # a CONSTANT index against a static dim is checkable at graph
            # build (numpy raises; so does the torch lowering)
            iv = np.asarray(ilist.data)
            if iv.size and (iv.min() < -dim or iv.max() >= dim):
                raise IndexError(
                    f"index {int(iv.min()) if iv.min() < -dim else int(iv.max())} "
                    f"out of bounds for axis 0 with size {dim}")
        out_shape = (ilist.type.shape[0], *x.type.shape[1:])
        return Apply(self, [x, ilist], [TensorType(x.type.dtype, out_shape)()])

    def perform(self, node, inputs, output_storage):
        x, i = inputs
        output_storage[0][0] = x.take(i, axis=0)

    def infer_shape(self, fgraph, node, input_shapes):
        xshp, ishp = input_shapes
        return [(ishp[0], *xshp[1:])]

    def connection_pattern(self, node):
        return [[True], [False]]

    def L_op(self, inputs, outputs, output_grads):
        x, ilist = inputs
        (gz,) = output_grads
        gx = AdvancedIncSubtensor1(set_instead_of_inc=False)(zeros_like(x), gz, ilist)
        return [gx, DisconnectedType()()]


advanced_subtensor1 = AdvancedSubtensor1()


class AdvancedIncSubtensor1(Op):
    """x with x[ivec] set/incremented along axis 0 (scatter).

    ``ignore_duplicates=True`` uses numpy's buffered ``x[i] += y`` (one
    write wins per duplicate index) instead of ``np.add.at`` accumulation
    (PyTensor's AdvancedIncSubtensor ignore_duplicates).
    """

    __props__ = ("set_instead_of_inc", "ignore_duplicates")

    def __init__(self, inplace=False, set_instead_of_inc=False,
                 ignore_duplicates=False):
        self.set_instead_of_inc = bool(set_instead_of_inc)
        self.ignore_duplicates = bool(ignore_duplicates)

    def make_node(self, x, y, ilist):
        x = as_tensor_variable(x)
        y = as_tensor_variable(y)
        ilist = as_tensor_variable(ilist)
        if y.type.dtype != x.type.dtype:
            y = cast(y, x.type.dtype)
        out = TensorType(x.type.dtype, x.type.shape)()
        return Apply(self, [x, y, ilist], [out])

    @staticmethod
    def _check_runtime_broadcast(node, y_shape, expected_shape):
        """A dim of y may only stretch if its STATIC shape is 1 (the
        Elemwise no-runtime-broadcast contract)."""
        y_static = node.inputs[1].type.shape
        off = len(expected_shape) - len(y_shape)
        if off < 0:
            return
        for d, (ys, es) in enumerate(zip(y_shape, expected_shape[off:])):
            if ys == 1 and es not in (1, None) and y_static[d] != 1:
                raise ValueError(
                    "Runtime broadcasting not allowed. "
                    f"AdvancedIncSubtensor1 value has runtime shape "
                    f"{tuple(y_shape)}, target region {tuple(expected_shape)}. "
                    "If broadcasting was intended, use "
                    "`specify_broadcastable` on the value."
                )

    def perform(self, node, inputs, output_storage):
        x, y, i = inputs
        self._check_runtime_broadcast(
            node, np.shape(y), (len(np.atleast_1d(i)),) + x.shape[1:])
        out = np.array(x, copy=True)
        if self.set_instead_of_inc:
            out[i] = y
        elif self.ignore_duplicates:
            out[i] += y
        else:
            np.add.at(out, i, y)
        output_storage[0][0] = out

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def connection_pattern(self, node):
        return [[True], [True], [False]]

    def L_op(self, inputs, outputs, output_grads):
        x, y, ilist = inputs
        (gz,) = output_grads
        if self.set_instead_of_inc:
            gx = AdvancedIncSubtensor1(set_instead_of_inc=True)(
                gz, zeros_like(y), ilist
            )
        else:
            gx = gz
        gy = advanced_subtensor1(gz, ilist)
        gy = _sum_extra_dims(gy, y)
        return [gx, gy, DisconnectedType()()]


class AdvancedSubtensor(Op):
    """Full numpy advanced indexing (integer arrays mixed with slices).

    The static index structure lives in ``idx_list`` with DYN markers for
    tensor indices (passed as node inputs).
    """

    __props__ = ("idx_list",)

    def __init__(self, idx_list):
        self.idx_list = tuple(idx_list)

    def make_node(self, x, *indices):
        x = as_tensor_variable(x)
        indices = [as_tensor_variable(i) for i in indices]
        out_shape = self._static_shape(x, indices)
        return Apply(self, [x, *indices], [TensorType(x.type.dtype, out_shape)()])

    @staticmethod
    def _bool_mask_shape(x, indices):
        """Static shape for the sole-boolean-mask form x[mask]:
        (nnz, *x.shape[mask.ndim:]) — nnz is the True count for constant
        masks, else unknown — validating known dims."""
        if len(indices) != 1 or indices[0].type.dtype != "bool":
            return None
        mask = indices[0]
        k = mask.type.ndim
        if k < 1 or k > x.type.ndim:
            raise IndexError(
                f"boolean mask of rank {k} cannot index a rank-"
                f"{x.type.ndim} tensor")
        for d in range(k):
            md, xd = mask.type.shape[d], x.type.shape[d]
            if md is not None and xd is not None and md != xd:
                raise IndexError(
                    f"boolean index did not match indexed tensor along "
                    f"axis {d}; dimension is {xd} but mask dimension is {md}")
        cnt = int(mask.data.sum()) if isinstance(mask, Constant) else None
        return (cnt,) + tuple(x.type.shape[k:])

    def _static_shape(self, x, indices):
        """Numpy advanced-indexing shape rules on static (None-aware)
        shapes: advanced indices (arrays, bools, plain ints) broadcast
        together; the broadcast block lands in place when the advanced
        entries are adjacent, else at the front (PyTensor's
        indexed_result_shape, tensor/subtensor.py)."""
        bool_shape = self._bool_mask_shape(x, indices)
        if bool_shape is not None:
            return bool_shape
        it = iter(indices)
        xshape = tuple(x.type.shape)
        d = 0                 # dims of x consumed so far
        adv_shapes = []       # static shapes of advanced indices
        entry_kinds = []      # 'adv' | 'keep' per idx_list entry
        out_entries = []      # kept (non-advanced) output dims, in order
        adv_slot = None       # output-slot index of the first adv entry
        for e in self.idx_list:
            if e == "none":
                entry_kinds.append("keep")
                out_entries.append(1)
            elif isinstance(e, (int, np.integer)):
                # scalar ints participate in the advanced group (shape ())
                entry_kinds.append("adv")
                adv_shapes.append(())
                if adv_slot is None:
                    adv_slot = len(out_entries)
                d += 1
            elif e == DYN:
                iv = next(it)
                entry_kinds.append("adv")
                if adv_slot is None:
                    adv_slot = len(out_entries)
                if iv.type.dtype == "bool":
                    k = iv.type.ndim
                    if d + k > x.type.ndim:
                        raise IndexError(
                            f"too many indices for tensor: tensor is "
                            f"{x.type.ndim}-dimensional, but {d + k} were "
                            f"indexed")
                    for j in range(k):
                        md, xd = iv.type.shape[j], xshape[d + j]
                        if md is not None and xd is not None and md != xd:
                            raise IndexError(
                                f"boolean index did not match indexed tensor "
                                f"along axis {d + j}; dimension is {xd} but "
                                f"mask dimension is {md}")
                    cnt = (int(iv.data.sum())
                           if isinstance(iv, Constant) else None)
                    adv_shapes.append((cnt,))
                    d += k
                else:
                    adv_shapes.append(tuple(iv.type.shape))
                    d += 1
            else:
                _, a, b, c = e
                parts, any_dyn = [], False
                for p in (a, b, c):
                    if p == DYN:
                        next(it)  # the 0-d bound input; length unknown
                        any_dyn = True
                        parts.append(None)
                    else:
                        parts.append(p)
                entry_kinds.append("keep")
                if d >= x.type.ndim:
                    raise IndexError(
                        f"too many indices for tensor: tensor is "
                        f"{x.type.ndim}-dimensional, but {d + 1} were indexed")
                out_entries.append(
                    None if any_dyn
                    else _static_slice_len(*parts, xshape[d]))
                d += 1
        if d > x.type.ndim:
            raise IndexError(
                f"too many indices for tensor: tensor is {x.type.ndim}-"
                f"dimensional, but {d} were indexed")
        trailing = list(xshape[d:])
        bshape = _broadcast_index_shapes(adv_shapes)
        # adjacency: all 'adv' entries consecutive in the entry sequence
        adv_positions = [i for i, k in enumerate(entry_kinds) if k == "adv"]
        adjacent = adv_positions == list(
            range(adv_positions[0], adv_positions[0] + len(adv_positions))
        ) if adv_positions else True
        if not adv_positions:
            return tuple(out_entries) + tuple(trailing)
        if adjacent:
            out = out_entries[:adv_slot] + list(bshape) + out_entries[adv_slot:]
        else:
            out = list(bshape) + out_entries
        return tuple(out) + tuple(trailing)

    def perform(self, node, inputs, output_storage):
        x, *ind = inputs
        idx = self._runtime_index(ind)
        output_storage[0][0] = np.asarray(x[idx])

    def _runtime_index(self, ind):
        it = iter(ind)
        idx = []
        for e in self.idx_list:
            if e == DYN:
                idx.append(np.asarray(next(it)))
            elif isinstance(e, (int, np.integer)):
                idx.append(int(e))
            elif e == "none":
                idx.append(None)
            else:
                _, a, b, c = e
                a = int(np.asarray(next(it))) if a == DYN else a
                b = int(np.asarray(next(it))) if b == DYN else b
                c = int(np.asarray(next(it))) if c == DYN else c
                idx.append(slice(a, b, c))
        return tuple(idx)

    def connection_pattern(self, node):
        return [[True]] + [[False] for _ in node.inputs[1:]]

    def L_op(self, inputs, outputs, output_grads):
        x, *ind = inputs
        (gz,) = output_grads
        gx = AdvancedIncSubtensor(self.idx_list, set_instead_of_inc=False)(
            zeros_like(x), gz, *ind
        )
        return [gx] + [DisconnectedType()() for _ in ind]

    def __str__(self):
        return "AdvancedSubtensor"


class AdvancedIncSubtensor(Op):
    __props__ = ("idx_list", "set_instead_of_inc", "ignore_duplicates")

    def __init__(self, idx_list, set_instead_of_inc=False, inplace=False,
                 ignore_duplicates=False):
        self.idx_list = tuple(idx_list)
        self.set_instead_of_inc = bool(set_instead_of_inc)
        self.ignore_duplicates = bool(ignore_duplicates)

    def make_node(self, x, y, *indices):
        x = as_tensor_variable(x)
        y = as_tensor_variable(y)
        if y.type.dtype != x.type.dtype:
            y = cast(y, x.type.dtype)
        indices = [as_tensor_variable(i) for i in indices]
        out = TensorType(x.type.dtype, x.type.shape)()
        return Apply(self, [x, y, *indices], [out])

    def _strip_newaxes(self, idx, y):
        """Drop None entries from the index and squeeze the matching
        inserted axes out of y (np.add.at / .at[] reject None)."""
        if not any(e is None for e in idx):
            return idx, y
        squeeze_axes = []
        pos = 0
        for e in idx:
            if e is None:
                squeeze_axes.append(pos)
                pos += 1
            elif isinstance(e, slice):
                pos += 1
            elif isinstance(e, (int, np.integer)):
                pass
            else:  # advanced array: contributes dims at the front in the
                # mixed case; conservative: keep position count
                pos += np.ndim(e)
        y2 = y
        for ax in reversed(squeeze_axes):
            if np.ndim(y2) > 0 and np.shape(y2)[ax] == 1:
                y2 = np.squeeze(y2, axis=ax) if isinstance(y2, np.ndarray) \
                    else y2.squeeze(ax)
        idx2 = tuple(e for e in idx if e is not None)
        return idx2, y2

    def perform(self, node, inputs, output_storage):
        x, y, *ind = inputs
        helper = AdvancedSubtensor(self.idx_list)
        idx = helper._runtime_index(ind)
        idx, y = self._strip_newaxes(idx, y)
        out = np.array(x, copy=True)
        if self.set_instead_of_inc or self.ignore_duplicates:
            if self.set_instead_of_inc:
                out[idx] = y
            else:
                out[idx] += y
        else:
            # np.add.at handles duplicate indices correctly
            np.add.at(out, idx, y)
        output_storage[0][0] = out

    def infer_shape(self, fgraph, node, input_shapes):
        return [input_shapes[0]]

    def connection_pattern(self, node):
        return [[True], [True]] + [[False] for _ in node.inputs[2:]]

    def L_op(self, inputs, outputs, output_grads):
        x, y, *ind = inputs
        (gz,) = output_grads
        if self.set_instead_of_inc:
            gx = AdvancedIncSubtensor(self.idx_list, set_instead_of_inc=True)(
                gz, zeros_like(y), *ind
            )
        else:
            gx = gz
        gy = AdvancedSubtensor(self.idx_list)(gz, *ind)
        gy = _sum_extra_dims(gy, y)
        return [gx, gy] + [DisconnectedType()() for _ in ind]

    def __str__(self):
        verb = "Set" if self.set_instead_of_inc else "Inc"
        return f"Advanced{verb}Subtensor"


# ---------------------------------------------------------------------------
# __getitem__ front end
# ---------------------------------------------------------------------------

def _parse_args(x, args):
    """Normalize index args; expand Ellipsis; classify basic vs advanced."""
    if not isinstance(args, tuple):
        args = (args,)
    # expand Ellipsis
    n_specified = sum(1 for a in args if a is not None and a is not Ellipsis)
    new_args = []
    for a in args:
        if a is Ellipsis:
            new_args.extend([slice(None)] * (x.type.ndim - n_specified))
        else:
            new_args.append(a)
    args = new_args
    has_advanced = False
    for a in args:
        if isinstance(a, (list, np.ndarray)):
            has_advanced = True
        elif isinstance(a, Variable) and getattr(a.type, "ndim", 0) >= 1:
            has_advanced = True
        elif isinstance(a, Variable) and getattr(a.type, "dtype", "") == "bool":
            has_advanced = True
    return args, has_advanced


def _resolve_static_bool_masks(x, args):
    """Boolean masks known at graph-construction time (numpy arrays, bool
    lists, or boolean Constants) convert to integer index arrays;
    data-dependent masks stay symbolic: their output shape depends on the
    data.

    Mask shapes are validated against the indexed axes (numpy semantics:
    a wrong-length mask is an IndexError, not a silent subset)."""
    from pytensor_tpu_torch.graph.basic import Constant

    if not isinstance(args, tuple):
        args = (args,)

    def as_mask(a):
        """Return the graph-time-constant bool mask for this index, or None."""
        if isinstance(a, (bool, np.bool_)):
            raise NotImplementedError(
                "scalar boolean indexing (x[True]/x[False]) adds a new axis "
                "whose length is data-independent but numpy-special; use "
                "x[None] or x[0:0] explicitly."
            )
        if isinstance(a, list):
            try:
                arr = np.asarray(a)
            except (ValueError, TypeError):
                return None
            if arr.dtype == np.bool_:
                return arr
            return None
        if isinstance(a, np.ndarray) and a.dtype == np.bool_:
            if a.ndim == 0:
                raise NotImplementedError(
                    "scalar boolean indexing is not supported; use x[None]."
                )
            return a
        if isinstance(a, Constant) and getattr(a.type, "dtype", "") == "bool":
            return np.asarray(a.data)
        if isinstance(a, Variable) and getattr(a.type, "dtype", "") == "bool" \
                and getattr(a.type, "ndim", 0) >= 1:
            # symbolic mask: kept as a graph-level index (its output
            # shape depends on the data); the torch lowering rejects it
            return None
        return None

    masks = [as_mask(a) for a in args]
    if not any(m is not None for m in masks):
        return args

    # axes consumed per arg: newaxis 0, a k-d mask k, everything else 1
    def n_axes(i, a):
        if a is None or a is Ellipsis:
            return 0
        if masks[i] is not None:
            return masks[i].ndim
        return 1

    consumed = sum(n_axes(i, a) for i, a in enumerate(args))
    x_shape = getattr(x.type, "shape", (None,) * getattr(x.type, "ndim", 0))

    out = []
    axis = 0
    for i, a in enumerate(args):
        if a is Ellipsis:
            axis += x.type.ndim - consumed
            out.append(a)
            continue
        if a is None:
            out.append(a)
            continue
        m = masks[i]
        if m is None:
            out.append(a)
            axis += 1
            continue
        for d in range(m.ndim):
            dim = x_shape[axis + d] if axis + d < len(x_shape) else None
            if dim is not None and m.shape[d] != dim:
                raise IndexError(
                    f"boolean index did not match indexed tensor along "
                    f"axis {axis + d}; dimension is {dim} but mask "
                    f"dimension is {m.shape[d]}"
                )
        axis += m.ndim
        if m.ndim == 1:
            out.append(np.nonzero(m)[0])
        else:
            # multi-dim masks expand to their nonzero coordinate arrays
            out.extend(np.nonzero(m))
    return tuple(out)


def _getitem(x, args):
    args = _resolve_static_bool_masks(x, args)
    args, has_advanced = _parse_args(x, args)
    if len([a for a in args if a is not None]) > x.type.ndim:
        raise IndexError(f"too many indices for {x.type}")

    if not has_advanced:
        # pure basic indexing; newaxis (None) entries become a DimShuffle
        # afterwards (a view, and shape inference stays exact)
        newaxes = any(a is None for a in args)
        idx_list = []
        dyn = []
        for a in args:
            if a is None:
                continue
            if isinstance(a, slice):
                entry = ["slice"]
                for part in (a.start, a.stop, a.step):
                    kind, v = _norm_int(part)
                    if kind == "none":
                        entry.append(None)
                    elif kind == "static":
                        entry.append(v)
                    else:
                        entry.append(DYN)
                        dyn.append(v)
                idx_list.append(tuple(entry))
            else:
                kind, v = _norm_int(a)
                if kind == "static":
                    idx_list.append(v)
                elif kind == "dyn":
                    idx_list.append(DYN)
                    dyn.append(v)
                else:
                    raise TypeError("None in basic path?")
        if not idx_list or all(
            isinstance(e, tuple) and e == ("slice", None, None, None) for e in idx_list
        ):
            res = x
        else:
            res = Subtensor(idx_list)(x, *dyn)
        if newaxes:
            from pytensor_tpu_torch.tensor.elemwise import DimShuffle

            order = []
            res_dim = 0
            for a in args:
                if a is None:
                    order.append("x")
                elif isinstance(a, slice):
                    order.append(res_dim)
                    res_dim += 1
                # int index: dimension dropped
            order.extend(range(res_dim, res.type.ndim))
            res = DimShuffle(res.type.ndim, order)(res)
        return res

    # advanced path (may include None/newaxis and bool masks)
    idx_list = []
    tensors = []
    only_onevec = None
    n_adv = 0
    for a in args:
        if a is None:
            idx_list.append("none")
        elif isinstance(a, slice):
            entry = ["slice"]
            for part in (a.start, a.stop, a.step):
                kind, v = _norm_int(part)
                if kind == "none":
                    entry.append(None)
                elif kind == "static":
                    entry.append(v)
                else:
                    # dynamic bound: a 0-d tensor input, consumed from the
                    # same input stream as the advanced arrays in idx_list
                    # traversal order (start, stop, step within an entry)
                    entry.append(DYN)
                    tensors.append(v)
            idx_list.append(tuple(entry))
        elif isinstance(a, (list, np.ndarray)) or (
            isinstance(a, Variable) and getattr(a.type, "ndim", 0) >= 0
        ):
            av = as_tensor_variable(a)
            if av.type.dtype == "bool" and av.type.ndim == 0:
                raise NotImplementedError(
                    "scalar boolean indexing is not supported; use x[None].")
            # symbolic boolean masks (sole or mixed with other indices)
            # build graph-legal AdvancedSubtensor nodes with dynamic
            # (nnz, ...) output; the torch lowering rejects them
            idx_list.append(DYN)
            tensors.append(av)
            n_adv += 1
        elif isinstance(a, (int, np.integer)):
            idx_list.append(int(a))
        else:
            raise TypeError(f"cannot index with {a!r}")
    if n_adv == 1 and len(tensors) == 1 and tensors[0].type.ndim == 1 and all(
        (e == DYN or (isinstance(e, tuple) and e == ("slice", None, None, None)))
        for e in idx_list
    ) and idx_list[0] == DYN and "none" not in idx_list \
            and tensors[0].type.dtype != "bool":
        return advanced_subtensor1(x, tensors[0])
    return AdvancedSubtensor(idx_list)(x, *tensors)


def set_subtensor(dest, src, inplace=False):
    """Return dest's base tensor with the indexed region set to src."""
    return _inc_or_set(dest, src, set_instead_of_inc=True)


def advanced_inc_subtensor1(x, y, ilist, ignore_duplicates=False):
    """x with x[ilist] += y (PyTensor's advanced_inc_subtensor1)."""
    return AdvancedIncSubtensor1(ignore_duplicates=ignore_duplicates)(
        x, y, ilist)


def advanced_set_subtensor1(x, y, ilist):
    """x with x[ilist] = y (PyTensor's advanced_set_subtensor1)."""
    return AdvancedIncSubtensor1(set_instead_of_inc=True)(x, y, ilist)


def inc_subtensor(dest, src, inplace=False, set_instead_of_inc=False,
                  ignore_duplicates=False):
    return _inc_or_set(dest, src, set_instead_of_inc=set_instead_of_inc,
                       ignore_duplicates=ignore_duplicates)


def _full_buffer_write(dest, src, set_instead_of_inc):
    """x[:] / x[:, :] short-circuit to x at graph-build time, so a write
    to the full buffer arrives with no indexing node.  PyTensor
    builds the useless Subtensor and rewrites it away
    (rewriting/subtensor.py local_useless_inc_subtensor); here the
    collapsed form is built directly: set -> broadcast(src, shape),
    inc -> dest + src."""
    from pytensor_tpu_torch.tensor.math import second

    src_v = as_tensor_variable(src)
    if src_v.type.ndim > dest.type.ndim:
        raise TypeError(
            f"increment has {src_v.type.ndim} dims, more than the "
            f"destination's {dest.type.ndim}")
    if set_instead_of_inc:
        return second(dest, src_v)
    return dest + second(dest, src_v)


def _inc_or_set(dest, src, set_instead_of_inc, ignore_duplicates=False):
    if dest.owner is None:
        return _full_buffer_write(dest, src, set_instead_of_inc)
    op = dest.owner.op
    src_v = as_tensor_variable(src)
    if src_v.type.ndim > dest.type.ndim:
        # the increment can broadcast up but never carry MORE dims than
        # the indexed view (PyTensor's IncSubtensor TypeError)
        raise TypeError(
            f"increment has {src_v.type.ndim} dims, more than the indexed "
            f"view's {dest.type.ndim}")
    if isinstance(op, Subtensor):
        x, *dyn = dest.owner.inputs
        return IncSubtensor(op.idx_list, set_instead_of_inc=set_instead_of_inc)(
            x, src, *dyn
        )
    if isinstance(op, AdvancedSubtensor1):
        x, ilist = dest.owner.inputs
        return AdvancedIncSubtensor1(
            set_instead_of_inc=set_instead_of_inc,
            ignore_duplicates=ignore_duplicates,
        )(x, src, ilist)
    if isinstance(op, AdvancedSubtensor):
        x, *ind = dest.owner.inputs
        return AdvancedIncSubtensor(
            op.idx_list, set_instead_of_inc=set_instead_of_inc,
            ignore_duplicates=ignore_duplicates,
        )(x, src, *ind)
    from pytensor_tpu_torch.tensor.elemwise import DimShuffle

    if isinstance(op, DimShuffle) and op.is_transpose:
        # allow set_subtensor(x.T[...], v) patterns via inverse transpose
        inner = _inc_or_set(dest.owner.inputs[0], src, set_instead_of_inc)
        return inner
    # any other producer: the dest IS the full buffer (x[:, :] built it
    # with no indexing node)
    return _full_buffer_write(dest, src, set_instead_of_inc)


def take(x, indices, axis=None, mode="raise"):
    x = as_tensor_variable(x)
    indices = as_tensor_variable(indices)
    from pytensor_tpu_torch.tensor.shape import flatten, reshape, shape

    if mode not in ("raise", "clip", "wrap"):
        raise ValueError(f"invalid take mode: {mode!r}")
    if mode != "raise":
        from pytensor_tpu_torch.tensor import math as tm

        n = (x.size if axis is None
             else shape(x)[axis % x.type.ndim])
        indices = (tm.clip(indices, 0, n - 1) if mode == "clip"
                   else tm.mod(indices, n))
    if axis is None:
        xf = flatten(x)
        if indices.type.ndim == 1:
            return advanced_subtensor1(xf, indices)
        idx_flat = flatten(indices)
        res = advanced_subtensor1(xf, idx_flat)
        return reshape(res, [shape(indices)[i] for i in range(indices.type.ndim)],
                       ndim=indices.type.ndim)
    axis = axis % x.type.ndim
    if axis == 0 and indices.type.ndim == 1:
        return advanced_subtensor1(x, indices)
    full = [slice(None)] * axis + [indices]
    return x.__getitem__(tuple(full))


def take_along_axis(arr, indices, axis=-1):
    arr = as_tensor_variable(arr)
    indices = as_tensor_variable(indices)
    if not indices.type.dtype.startswith(("int", "uint")):
        raise IndexError(
            f"take_along_axis indices must be integers, got "
            f"{indices.type.dtype}")
    if arr.type.ndim != indices.type.ndim:
        raise ValueError("ndim mismatch in take_along_axis")
    axis = axis % arr.type.ndim
    # build open-mesh advanced index
    from pytensor_tpu_torch.tensor.basic import arange, shape_padright, shape_padleft
    from pytensor_tpu_torch.tensor.shape import shape

    idxs = []
    for d in range(arr.type.ndim):
        if d == axis:
            idxs.append(indices)
        else:
            # prefer the static dim: a symbolic Shape_i would erase the
            # arange's static length and poison downstream shape inference
            static = arr.type.shape[d]
            r = arange(static if static is not None else shape(arr)[d])
            pat = ["x"] * arr.type.ndim
            pat[d] = 0
            from pytensor_tpu_torch.tensor.elemwise import DimShuffle

            idxs.append(DimShuffle(1, pat)(r))
    return AdvancedSubtensor([DYN] * arr.type.ndim)(arr, *idxs)


def flip(x, axis=None):
    x = as_tensor_variable(x)
    if axis is None:
        axis = list(range(x.type.ndim))
    elif isinstance(axis, (int, np.integer)):
        axis = [axis]
    idx = []
    for d in range(x.type.ndim):
        if d in [a % x.type.ndim for a in axis]:
            idx.append(("slice", None, None, -1))
        else:
            idx.append(("slice", None, None, None))
    return Subtensor(idx)(x)

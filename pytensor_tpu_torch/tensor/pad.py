"""pad, in every mode of ``numpy.pad`` the JAX package takes.

Counterpart of ``pytensor_tpu/tensor/pad.py`` (PyTensor's tensor/pad.py
Pad:365): a graph constructor over concatenate, alloc and slices, so its
gradient comes from theirs and it needs no lowering of its own.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.tensor.basic import alloc, as_tensor_variable, concatenate, zeros
from pytensor_tpu_torch.tensor.shape import shape
from pytensor_tpu_torch.tensor.subtensor import flip


def _norm_pad_width(pad_width, ndim):
    if isinstance(pad_width, (int, np.integer)):
        return [(int(pad_width), int(pad_width))] * ndim
    pad_width = list(pad_width)
    if len(pad_width) == 2 and all(isinstance(p, (int, np.integer)) for p in pad_width):
        return [tuple(int(p) for p in pad_width)] * ndim
    return [tuple(int(x) for x in p) for p in pad_width]


def pad(x, pad_width, mode="constant", constant_values=0, **kwargs):
    x = as_tensor_variable(x)
    pw = _norm_pad_width(pad_width, x.type.ndim)
    out = x
    for axis, (lo, hi) in enumerate(pw):
        if lo == 0 and hi == 0:
            continue
        shp = [shape(out)[i] for i in range(out.type.ndim)]
        if mode == "constant":
            cv = as_tensor_variable(constant_values)
            parts = []
            if lo:
                lo_shape = list(shp)
                lo_shape[axis] = lo
                parts.append(alloc(cv.astype(out.type.dtype), *lo_shape))
            parts.append(out)
            if hi:
                hi_shape = list(shp)
                hi_shape[axis] = hi
                parts.append(alloc(cv.astype(out.type.dtype), *hi_shape))
            out = concatenate(parts, axis=axis)
        elif mode in ("reflect", "symmetric"):
            off = 0 if mode == "symmetric" else 1
            idx_lo = [slice(None)] * out.type.ndim
            idx_lo[axis] = slice(off, lo + off)
            idx_hi = [slice(None)] * out.type.ndim
            idx_hi[axis] = slice(-(hi + off), -off if off else None)
            parts = []
            if lo:
                parts.append(flip(out[tuple(idx_lo)], axis))
            parts.append(out)
            if hi:
                parts.append(flip(out[tuple(idx_hi)], axis))
            out = concatenate(parts, axis=axis)
        elif mode == "edge":
            parts = []
            idx_first = [slice(None)] * out.type.ndim
            idx_first[axis] = slice(0, 1)
            idx_last = [slice(None)] * out.type.ndim
            idx_last[axis] = slice(-1, None)
            from pytensor_tpu_torch.tensor.basic import tile

            if lo:
                reps = [1] * out.type.ndim
                reps[axis] = lo
                parts.append(tile(out[tuple(idx_first)], tuple(reps)))
            parts.append(out)
            if hi:
                reps = [1] * out.type.ndim
                reps[axis] = hi
                parts.append(tile(out[tuple(idx_last)], tuple(reps)))
            out = concatenate(parts, axis=axis)
        elif mode == "wrap":
            idx_lo = [slice(None)] * out.type.ndim
            idx_lo[axis] = slice(-lo, None)
            idx_hi = [slice(None)] * out.type.ndim
            idx_hi[axis] = slice(0, hi)
            parts = []
            if lo:
                parts.append(out[tuple(idx_lo)])
            parts.append(out)
            if hi:
                parts.append(out[tuple(idx_hi)])
            out = concatenate(parts, axis=axis)
        elif mode in ("maximum", "minimum", "mean"):
            from pytensor_tpu_torch.tensor import math as tm
            from pytensor_tpu_torch.tensor.basic import cast

            stat_length = kwargs.get("stat_length")
            if stat_length is None:
                sl_lo = sl_hi = None
            else:
                sls = _norm_pad_width(stat_length, x.type.ndim)
                sl_lo, sl_hi = sls[axis]
            fn = {"maximum": tm.max, "minimum": tm.min, "mean": tm.mean}[mode]

            def _stat(region_slice):
                idx = [slice(None)] * out.type.ndim
                idx[axis] = region_slice
                st = fn(out[tuple(idx)], axis=axis, keepdims=True)
                if st.type.dtype != out.type.dtype:
                    if out.type.dtype.startswith(("int", "uint")):
                        st = tm.round(st)  # numpy rounds integer means
                    st = cast(st, out.type.dtype)
                return st

            lo_stat = _stat(slice(None) if sl_lo is None else slice(0, sl_lo))
            hi_stat = _stat(slice(None) if sl_hi is None else slice(-sl_hi, None))
            parts = []
            if lo:
                lo_shape = list(shp)
                lo_shape[axis] = lo
                parts.append(alloc(lo_stat, *lo_shape))
            parts.append(out)
            if hi:
                hi_shape = list(shp)
                hi_shape[axis] = hi
                parts.append(alloc(hi_stat, *hi_shape))
            out = concatenate(parts, axis=axis)
        elif mode == "linear_ramp":
            from pytensor_tpu_torch.tensor.basic import arange, cast
            from pytensor_tpu_torch.tensor.elemwise import DimShuffle

            end_values = kwargs.get("end_values", 0)
            if isinstance(end_values, (int, float, np.integer, np.floating)):
                end_lo = end_hi = float(end_values)
            else:
                evs = _norm_pad_width(end_values, x.type.ndim)
                end_lo, end_hi = evs[axis]

            def _axis_ramp(n):
                # fractions along the pad axis, broadcast over the rest
                r = arange(0, n, dtype="float64") / float(n)
                pat = ["x"] * out.type.ndim
                pat[axis] = 0
                return DimShuffle(1, pat)(r)

            from pytensor_tpu_torch.tensor.shape import specify_shape

            idx_first = [slice(None)] * out.type.ndim
            idx_first[axis] = slice(0, 1)
            idx_last = [slice(None)] * out.type.ndim
            idx_last[axis] = slice(-1, None)

            def _edge(idx):
                # slice(0, 1) is length 1 whenever padding is meaningful;
                # declare it so broadcasting is static, not runtime
                e = out[tuple(idx)]
                pinned = [1 if d == axis else e.type.shape[d]
                          for d in range(e.type.ndim)]
                return specify_shape(e, pinned)

            parts = []
            if lo:
                # outermost element is exactly end_lo; linear to the edge
                edge = _edge(idx_first)
                ramp = end_lo + (edge - end_lo) * _axis_ramp(lo)
                parts.append(cast(ramp, out.type.dtype))
            parts.append(out)
            if hi:
                edge = _edge(idx_last)
                # innermost->outermost: edge + (end-edge) * (j+1)/hi
                frac = (_axis_ramp(hi) * hi + 1.0) / float(hi)
                ramp = edge + (end_hi - edge) * frac
                parts.append(cast(ramp, out.type.dtype))
            out = concatenate(parts, axis=axis)
        else:
            raise NotImplementedError(f"pad mode {mode!r}")
    return out

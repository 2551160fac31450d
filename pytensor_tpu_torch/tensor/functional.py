"""Long-tail tensor helpers: ``vectorize`` and assorted utilities.

Counterpart of ``pytensor_tpu/tensor/functional.py``, all of it
(PyTensor's tensor/functional.py ``vectorize``, with tensor/basic.py and
extra_ops utilities): graph constructors over ported ops, with no
lowering of their own.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.tensor.basic import as_tensor_variable


def vectorize(fn, signature=None):
    """np.vectorize for graph functions (PyTensor's functional.py vectorize):
    ``fn`` builds a graph on core-typed variables; batch dims are handled
    by Blockwise over an OpFromGraph."""
    from pytensor_tpu_torch.compile.builders import OpFromGraph
    from pytensor_tpu_torch.tensor.blockwise import Blockwise
    from pytensor_tpu_torch.tensor.type import TensorType

    def wrapper(*args):
        args = [as_tensor_variable(a) for a in args]
        if signature is None:
            sig = ",".join(["()"] * len(args)) + "->()"
        else:
            sig = signature
        ins_s, _ = sig.split("->")
        core_ndims = [0 if s.strip("()") == "" else s.count(",") + 1
                      for s in ins_s.strip()[1:-1].split("),(")]
        core_inputs = [
            TensorType(a.type.dtype,
                       a.type.shape[a.type.ndim - nd:] if nd else ())()
            for a, nd in zip(args, core_ndims)
        ]
        core_out = fn(*core_inputs)
        many = isinstance(core_out, (list, tuple))
        outs = list(core_out) if many else [core_out]
        ofg = OpFromGraph(core_inputs, outs)
        res = Blockwise(ofg, signature=sig)(*args)
        if isinstance(res, list) and not many:
            return res[0]
        return res

    return wrapper


def atleast_3d(*arys, left=True):
    from pytensor_tpu_torch.tensor.basic import shape_padleft, shape_padright

    res = []
    for a in arys:
        a = as_tensor_variable(a)
        while a.type.ndim < 3:
            a = shape_padleft(a) if left else shape_padright(a)
        res.append(a)
    return res[0] if len(res) == 1 else res


def broadcast_shape(*tensors):
    """Symbolic broadcast shape tuple of the given tensors."""
    from pytensor_tpu_torch.tensor.extra_ops import broadcast_arrays

    return tuple(broadcast_arrays(*tensors)[0].shape)


def ceil_intdiv(a, b):
    a, b = as_tensor_variable(a), as_tensor_variable(b)
    return (a + b - 1) // b


def get_vector_length(v):
    """Static length of a 1-d variable, or raise ValueError."""
    v = as_tensor_variable(v)
    if v.type.ndim != 1:
        raise TypeError("get_vector_length expects a vector")
    if v.type.shape[0] is not None:
        return int(v.type.shape[0])
    from pytensor_tpu_torch.graph.basic import Constant

    if isinstance(v, Constant):
        return int(np.asarray(v.data).shape[0])
    raise ValueError(f"length of {v} is not statically known")


def inverse_permutation(perm):
    """argsort of a permutation = its inverse."""
    from pytensor_tpu_torch.tensor.sort import argsort

    return argsort(as_tensor_variable(perm))


def iround(x, mode=None):
    from pytensor_tpu_torch.tensor import math as tm

    return tm.iround(x, mode)


def round_half_away_from_zero(x):
    from pytensor_tpu_torch.tensor import math as tm

    return tm.round_half_away_from_zero(x)


def is_flat(x, ndim=1):
    return as_tensor_variable(x).type.ndim == ndim


def isfinite(x):
    from pytensor_tpu_torch.tensor import math as tm

    return ~(tm.isnan(x) | tm.isinf(x))


def isposinf(x):
    from pytensor_tpu_torch.tensor import math as tm

    x = as_tensor_variable(x)
    return tm.isinf(x) & (x > 0)


def isneginf(x):
    from pytensor_tpu_torch.tensor import math as tm

    x = as_tensor_variable(x)
    return tm.isinf(x) & (x < 0)


def nan_to_num(x, nan=0.0, posinf=None, neginf=None):
    from pytensor_tpu_torch.tensor import math as tm

    x = as_tensor_variable(x)
    dt = np.dtype(x.type.dtype if x.type.dtype != "bfloat16" else "float32")
    big = float(np.finfo(dt).max) if dt.kind == "f" else 0.0
    posinf = big if posinf is None else posinf
    neginf = -big if neginf is None else neginf
    # wrap replacement values at x's own dtype: a bare float literal would
    # autocast to floatX and 1.8e308 overflows to inf at float32
    nan_c, pos_c, neg_c = (
        as_tensor_variable(np.asarray(v, dtype=dt))
        for v in (nan, posinf, neginf))
    out = tm.switch(tm.isnan(x), nan_c, x)
    out = tm.switch(isposinf(x), pos_c, out)
    return tm.switch(isneginf(x), neg_c, out)


def median(x, axis=None):
    """Median via sort (even-length: mean of the middle pair)."""
    from pytensor_tpu_torch.tensor.shape import shape
    from pytensor_tpu_torch.tensor.sort import sort

    x = as_tensor_variable(x)
    if axis is None:
        x = x.flatten()
        axis = 0
    elif isinstance(axis, (tuple, list)):
        axes = tuple(int(a) % x.type.ndim for a in axis)
        if len(axes) == 1:
            axis = axes[0]
        else:
            # collapse the reduced axes into one trailing axis
            keep = [d for d in range(x.type.ndim) if d not in axes]
            x = x.transpose(*keep, *axes)
            from pytensor_tpu_torch.tensor.shape import shape as _shape

            keep_shape = [_shape(x)[i] for i in range(len(keep))]
            x = x.reshape(tuple(keep_shape) + (-1,), ndim=len(keep) + 1)
            axis = len(keep)
    s = sort(x, axis=axis)
    n = shape(x)[axis]
    half = n // 2

    def take(i):
        idx = [slice(None)] * x.type.ndim
        idx[axis] = i
        return s[tuple(idx)]

    from pytensor_tpu_torch.tensor import math as tm2

    even = tm2.eq(n % 2, 0)
    mid = take(half)
    mid_prev = take(half - 1)
    from pytensor_tpu_torch.tensor.basic import cast

    return tm2.switch(even, (mid + mid_prev) / 2.0,
                      cast(mid, "float64" if x.type.dtype == "float64"
                           else x.type.dtype))


def roll(x, shift, axis=None):
    from pytensor_tpu_torch.tensor.basic import concatenate

    x = as_tensor_variable(x)
    if axis is None:
        flat = x.flatten()
        return roll(flat, shift, axis=0).reshape(x.shape)
    shift = int(shift)
    dim = x.type.shape[axis]
    if dim is not None:
        # np.roll wraps: a shift beyond the axis length is modular
        shift = shift % dim if dim > 0 else 0
    elif shift != 0:
        from pytensor_tpu_torch.tensor.basic import arange
        from pytensor_tpu_torch.tensor.shape import shape
        from pytensor_tpu_torch.tensor.subtensor import take as _take

        # unknown length: modular gather keeps numpy's wrapping semantics
        n = shape(x)[axis]
        idx = (arange(0, n) - shift) % n
        return _take(x, idx, axis=axis)
    if shift == 0:
        return x
    # np.roll: result = concat(x[-shift:], x[:-shift]) along axis — the
    # same slice expression covers both signs via negative indexing
    idx_a = [slice(None)] * x.type.ndim
    idx_b = [slice(None)] * x.type.ndim
    idx_a[axis] = slice(-shift, None)
    idx_b[axis] = slice(None, -shift)
    return concatenate([x[tuple(idx_a)], x[tuple(idx_b)]], axis=axis)


def slice_at_axis(sl, axis):
    """Index tuple applying slice `sl` at `axis` (PyTensor's pad helper)."""
    return (slice(None),) * axis + (sl, Ellipsis)


def stacklists(arg):
    """Nested lists of variables -> stacked tensor (PyTensor's stacklists)."""
    from pytensor_tpu_torch.tensor.basic import stack

    if isinstance(arg, (tuple, list)):
        return stack([stacklists(a) for a in arg], axis=0)
    return as_tensor_variable(arg)


def tril_indices(n, k=0, m=None):
    """Constant sizes fold to numpy; symbolic sizes build
    ``Nonzero(tri-mask)``, whose coordinate outputs are distinct by
    construction (PyTensor's tril_indices: symbolic path via Nonzero)."""
    from pytensor_tpu_torch.graph.basic import Variable
    from pytensor_tpu_torch.tensor.basic import nonzero, tri

    if isinstance(n, Variable) or isinstance(m, Variable) \
            or isinstance(k, Variable):
        return nonzero(tri(n, m, k, dtype="bool"))
    r, c = np.tril_indices(n, k, m)
    return as_tensor_variable(r), as_tensor_variable(c)


def triu_indices(n, k=0, m=None):
    from pytensor_tpu_torch.graph.basic import Variable
    from pytensor_tpu_torch.tensor.basic import nonzero, tri

    if isinstance(n, Variable) or isinstance(m, Variable) \
            or isinstance(k, Variable):
        # upper triangle with diagonal offset k == NOT lower strictly
        # below it: ~tri(n, m, k - 1)
        mask = ~tri(n, m, k - 1, dtype="bool")
        return nonzero(mask)
    r, c = np.triu_indices(n, k, m)
    return as_tensor_variable(r), as_tensor_variable(c)


def tril_indices_from(a, k=0):
    a = as_tensor_variable(a)
    if a.type.ndim != 2 or None in a.type.shape:
        raise ValueError("tril_indices_from needs a statically-shaped matrix")
    return tril_indices(a.type.shape[0], k, a.type.shape[1])


def triu_indices_from(a, k=0):
    a = as_tensor_variable(a)
    if a.type.ndim != 2 or None in a.type.shape:
        raise ValueError("triu_indices_from needs a statically-shaped matrix")
    return triu_indices(a.type.shape[0], k, a.type.shape[1])


def fill_diagonal_offset(a, val, offset):
    """Matrix with the `offset` diagonal set to val."""
    from pytensor_tpu_torch.tensor.basic import eye
    from pytensor_tpu_torch.tensor.shape import shape

    a = as_tensor_variable(a)
    if a.type.ndim != 2:
        raise ValueError("fill_diagonal_offset expects a matrix")
    n, m = shape(a)[0], shape(a)[1]
    mask = eye(n, m, offset, dtype=a.type.dtype)
    return a * (1 - mask) + mask * val

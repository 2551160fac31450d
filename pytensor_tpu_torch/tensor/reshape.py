"""Dimension join/split helpers.

Counterpart of ``pytensor_tpu/tensor/reshape.py`` (PyTensor's
tensor/reshape.py JoinDims:21, SplitDims:152): thin graph constructors
over ``Reshape``, whose torch lowering is a view where the layout allows
one, so there is no op of their own to lower.
"""

from __future__ import annotations

from pytensor_tpu_torch.tensor.basic import as_tensor_variable


def join_dims(x, start_axis: int = 0, n_axes: int | None = None):
    """Merge ``n_axes`` consecutive dims of ``x`` starting at
    ``start_axis`` into one; ``n_axes=None`` joins through the last dim
    (PyTensor's tensor/reshape.py:100 signature)."""
    x = as_tensor_variable(x)
    ndim = x.type.ndim
    start = start_axis
    if start < 0:
        start += ndim
    n = (ndim - start) if n_axes is None else n_axes
    if not (0 <= start and start + n <= ndim):
        raise ValueError(f"join_dims: dims [{start}, {start + n}) out of range "
                         f"for ndim={ndim}")
    shp = x.shape
    merged = 1
    for k in range(start, start + n):
        merged = merged * shp[k]
    new_shape = ([shp[k] for k in range(start)] + [merged]
                 + [shp[k] for k in range(start + n, ndim)])
    return x.reshape(new_shape)


def split_dims(x, dim: int, sizes):
    """Split dim ``dim`` of ``x`` into the given ``sizes``.

    One entry may be -1 (inferred).  Inverse of :func:`join_dims`.
    """
    x = as_tensor_variable(x)
    ndim = x.type.ndim
    if dim < 0:
        dim += ndim
    if not 0 <= dim < ndim:
        raise ValueError(f"split_dims: dim {dim} out of range for ndim={ndim}")
    sizes = list(sizes)
    shp = x.shape
    new_shape = ([shp[k] for k in range(dim)] + sizes
                 + [shp[k] for k in range(dim + 1, ndim)])
    return x.reshape(new_shape)

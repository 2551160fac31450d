"""Tensor utilities.

Counterpart of ``pytensor_tpu/tensor/utils.py`` (PyTensor's
tensor/utils.py): ``hash_from_ndarray``, ``shape_of_variables`` (through
the ``ShapeFeature``, as the JAX package's) and the normalizers op
constructors use.
"""


from __future__ import annotations

import hashlib

import numpy as np


def hash_from_ndarray(data) -> str:
    """Stable content hash of an ndarray (PyTensor's tensor/utils.py:30)."""
    data = np.ascontiguousarray(data)
    h = hashlib.sha256()
    h.update(str(data.shape).encode())
    h.update(str(data.dtype).encode())
    h.update(data.tobytes())
    return h.hexdigest()


def as_list(x):
    """Wrap scalars into a 1-element list; pass lists/tuples through."""
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def normalize_reduce_axis(axis, ndim):
    """None | int | sequence -> sorted tuple of non-negative axes."""
    if axis is None:
        return tuple(range(ndim))
    if isinstance(axis, (int, np.integer)):
        axis = (int(axis),)
    out = []
    for a in axis:
        a = int(a)
        if a < 0:
            a += ndim
        if not (0 <= a < ndim):
            raise np.exceptions.AxisError(a, ndim)
        out.append(a)
    return tuple(sorted(set(out)))


def import_func_from_string(func_string: str):
    """Resolve ``"scipy.special.erf"``-style strings (PyTensor's
    tensor/utils.py:120); bare names look in numpy first."""
    func = getattr(np, func_string, None)
    if func is not None:
        return func
    items = func_string.split(".")
    module = None
    for idx in range(1, len(items)):
        try:
            module = __import__(".".join(items[:idx]))
        except ImportError:
            break
    if module:
        for sub in items[1:]:
            try:
                module = getattr(module, sub)
            except AttributeError:
                return None
        return module
    return None


def broadcast_static_dim_lengths(dim_lengths):
    """Static broadcast of per-input dim lengths (int | None); raises
    ValueError on incompatibility (PyTensor's tensor/utils.py:144)."""
    dim_lengths_set = set(dim_lengths)
    if len(dim_lengths_set) == 1:
        return next(iter(dim_lengths_set))
    if dim_lengths_set == {None, 1}:
        return None
    dim_lengths_set.discard(1)
    dim_lengths_set.discard(None)
    if len(dim_lengths_set) > 1:
        raise ValueError(f"Incompatible dim lengths {dim_lengths}")
    return next(iter(dim_lengths_set))


def safe_signature(core_inputs_ndim, core_outputs_ndim) -> str:
    """Build a gufunc signature from core ndims (PyTensor's tensor/utils.py:215)."""

    def operand_sig(operand_ndim, prefix):
        return "(" + ",".join(f"{prefix}{i}" for i in range(operand_ndim)) + ")"

    inputs_sig = ",".join(
        operand_sig(nd, f"i{n}") for n, nd in enumerate(core_inputs_ndim))
    outputs_sig = ",".join(
        operand_sig(nd, f"o{n}") for n, nd in enumerate(core_outputs_ndim))
    return f"{inputs_sig}->{outputs_sig}"


def faster_broadcast_to(x, shape):
    """np.broadcast_to without the safety wrapping (PyTensor's tensor/utils.py:254)."""
    return np.broadcast_to(x, shape)


def faster_ndindex(shape):
    """np.ndindex over a shape sequence via itertools.product
    (PyTensor's tensor/utils.py:265)."""
    from itertools import product

    return product(*(range(s) for s in shape))


def get_static_shape_from_size_variables(size_vars):
    """Per-entry static ints from a sequence of scalar size variables
    where they are constant, else None (PyTensor's tensor/utils.py:276)."""
    from pytensor_tpu_torch.tensor.basic import (
        NotScalarConstantError,
        get_scalar_constant_value,
    )

    out = []
    for v in size_vars:
        try:
            out.append(int(get_scalar_constant_value(v)))
        except NotScalarConstantError:
            out.append(None)
    return tuple(out)


def shape_of_variables(fgraph, input_shapes):
    """Numeric shapes of every variable in ``fgraph`` given input shapes
    (PyTensor's tensor/utils.py:43).

    Attaches a ``ShapeFeature`` (mutates the fgraph), resolves each
    variable's symbolic shape tuple, and evaluates the non-static entries
    as one function of the inputs, linked for the CPU (shapes are host
    values).
    """
    from pytensor_tpu_torch.graph.basic import Variable
    from pytensor_tpu_torch.tensor.rewriting.shape import ShapeFeature

    if not hasattr(fgraph, "shape_feature"):
        fgraph.attach_feature(ShapeFeature())
    sf = fgraph.shape_feature

    sym = {}
    dim_vars = {}
    for var in fgraph.variables:
        st = sf.shape_tuple(var)
        sym[var] = st
        if st is not None:
            for e in st:
                if isinstance(e, Variable):
                    dim_vars[e] = None

    val_map = {}
    if dim_vars:
        from pytensor_tpu_torch.compile.maker import function

        dims = list(dim_vars)
        f = function(list(fgraph.inputs), dims, on_unused_input="ignore", device="cpu")
        args = [np.zeros(tuple(input_shapes[i]), dtype=i.type.dtype) for i in fgraph.inputs]
        vals = f(*args)
        if len(dims) == 1:
            vals = [vals]
        val_map = {d: np.asarray(v) for d, v in zip(dims, vals)}

    out = {}
    for var, st in sym.items():
        if st is None:
            continue
        out[var] = tuple(val_map[e] if isinstance(e, Variable) else np.asarray(e) for e in st)
    return out

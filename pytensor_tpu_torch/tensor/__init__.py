"""Tensor namespace: types, constructors, math, shapes, indexing, blas.

Counterpart of ``pytensor_tpu/tensor/__init__.py`` for the modules the
port has: ``type``, ``variable``, ``elemwise``, ``basic``, ``math``,
``shape``, ``subtensor``, ``blas``, ``blockwise``, ``type_other``,
``sharedvar``, ``utils``, ``exceptions``, ``linalg``, ``sort``,
``extra_ops``, ``einsum``, ``functional``, ``reshape``, ``pad``, ``fft``,
``fourier``, ``signal``, ``interpolate`` and ``transfer``, with the
special functions, ``special``'s softmax family, ``optimize`` and the
complex ops.  Not yet here (ROADMAP Queue 1): the shape-parameter
gradients (item 10b) and ``random`` (item 7).  bfloat16 tensors are here
(``ml_dtypes.bfloat16`` arrays on the host), and complex64 and complex128
ones.
"""

from pytensor_tpu_torch.tensor.type import *  # noqa: F401,F403
from pytensor_tpu_torch.tensor.type import TensorType, tensor  # noqa: F401
from pytensor_tpu_torch.tensor.variable import TensorConstant, TensorVariable  # noqa: F401
from pytensor_tpu_torch.tensor.basic import *  # noqa: F401,F403
from pytensor_tpu_torch.tensor.basic import (  # noqa: F401
    NotScalarConstantError,
    alloc,
    arange,
    as_tensor,
    as_tensor_variable,
    cast,
    concatenate,
    constant,
    diag,
    diagonal,
    expand_dims,
    eye,
    fill,
    full,
    full_like,
    get_scalar_constant_value,
    identity_like,
    join,
    meshgrid,
    mgrid,
    moveaxis,
    ogrid,
    ones,
    ones_like,
    shape_padaxis,
    shape_padleft,
    shape_padright,
    split,
    stack,
    swapaxes,
    tile,
    transpose,
    tri,
    tril,
    triu,
    where,
    zeros,
    zeros_like,
)
from pytensor_tpu_torch.tensor.reshape import join_dims, split_dims  # noqa: F401
from pytensor_tpu_torch.tensor.functional import (  # noqa: F401
    atleast_3d,
    broadcast_shape,
    ceil_intdiv,
    fill_diagonal_offset,
    get_vector_length,
    inverse_permutation,
    iround,
    is_flat,
    isfinite,
    isneginf,
    isposinf,
    median,
    nan_to_num,
    roll,
    round_half_away_from_zero,
    slice_at_axis,
    stacklists,
    tril_indices,
    tril_indices_from,
    triu_indices,
    triu_indices_from,
    vectorize,
)
from pytensor_tpu_torch.tensor.interpolate import interp, interpolate1d  # noqa: F401
from pytensor_tpu_torch.tensor.type_other import (  # noqa: F401
    MakeSlice,
    NoneConst,
    make_slice,
    none_type_t,
)
from pytensor_tpu_torch.tensor.math import *  # noqa: F401,F403
from pytensor_tpu_torch.tensor import math  # noqa: F401
from pytensor_tpu_torch.tensor.math import (  # noqa: F401
    abs,
    all,
    any,
    max,
    min,
    pow,
    round,
    sum,
)
from pytensor_tpu_torch.tensor.math import sign as sgn  # noqa: F401
from pytensor_tpu_torch.tensor.math import conj as conjugate  # noqa: F401
from pytensor_tpu_torch.tensor.basic import diagonal as extract_diag  # noqa: F401
from pytensor_tpu_torch.tensor.shape import (  # noqa: F401
    Reshape,
    Shape,
    Shape_i,
    SpecifyShape,
    Unbroadcast,
    flatten,
    reshape,
    shape,
    shape_i,
    shape_tuple,
    specify_broadcastable,
    specify_shape,
    unbroadcast,
)
from pytensor_tpu_torch.tensor.subtensor import (  # noqa: F401
    AdvancedIncSubtensor,
    AdvancedIncSubtensor1,
    AdvancedSubtensor,
    AdvancedSubtensor1,
    IncSubtensor,
    Subtensor,
    advanced_inc_subtensor1,
    advanced_set_subtensor1,
    flip,
    inc_subtensor,
    set_subtensor,
    take,
    take_along_axis,
)
from pytensor_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise  # noqa: F401
from pytensor_tpu_torch.tensor import extra_ops  # noqa: F401
from pytensor_tpu_torch.tensor.extra_ops import (  # noqa: F401
    bartlett,
    bincount,
    broadcast_arrays,
    broadcast_to,
    compress,
    cumprod,
    cumsum,
    diff,
    fill_diagonal,
    linspace,
    logspace,
    ravel_multi_index,
    repeat,
    searchsorted,
    squeeze,
    unique,
    unravel_index,
)
from pytensor_tpu_torch.tensor.sharedvar import TensorSharedVariable  # noqa: F401
from pytensor_tpu_torch.gradient import grad  # noqa: F401
from pytensor_tpu_torch.compile.ops import view_op as tensor_copy  # noqa: F401

identity = tensor_copy


def tensor_from_scalar(x):
    """0-d scalars are tensors here; kept for the API."""
    return as_tensor_variable(x)


def scalar_from_tensor(x):
    x = as_tensor_variable(x)
    if x.type.ndim != 0:
        raise TypeError("scalar_from_tensor expects a 0-d tensor")
    return x


def complex_from_polar(abs_, angle):
    """``abs_ * exp(1j * angle)`` in complex128, as the JAX package builds it."""
    from pytensor_tpu_torch.tensor import math as _m

    re = abs_ * _m.cos(angle)
    im = abs_ * _m.sin(angle)
    return (cast(re, "complex128")
            + cast(as_tensor_variable(1j), "complex128") * cast(im, "complex128"))


def concat_with_broadcast(tensor_list, axis=0):
    """Concatenate after broadcasting all non-axis dims to a common shape
    (PyTensor's tensor/basic.py concat_with_broadcast)."""
    tensor_list = [as_tensor_variable(t) for t in tensor_list]
    ndim = tensor_list[0].type.ndim
    if axis < 0:
        axis += ndim
    # broadcast every non-axis dim: probe via zero-sums of slices
    probes = []
    for t in tensor_list:
        idx = [slice(None)] * ndim
        idx[axis] = slice(0, 1)
        probes.append(t[tuple(idx)] * 0)
    common = probes[0]
    for p in probes[1:]:
        common = common + p
    return concatenate([t + cast(common, t.type.dtype) for t in tensor_list], axis=axis)


def geomspace(start, stop, num=50, base=10.0, dtype=None):
    from pytensor_tpu_torch.tensor import math as _m
    from pytensor_tpu_torch.tensor.extra_ops import linspace as _linspace

    start = as_tensor_variable(start)
    stop = as_tensor_variable(stop)
    lin = _linspace(_m.log(start) / float(_np.log(base)),
                    _m.log(stop) / float(_np.log(base)), num)
    out = as_tensor_variable(float(base)) ** lin
    return cast(out, dtype) if dtype is not None else out


import numpy as _np  # noqa: E402

pi = _np.pi
e = _np.e
euler_gamma = _np.euler_gamma
inf = _np.inf
nan = _np.nan
newaxis = None

# the blas rewrites register into specialize here, before the rewrite
# packs, as in the JAX package
import pytensor_tpu_torch.tensor.blas as blas  # noqa: E402,F401
from pytensor_tpu_torch.tensor.blas import batched_dot  # noqa: E402,F401

# registers the fusion pass into optdb
import pytensor_tpu_torch.tensor.fused  # noqa: F401,E402

# the batching rules of vectorize_graph register on import
import pytensor_tpu_torch.tensor.blockwise  # noqa: F401,E402
from pytensor_tpu_torch.tensor.blockwise import Blockwise  # noqa: F401,E402

import pytensor_tpu_torch.tensor.type_other as slicetype  # noqa: F401,E402
from pytensor_tpu_torch.tensor import exceptions, utils  # noqa: F401,E402

from pytensor_tpu_torch.tensor.sort import argsort, sort, topk  # noqa: F401,E402
import pytensor_tpu_torch.tensor.linalg as linalg  # noqa: F401,E402
import pytensor_tpu_torch.tensor.special as special  # noqa: F401,E402
from pytensor_tpu_torch.tensor.special import log_softmax, softmax  # noqa: F401,E402
from pytensor_tpu_torch.tensor.einsum import einsum  # noqa: F401,E402
from pytensor_tpu_torch.tensor.pad import pad  # noqa: F401,E402
import pytensor_tpu_torch.tensor.fft as fft  # noqa: F401,E402
import pytensor_tpu_torch.tensor.signal as signal  # noqa: F401,E402
from pytensor_tpu_torch.tensor.signal import convolve1d, convolve2d  # noqa: F401,E402
from pytensor_tpu_torch.tensor import transfer  # noqa: F401,E402
import pytensor_tpu_torch.tensor.optimize as optimize  # noqa: F401,E402

# the legacy names of the linalg namespace, as in the JAX package
slinalg = linalg
nlinalg = linalg

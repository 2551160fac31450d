"""Tensor namespace: types, constructors, math, shapes, indexing, blas.

Counterpart of ``pytensor_tpu/tensor/__init__.py`` for the modules the
port has: ``type``, ``variable``, ``elemwise``, ``basic``, ``math``,
``shape``, ``subtensor``, ``blas``, ``blockwise``, ``type_other``,
``sharedvar``, ``utils``, ``exceptions``, ``linalg`` and ``sort``'s
``sort`` and ``argsort``.  Not yet here (ROADMAP Queue 1): the special
functions and ``functional`` (item 10), ``extra_ops``, ``topk``,
``einsum``, ``pad``, ``fft``, ``signal`` and the rest of item 12,
``random`` (item 7) and bfloat16 and complex tensors.
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

from pytensor_tpu_torch.tensor.sort import argsort, sort  # noqa: F401,E402
import pytensor_tpu_torch.tensor.linalg as linalg  # noqa: F401,E402

# the legacy names of the linalg namespace, as in the JAX package
slinalg = linalg
nlinalg = linalg

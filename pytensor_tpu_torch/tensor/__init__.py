"""Tensor namespace: types, constructors and math used by the models.

Counterpart of ``pytensor_tpu/tensor/__init__.py``, cut to what
``models/radon.py``, the sparse power iteration and the rewrites use.
"""

from pytensor_tpu_torch.tensor.type import TensorType, tensor  # noqa: F401
from pytensor_tpu_torch.tensor.variable import TensorConstant, TensorVariable  # noqa: F401
from pytensor_tpu_torch.tensor.basic import (  # noqa: F401
    as_tensor_variable,
    cast,
    constant,
    fill,
    moveaxis,
    ones_like,
    transpose,
    zeros_like,
)
from pytensor_tpu_torch.tensor.math import (  # noqa: F401
    abs,
    add,
    cos,
    dot,
    exp,
    ge,
    log,
    lt,
    max,
    maximum,
    mul,
    neg,
    pow,
    second,
    sigmoid,
    sin,
    sqr,
    sqrt,
    sub,
    sum,
    tanh,
    tensordot,
    true_div,
)
from pytensor_tpu_torch.tensor.shape import reshape, shape, specify_shape  # noqa: F401
from pytensor_tpu_torch.tensor.subtensor import inc_subtensor, set_subtensor  # noqa: F401

# registers the fusion pass into optdb
import pytensor_tpu_torch.tensor.fused  # noqa: F401,E402

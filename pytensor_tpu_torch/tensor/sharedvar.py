"""Tensor shared variables (counterpart of ``pytensor_tpu/tensor/sharedvar.py``)."""

from __future__ import annotations

import numpy as np
import torch

from pytensor_tpu_torch.compile.sharedvalue import SharedVariable
from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.tensor.type import TensorType
from pytensor_tpu_torch.tensor.variable import _tensor_py_operators


class TensorSharedVariable(_tensor_py_operators, SharedVariable):
    __slots__ = ()


def tensor_shared_constructor(value, name=None, borrow=False, shape=None, *, device):
    """A TensorSharedVariable holding a copy of ``value`` on ``device``.

    Python ints become int64 and Python floats ``floatX``, as in the JAX
    package; numpy scalars, arrays and tensors keep their dtype.  The static shape is
    fully unknown (the value may be resized by ``set_value``) unless
    ``shape`` gives it.  With ``borrow``, a torch tensor already on
    ``device`` is held as it is, not copied.
    """
    from pytensor_tpu_torch.link.torch.convert import as_torch

    if isinstance(value, torch.Tensor):
        tensor = as_torch(value.detach(), device)
        # a tensor moved to ``device`` is a copy already
        if not borrow and tensor.data_ptr() == value.data_ptr():
            tensor = tensor.clone()
    else:
        if isinstance(value, (bool, np.generic)):
            arr = np.asarray(value)  # np.float64 is a float, and keeps its dtype
        elif isinstance(value, int):
            arr = np.asarray(value, dtype="int64")
        elif isinstance(value, float):
            arr = np.asarray(value, dtype=config.floatX)
        else:
            arr = np.asarray(value)
        tensor = as_torch(arr, device)
    dtype = str(tensor.dtype).removeprefix("torch.")
    static = (None,) * tensor.ndim if shape is None else tuple(shape)
    if len(static) != tensor.ndim or any(s is not None and s != d
                                          for s, d in zip(static, tensor.shape)):
        raise ValueError(f"shape {static} does not fit a value of shape {tuple(tensor.shape)}")
    return TensorSharedVariable(TensorType(dtype, static), tensor, name=name)

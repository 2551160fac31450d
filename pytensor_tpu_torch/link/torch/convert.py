"""Values in and out of the port: numpy <-> torch, dtype names <-> torch.

The radon data, ``theta`` and ``m`` reach both packages as numpy arrays
made from one seed; ``as_torch`` turns such a value into a tensor of the
same dtype and shape on an explicit device.  The linker uses it for graph
constants and the tests for inputs.
"""

from __future__ import annotations

import numpy as np
import torch

_DTYPES = {
    "bool": torch.bool,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "int64": torch.int64,
    "uint8": torch.uint8,
    "float16": torch.float16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype for a graph dtype name."""
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise TypeError(f"dtype {dtype} has no torch counterpart") from None


def resolve_device(device) -> torch.device:
    """A torch.device; asking for CUDA where there is none raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but torch.cuda.is_available() is False")
        if device.index is None:
            # tensors report cuda:N; compare like with like
            device = torch.device("cuda", torch.cuda.current_device())
    return device


def as_torch(value, device) -> torch.Tensor:
    """A tensor with ``value``'s dtype and shape on ``device``.

    ``value`` is a numpy array or scalar (or anything ``np.asarray``
    accepts, such as a JAX array on the host).  A tensor is moved, never
    cast.
    """
    device = resolve_device(device)
    if isinstance(value, torch.Tensor):
        return value.to(device)
    arr = np.asarray(value)
    torch_dtype(arr.dtype)  # reject dtypes torch does not have
    # a copy: the tensor never aliases the caller's array (torch refuses
    # negative strides, so reversed views are made contiguous first)
    return torch.tensor(np.array(arr, order="C"), device=device)

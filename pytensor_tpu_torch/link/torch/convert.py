"""Values in and out of the port: numpy <-> torch, dtype names <-> torch.

The radon data, ``theta`` and ``m`` reach both packages as numpy arrays
made from one seed; ``as_torch`` turns such a value into a tensor of the
same dtype and shape on an explicit device.  The linker uses it for graph
constants and the tests for inputs.  A sparse matrix reaches both
packages as a scipy matrix; ``sparse_as_torch`` turns it into the port's
one sparse value, the canonical CSR triple of ``CSR`` on a device.
"""

from __future__ import annotations

from dataclasses import dataclass

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


@dataclass(frozen=True)
class CSR:
    """A sparse matrix on a device: row pointers (int32, rows + 1),
    column indices (int32, nnz, sorted within each row, no duplicates)
    and values (nnz), with the matrix's ``(rows, cols)``.  Not a tuple:
    the linker unpacks a tuple that a lowering returns into outputs."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: tuple


def canonical_csr(A, dtype=None):
    """``(indptr, indices, data)`` of scipy matrix ``A`` as numpy arrays:
    CSR whatever ``A``'s format, duplicates summed and the columns of each
    row sorted (what ``pytensor_tpu/sparse/type.py:66-73`` does before a
    matrix reaches XLA), int32 indices, values in ``dtype`` or ``A``'s."""
    import scipy.sparse as sp

    if not sp.issparse(A):
        raise TypeError(f"expected a scipy sparse matrix, got {type(A)}")
    A = sp.csr_matrix(A, copy=True)
    A.sum_duplicates()
    A.sort_indices()
    return (np.ascontiguousarray(A.indptr, dtype=np.int32),
            np.ascontiguousarray(A.indices, dtype=np.int32),
            np.ascontiguousarray(A.data, dtype=dtype or A.dtype))


def sparse_as_torch(A, device, dtype=None) -> CSR:
    """Scipy matrix ``A`` as the canonical CSR triple on ``device``."""
    indptr, indices, data = canonical_csr(A, dtype)
    return CSR(as_torch(indptr, device), as_torch(indices, device), as_torch(data, device),
               tuple(int(d) for d in A.shape))

"""Values in and out of the port: numpy <-> torch, dtype names <-> torch.

The radon data, ``theta`` and ``m`` reach both packages as numpy arrays
made from one seed; ``as_torch`` turns such a value into a tensor of the
same dtype and shape on an explicit device.  The linker uses it for graph
constants and the tests for inputs.  numpy has no bfloat16: a bfloat16
value on the host is an ``ml_dtypes.bfloat16`` array, which torch refuses,
so it crosses as its 16 bits (``as_torch``, ``to_numpy``).  complex64 and
complex128 cross as they are (a ``torch.conj`` view is resolved first).  A sparse matrix reaches both
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
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
    "float64": torch.float64,
    "complex64": torch.complex64,
    "complex128": torch.complex128,
}


# uint16, uint32 and uint64 are held in int64, whose bits agree with
# numpy's wrap-around for +, - and * (torch has these dtypes, but few of
# their kernels: its CPU add, comparisons and maximum refuse uint64); the
# lowerings that meet them treat comparisons, division, maximum, minimum
# and conversions as unsigned (``dispatch.py``), and a function returns
# them in torch's unsigned dtype of their width
UNSIGNED = {"uint16": torch.uint16, "uint32": torch.uint32, "uint64": torch.uint64}
_DTYPES.update({d: torch.int64 for d in UNSIGNED})


def torch_dtype(dtype) -> torch.dtype:
    """torch dtype for a graph dtype name (int64 for the unsigned dtypes
    above uint8, which hold their values)."""
    try:
        return _DTYPES[str(dtype)]
    except KeyError:
        raise TypeError(f"dtype {dtype} has no torch counterpart") from None


def held(value: torch.Tensor, dtype) -> torch.Tensor:
    """A tensor of graph dtype ``dtype`` as the linker holds it: a uint16,
    uint32 or uint64 tensor as int64 (uint64 by its bits)."""
    if str(dtype) == "uint64" and value.dtype == torch.uint64:
        return value.view(torch.int64)
    if str(dtype) in UNSIGNED and value.dtype == UNSIGNED[str(dtype)]:
        return value.to(torch.int64)
    return value


def unheld(value: torch.Tensor, dtype) -> torch.Tensor:
    """The inverse of ``held``: a held unsigned value in torch's unsigned
    dtype of its width."""
    if str(dtype) == "uint64":
        return value.view(torch.uint64)
    if str(dtype) in UNSIGNED:
        return value.to(UNSIGNED[str(dtype)])
    return value


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
    if str(arr.dtype) == "bfloat16":
        # torch refuses ml_dtypes' bfloat16 arrays: their bits, as int16
        bits = torch.tensor(np.array(arr, order="C").view(np.int16), device=device)
        return bits.view(torch.bfloat16)
    if arr.dtype == np.uint64:
        arr = arr.view(np.int64)
    elif arr.dtype in (np.uint16, np.uint32):
        arr = arr.astype(np.int64)
    # a copy: the tensor never aliases the caller's array (torch refuses
    # negative strides, so reversed views are made contiguous first)
    return torch.tensor(np.array(arr, order="C"), device=device)


def to_numpy(value: torch.Tensor) -> np.ndarray:
    """A tensor's value as a numpy array on the host; a bfloat16 tensor as
    an ``ml_dtypes.bfloat16`` array of the same bits."""
    value = value.detach().cpu()
    if value.is_complex():
        value = value.resolve_conj()
    if value.dtype == torch.bfloat16:
        import ml_dtypes

        return value.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return value.numpy()


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

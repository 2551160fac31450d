"""TensorType: dtype + static shape with None holes.

Counterpart of ``pytensor_tpu/tensor/type.py`` (PyTensor's tensor/type.py
TensorType:58): the ``shape`` tuple records statically-known dims (None =
unknown), subtyping widens None dims, and ``filter`` validates values.
"""

from __future__ import annotations

from typing import Any, Iterable, Optional

import numpy as np

from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.graph.type import Type

int_dtypes = ("int8", "int16", "int32", "int64")
uint_dtypes = ("uint8", "uint16", "uint32", "uint64")
float_dtypes = ("float16", "float32", "float64")
complex_dtypes = ("complex64", "complex128")
discrete_dtypes = ("bool",) + int_dtypes + uint_dtypes
continuous_dtypes = float_dtypes + complex_dtypes
all_dtypes = discrete_dtypes + continuous_dtypes


def _normalize_dtype(dtype) -> str:
    if dtype == "floatX":
        return config.floatX
    return str(np.dtype(dtype))


class TensorType(Type):
    __props__ = ("dtype", "shape")

    def __init__(self, dtype, shape: Iterable[Optional[int]] = None, name: str | None = None):
        self.dtype = _normalize_dtype(dtype)
        if self.dtype not in all_dtypes:
            raise TypeError(f"Unsupported dtype: {self.dtype}")
        self.shape = tuple(
            None if s is None else int(s) for s in (shape if shape is not None else ())
        )
        if any(s is not None and s < 0 for s in self.shape):
            raise ValueError(f"Invalid static shape {self.shape}")
        self.name = name

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def broadcastable(self) -> tuple[bool, ...]:
        return tuple(s == 1 for s in self.shape)

    @property
    def numpy_dtype(self):
        return np.dtype(self.dtype)

    def clone(self, dtype=None, shape=None, **kwargs):
        return type(self)(
            dtype if dtype is not None else self.dtype,
            shape if shape is not None else self.shape,
        )

    def filter(self, data: Any, strict: bool = False, allow_downcast: bool | None = None):
        if strict:
            if not isinstance(data, np.ndarray):
                raise TypeError(f"{self} expected an ndarray, got {type(data)}")
            if str(data.dtype) != self.dtype:
                raise TypeError(f"{self} expected dtype {self.dtype}, got {data.dtype}")
            converted = data
        else:
            converted = np.asarray(data)
            if str(converted.dtype) != self.dtype:
                up = np.promote_types(converted.dtype, self.numpy_dtype)
                ok = str(up) == str(self.numpy_dtype)
                if not ok and allow_downcast is None:
                    # Python floats/lists adopt a narrower float dtype; an
                    # explicit float64 array into a float32 slot is an error
                    ok = (
                        not isinstance(data, np.ndarray)
                        and converted.dtype.kind == "f"
                        and self.dtype in ("float32", "float16")
                    ) or (converted.dtype.kind in "iu" and self.dtype in int_dtypes + uint_dtypes
                          and np.can_cast(converted.dtype, self.numpy_dtype, "same_kind")
                    ) or (
                        isinstance(data, (int, bool))
                        and not isinstance(data, np.generic)
                        and self.numpy_dtype.kind == "f"
                    )
                if not (ok or allow_downcast):
                    raise TypeError(
                        f"{self}: cannot safely cast {converted.dtype} to {self.dtype}"
                    )
                converted = converted.astype(self.numpy_dtype)
        if converted.ndim != self.ndim:
            raise TypeError(
                f"{self}: wrong number of dimensions, expected {self.ndim}, "
                f"got {converted.ndim} (value shape {converted.shape})"
            )
        for s, d in zip(self.shape, converted.shape):
            if s is not None and s != d:
                raise TypeError(
                    f"{self}: shape mismatch, expected {self.shape}, got {converted.shape}"
                )
        return converted

    def filter_variable(self, other, allow_convert: bool = True):
        from pytensor_tpu_torch.graph.basic import Variable

        if not isinstance(other, Variable):
            from pytensor_tpu_torch.tensor.basic import as_tensor_variable

            other = as_tensor_variable(other, dtype=self.dtype)
        return super().filter_variable(other, allow_convert=allow_convert)

    def convert_variable(self, var):
        vtype = var.type
        if not isinstance(vtype, TensorType):
            return None
        if self.dtype != vtype.dtype or self.ndim != vtype.ndim:
            return None
        if self.is_super(vtype):
            return var
        if vtype.is_super(self):
            # narrowing: assert the static shape at runtime
            from pytensor_tpu_torch.tensor.shape import specify_shape

            return specify_shape(var, self.shape)
        return None

    def is_super(self, otype) -> bool:
        return (
            isinstance(otype, TensorType)
            and self.dtype == otype.dtype
            and self.ndim == otype.ndim
            and all(s is None or s == o for s, o in zip(self.shape, otype.shape))
        )

    def make_constant_signature(self, data):
        arr = np.asarray(data)
        return (self.dtype, arr.shape, arr.tobytes())

    def values_eq(self, a, b) -> bool:
        if a.shape != b.shape or str(a.dtype) != str(b.dtype):
            return False
        return bool(np.array_equal(np.asarray(a), np.asarray(b), equal_nan=True))

    def __str__(self):
        if self.name:
            return self.name
        shape_str = ", ".join("?" if s is None else str(s) for s in self.shape)
        return f"Tensor({self.dtype}, shape=({shape_str}))"


# --- constructors ---
def tensor(name=None, *, dtype=None, shape=None):
    if dtype is None:
        dtype = config.floatX
    return TensorType(dtype, shape if shape is not None else ())(name)

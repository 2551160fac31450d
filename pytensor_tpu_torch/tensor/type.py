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


def _np_dtype(dtype: str):
    return np.dtype(dtype)


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
    if isinstance(name, str) and dtype is None and "." not in name and name in all_dtypes:
        # tensor("float64", shape=...): the legacy calling convention
        dtype, name = name, None
    if dtype is None:
        dtype = config.floatX
    return TensorType(dtype, shape if shape is not None else ())(name)


def _make_ctor(dtype_key: str, ndim: int):
    def ctor(name=None, *, shape=None, dtype=None):
        if shape is None:
            shape = (None,) * ndim
        if len(shape) != ndim:
            raise ValueError(f"shape must have {ndim} dims")
        d = dtype or (config.floatX if dtype_key == "floatX" else dtype_key)
        return TensorType(d, shape)(name)

    return ctor


scalar = _make_ctor("floatX", 0)
vector = _make_ctor("floatX", 1)
matrix = _make_ctor("floatX", 2)
row = lambda name=None, dtype=None: TensorType(dtype or config.floatX, (1, None))(name)  # noqa: E731
col = lambda name=None, dtype=None: TensorType(dtype or config.floatX, (None, 1))(name)  # noqa: E731
tensor3 = _make_ctor("floatX", 3)
tensor4 = _make_ctor("floatX", 4)
tensor5 = _make_ctor("floatX", 5)
tensor6 = _make_ctor("floatX", 6)
tensor7 = _make_ctor("floatX", 7)

dscalar = _make_ctor("float64", 0)
dvector = _make_ctor("float64", 1)
dmatrix = _make_ctor("float64", 2)
dtensor3 = _make_ctor("float64", 3)
dtensor4 = _make_ctor("float64", 4)
fscalar = _make_ctor("float32", 0)
fvector = _make_ctor("float32", 1)
fmatrix = _make_ctor("float32", 2)
ftensor3 = _make_ctor("float32", 3)
ftensor4 = _make_ctor("float32", 4)
bscalar = _make_ctor("int8", 0)
wscalar = _make_ctor("int16", 0)
iscalar = _make_ctor("int32", 0)
lscalar = _make_ctor("int64", 0)
ivector = _make_ctor("int32", 1)
lvector = _make_ctor("int64", 1)
imatrix = _make_ctor("int32", 2)
lmatrix = _make_ctor("int64", 2)
bvector = _make_ctor("int8", 1)
bmatrix = _make_ctor("int8", 2)
wvector = _make_ctor("int16", 1)
wmatrix = _make_ctor("int16", 2)
cscalar = _make_ctor("complex64", 0)
zscalar = _make_ctor("complex128", 0)
cvector = _make_ctor("complex64", 1)
zvector = _make_ctor("complex128", 1)
cmatrix = _make_ctor("complex64", 2)
zmatrix = _make_ctor("complex128", 2)


def _apply_across(ctor, names, kwargs):
    """PyTensor's apply_across_args: ``vectors("abc")`` means one variable
    per character; an int means that many anonymous variables (always a
    list); several args mean one variable per arg."""
    if names and isinstance(names[0], int):
        return [ctor(**kwargs) for _ in range(names[0])]
    if len(names) == 1 and isinstance(names[0], str):
        names = names[0]
        if len(names) == 1:
            return ctor(names, **kwargs)
        return [ctor(n, **kwargs) for n in names]
    return [ctor(n, **kwargs) for n in names]


def scalars(*names, **kwargs):
    return _apply_across(scalar, names, kwargs)


def vectors(*names, **kwargs):
    return _apply_across(vector, names, kwargs)


def matrices(*names, **kwargs):
    return _apply_across(matrix, names, kwargs)


def dmatrices(*names):
    return _apply_across(dmatrix, names, {})


def dvectors(*names):
    return _apply_across(dvector, names, {})


def fmatrices(*names):
    return _apply_across(fmatrix, names, {})


def fvectors(*names):
    return _apply_across(fvector, names, {})


# --- the dtype-shortcut constructors of every prefix and rank (PyTensor's
# tensor/type.py grid) ------------------------------------------------------

_PREFIX_DTYPES = {
    "b": "int8", "w": "int16", "i": "int32", "l": "int64",
    "f": "float32", "d": "float64", "c": "complex64", "z": "complex128",
}
_RANK_NAMES = {0: "scalar", 1: "vector", 2: "matrix", 3: "tensor3",
               4: "tensor4", 5: "tensor5", 6: "tensor6", 7: "tensor7"}


def _row_col_ctor(dtype_key, kind):
    def ctor(name=None, dtype=None):
        d = dtype or (config.floatX if dtype_key == "floatX" else dtype_key)
        shape = (1, None) if kind == "row" else (None, 1)
        return TensorType(d, shape)(name)

    return ctor


def _plural(ctor):
    def plural(*names, **kwargs):
        return [ctor(n, **kwargs) for n in names]

    return plural


_g = globals()
for _rank, _rname in _RANK_NAMES.items():
    if _rname not in _g:
        _g[_rname] = _make_ctor("floatX", _rank)
    if _rname + "s" not in _g:
        _g[_rname + "s"] = _plural(_g[_rname])
    for _pfx, _dt in _PREFIX_DTYPES.items():
        _n = _pfx + _rname
        if _n not in _g:
            _g[_n] = _make_ctor(_dt, _rank)
        if _n + "s" not in _g:
            _g[_n + "s"] = _plural(_g[_n])
for _pfx, _dt in _PREFIX_DTYPES.items():
    for _kind in ("row", "col"):
        _n = _pfx + _kind
        if _n not in _g:
            _g[_n] = _row_col_ctor(_dt, _kind)
        if _n + "s" not in _g:
            _g[_n + "s"] = _plural(_g[_n])
for _kind in ("row", "col"):
    if _kind + "s" not in _g:
        _g[_kind + "s"] = _plural(_g[_kind])

# dtype-family tuples (PyTensor's tensor/type.py exports); the port has
# no bfloat16
int_types = int_dtypes
uint_types = uint_dtypes
float_types = float_dtypes
complex_types = complex_dtypes
int_scalar_types = int_types
float_scalar_types = float_types
complex_scalar_types = complex_types
int_vector_types = int_types
float_vector_types = float_types
complex_vector_types = complex_types
int_matrix_types = int_types
float_matrix_types = float_types
complex_matrix_types = complex_types

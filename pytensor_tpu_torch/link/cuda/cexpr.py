"""Scalar ops as C++ expressions, for the generated CUDA kernels.

Shared by K1 (``tensor/fused_kernel.py``, a FusedElemwise) and K2
(``link/cuda/scan_kernel.py``, a whole scan): the C type of each dtype,
one expression per scalar op over operands already cast to the compute
dtype, and exact literals.  Both kernels are built with ``-fmad=false``,
so each op rounds on its own, as torch's eager ops do.
"""

from __future__ import annotations

import math

import numpy as np

CTYPES = {
    "float32": "float", "float64": "double", "bool": "bool",
    "int8": "signed char", "int16": "short", "int32": "int", "int64": "long long",
    "uint8": "unsigned char", "uint16": "unsigned short", "uint32": "unsigned int",
}

# numpy's maximum, which both kernels' sources define: NaN in either
# operand gives NaN
MAX_SOURCE = """// numpy's maximum: NaN in either operand gives NaN
template <typename T> __device__ __forceinline__ T k2_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}
"""


def ctype(dtype) -> str:
    return CTYPES[str(dtype)]


def _fn(f32, f64):
    return lambda a, t: f"{f32 if t == 'float32' else f64}({a[0]})"


# scalar op name -> C++ expression over operands already cast to the
# compute dtype ``t``
CEXPR = {
    "add": lambda a, t: "(" + " + ".join(a) + ")",
    "mul": lambda a, t: "(" + " * ".join(a) + ")",
    "sub": lambda a, t: f"({a[0]} - {a[1]})",
    "neg": lambda a, t: f"(-{a[0]})",
    # fabs clears the sign of -0.0, as numpy's abs does; abs and sqr of a
    # bool are the bool, as the graph's type says (in C, a bool times a
    # bool is an int)
    "abs": lambda a, t: (f"{'fabsf' if t == 'float32' else 'fabs'}({a[0]})"
                         if t in ("float32", "float64") else a[0] if t == "bool"
                         else f"({a[0]} < 0 ? -{a[0]} : {a[0]})"),
    "sqr": lambda a, t: a[0] if t == "bool" else f"({a[0]} * {a[0]})",
    "true_div": lambda a, t: f"({a[0]} / {a[1]})",
    "reciprocal": lambda a, t: f"(({CTYPES[t]})1 / {a[0]})",
    "pow": lambda a, t: (f"k2_ipow({a[0]}, {a[1]})" if t not in ("float32", "float64")
                         else f"{'powf' if t == 'float32' else 'pow'}({a[0]}, {a[1]})"),
    "exp": _fn("expf", "exp"),
    "log": _fn("logf", "log"),
    "sqrt": _fn("sqrtf", "sqrt"),
    "sin": _fn("sinf", "sin"),
    "cos": _fn("cosf", "cos"),
    "tanh": _fn("tanhf", "tanh"),
    "sigmoid": lambda a, t: (f"(({CTYPES[t]})1 / (({CTYPES[t]})1 + "
                             f"{'expf' if t == 'float32' else 'exp'}(-{a[0]})))"),
    "maximum": lambda a, t: f"k2_max({a[0]}, {a[1]})",
    "lt": lambda a, t: f"({a[0]} < {a[1]})",
    "ge": lambda a, t: f"({a[0]} >= {a[1]})",
    "second": lambda a, t: a[1],
}


def literal(value, dtype) -> str:
    """An exact C++ literal of ``value`` in ``dtype`` (a hex float for a
    float: ``0x1.999999999999ap-4`` is float64's 0.1)."""
    v = np.asarray(value).astype(dtype).item()
    if dtype == "bool":
        return "true" if v else "false"
    if dtype in ("float32", "float64"):
        ct = ctype(dtype)
        if math.isnan(v):
            return f"(({ct})NAN)"
        if math.isinf(v):
            return f"(({ct})INFINITY)" if v > 0 else f"(-({ct})INFINITY)"
        return float.hex(float(v)) + ("f" if dtype == "float32" else "")
    if v == -(2 ** 63):
        return "(-9223372036854775807LL - 1)"
    return f"(({ctype(dtype)}){int(v)}LL)"

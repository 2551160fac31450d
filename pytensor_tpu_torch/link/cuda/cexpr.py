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


# helper functions an expression may call, by name; a source defines the
# ones its expressions call (``helpers``)
HELPERS = {
    "k2_max": MAX_SOURCE,
    "k2_min": """// numpy's minimum: NaN in either operand gives NaN
template <typename T> __device__ __forceinline__ T k2_min(T a, T b) {
  return (a < b || a != a) ? a : b;
}
""",
    "k2_ipow": """template <typename T> __device__ __forceinline__ T k2_ipow(T a, T b) {
  T r = 1;
  for (T i = 0; i < b; ++i) r *= a;
  return r;
}
""",
    # numpy's floor_divide and mod: an integer quotient floored, an integer
    # divisor of 0 gives 0 (C's / and % truncate, and are undefined for a
    # divisor of 0 and for the least value over -1); a float by numpy's
    # npy_divmod, fmod corrected to the divisor's sign
    "k2_floordiv": """template <typename T> __device__ __forceinline__ T k2_floordiv(T a, T b) {
  if (b == 0) return 0;
  if ((T)-1 < (T)0 && b == (T)-1) return (T)(0ULL - (unsigned long long)a);
  T q = a / b;
  return (q * b != a && ((a < 0) != (b < 0))) ? (T)(q - 1) : q;
}
template <typename T> __device__ __forceinline__ T k2_fdivmod(T a, T b, T* m) {
  T mod = fmod(a, b);
  if (!b) { *m = mod; return a / b; }
  T div = (a - mod) / b;
  if (mod) {
    if ((b < 0) != (mod < 0)) { mod += b; div -= (T)1; }
  } else {
    mod = copysign((T)0, b);
  }
  T fl;
  if (div) {
    fl = floor(div);
    if (div - fl > (T)0.5) fl += (T)1;
  } else {
    fl = copysign((T)0, a / b);
  }
  *m = mod;
  return fl;
}
__device__ __forceinline__ float k2_floordiv(float a, float b) {
  float m;
  return k2_fdivmod(a, b, &m);
}
__device__ __forceinline__ double k2_floordiv(double a, double b) {
  double m;
  return k2_fdivmod(a, b, &m);
}
""",
    "k2_mod": """template <typename T> __device__ __forceinline__ T k2_mod(T a, T b) {
  if (b == 0 || ((T)-1 < (T)0 && b == (T)-1)) return 0;
  T r = a % b;
  return (r != 0 && ((r < 0) != (b < 0))) ? (T)(r + b) : r;
}
__device__ __forceinline__ float k2_mod(float a, float b) {
  float m;
  if (!b) return fmodf(a, b);
  k2_fdivmod(a, b, &m);
  return m;
}
__device__ __forceinline__ double k2_mod(double a, double b) {
  double m;
  if (!b) return fmod(a, b);
  k2_fdivmod(a, b, &m);
  return m;
}
""",
    # numpy's shifts: a count below 0 or of the width or more gives 0, or -1
    # for a negative value shifted right (C leaves both undefined)
    "k2_shl": """template <typename T> __device__ __forceinline__ T k2_shl(T a, T b) {
  return (unsigned long long)b < 8 * sizeof(T) ? (T)((unsigned long long)a << b) : (T)0;
}
""",
    "k2_shr": """template <typename T> __device__ __forceinline__ T k2_shr(T a, T b) {
  return (unsigned long long)b < 8 * sizeof(T) ? (T)(a >> b) : (T)(a < (T)0 ? -1 : 0);
}
""",
}
# a helper that calls another
_HELPER_NEEDS = {"k2_mod": ("k2_floordiv",)}


def helpers(body: str, have=("k2_max",)) -> str:
    """The sources of the helpers that ``body`` calls, less those in
    ``have`` (already in the source's prelude)."""
    names = [n for n in HELPERS if n + "(" in body]
    for n in list(names):
        names += [m for m in _HELPER_NEEDS.get(n, ()) if m not in names]
    return "".join(HELPERS[n] for n in HELPERS if n in names and n not in have)


def ctype(dtype) -> str:
    return CTYPES[str(dtype)]


def _fn(f32, f64):
    return lambda a, t: f"{f32 if t == 'float32' else f64}({a[0]})"


def _fn2(f32, f64):
    return lambda a, t: f"{f32 if t == 'float32' else f64}({a[0]}, {a[1]})"


def _is_float(t):
    return t in ("float32", "float64")


def _float_or_self(f32, f64):
    """A rounding function of a float; an integer rounds to itself."""
    return lambda a, t: f"{f32 if t == 'float32' else f64}({a[0]})" if _is_float(t) else a[0]


def _float_or(value, f32, f64):
    """A test of a float; an integer or a bool is never NaN or inf."""
    return lambda a, t: f"{f32 if t == 'float32' else f64}({a[0]})" if _is_float(t) else value


def _times(table):
    return lambda a, t: f"({a[0]} * {literal(table[t], t)})"


# numpy's constants (scalar/basic.py _DEG2RAD, _RAD2DEG)
_DEG2RAD = {"float32": np.float32(np.pi / 180), "float64": np.pi / 180}
_RAD2DEG = {"float32": np.float32(180) / np.float32(np.pi), "float64": 180 / np.pi}

# scalar op name -> C++ expression over operands already cast to their
# compute dtypes (``ScalarOp.compute_dtypes``); ``t`` is the first
# operand's
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
    # jnp.sign's values: a float zero keeps its sign and NaN stays NaN
    "sign": lambda a, t: (f"({a[0]} > 0 ? ({CTYPES[t]})1 : ({a[0]} < 0 ? ({CTYPES[t]})-1 : "
                          f"{a[0]}))" if _is_float(t)
                          else f"(({CTYPES[t]})(({a[0]} > 0) - ({a[0]} < 0)))"),
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
    # --- comparisons, selection, logic
    "gt": lambda a, t: f"({a[0]} > {a[1]})",
    "le": lambda a, t: f"({a[0]} <= {a[1]})",
    "eq": lambda a, t: f"({a[0]} == {a[1]})",
    "neq": lambda a, t: f"({a[0]} != {a[1]})",
    "isnan": _float_or("false", "isnan", "isnan"),
    "isinf": _float_or("false", "isinf", "isinf"),
    "minimum": lambda a, t: f"k2_min({a[0]}, {a[1]})",
    "and_": lambda a, t: f"({a[0]} & {a[1]})",
    "or_": lambda a, t: f"({a[0]} | {a[1]})",
    "xor": lambda a, t: f"({a[0]} ^ {a[1]})",
    # the invert of a bool is logical not, as numpy's
    "invert": lambda a, t: f"(!{a[0]})" if t == "bool" else f"(~{a[0]})",
    "left_shift": lambda a, t: f"k2_shl({a[0]}, {a[1]})",
    "right_shift": lambda a, t: f"k2_shr({a[0]}, {a[1]})",
    # the condition in its own dtype, the branches in the output's
    "switch": lambda a, t: f"({a[0]} ? {a[1]} : {a[2]})",
    # the lower bound first, as the reference's clip
    "clip": lambda a, t: f"({a[0]} < {a[1]} ? {a[1]} : ({a[0]} > {a[2]} ? {a[2]} : {a[0]}))",
    "identity": lambda a, t: a[0],
    # --- integer and rounding arithmetic
    "int_div": lambda a, t: f"k2_floordiv({a[0]}, {a[1]})",
    "mod": lambda a, t: f"k2_mod({a[0]}, {a[1]})",
    "floor": _fn("floorf", "floor"),
    "ceil": _fn("ceilf", "ceil"),
    "trunc": _fn("truncf", "trunc"),
    # rint rounds half to even in the default rounding mode
    "round_half_to_even": _float_or_self("rintf", "rint"),
    # the JAX package's numpy oracle, copysign(floor(|a| + 0.5), a): not
    # C's round, which gives 0 for 0.49999997f
    "round_half_away_from_zero": lambda a, t: (
        f"{'copysignf(floorf(fabsf' if t == 'float32' else 'copysign(floor(fabs'}({a[0]}) + "
        f"{literal(0.5, t)}), {a[0]})" if _is_float(t) else a[0]),
    # --- exponentials, logarithms, angles
    "exp2": _fn("exp2f", "exp2"),
    "expm1": _fn("expm1f", "expm1"),
    "log1p": _fn("log1pf", "log1p"),
    "log2": _fn("log2f", "log2"),
    "log10": _fn("log10f", "log10"),
    "deg2rad": _times(_DEG2RAD),
    "rad2deg": _times(_RAD2DEG),
    # --- trigonometric and hyperbolic
    "tan": _fn("tanf", "tan"),
    "cosh": _fn("coshf", "cosh"),
    "sinh": _fn("sinhf", "sinh"),
    "arcsin": _fn("asinf", "asin"),
    "arccos": _fn("acosf", "acos"),
    "arctan": _fn("atanf", "atan"),
    "arctan2": _fn2("atan2f", "atan2"),
    "arcsinh": _fn("asinhf", "asinh"),
    "arccosh": _fn("acoshf", "acosh"),
    "arctanh": _fn("atanhf", "atanh"),
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

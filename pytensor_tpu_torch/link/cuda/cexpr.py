"""Scalar ops as C++ expressions, for the generated CUDA kernels.

Shared by K1 (``tensor/fused_kernel.py``, a FusedElemwise) and K2
(``link/cuda/scan_kernel.py``, a whole scan): the C type of each dtype,
one expression per scalar op over operands already cast to the compute
dtype, and exact literals.  Both kernels are built with ``-fmad=false``,
so each op rounds on its own, as torch's eager ops do.

A bfloat16 value is ``__nv_bfloat16`` in memory and a float in registers
(``rtype``).  A bfloat16 op computes in float, a special function in
double, and its result is rounded to the nearest bfloat16 before the next
op reads it (``k2_rbf``): XLA and torch round each bfloat16 op's result
so, and rounding only once at the end of a fused chain gives other values.
``expression`` and ``operand`` write both rules.

A complex64 or complex128 value is a ``float2`` or ``double2`` (cuComplex's
layout: the real part, then the imaginary part) in memory and in
registers; its ops are the functions of ``COMPLEX_SOURCE``, numpy's
definitions (``CCEXPR``).
"""

from __future__ import annotations

import math

import numpy as np

from pytensor_tpu_torch.link.cuda import special
from pytensor_tpu_torch.utils import np_dtype

CTYPES = {
    "float32": "float", "float64": "double", "bfloat16": "__nv_bfloat16", "bool": "bool",
    "int8": "signed char", "int16": "short", "int32": "int", "int64": "long long",
    "uint8": "unsigned char", "uint16": "unsigned short", "uint32": "unsigned int",
    "complex64": "float2", "complex128": "double2",
}
COMPLEX = ("complex64", "complex128")

# numpy's maximum, which both kernels' sources define: NaN in either
# operand gives NaN
MAX_SOURCE = """// numpy's maximum: NaN in either operand gives NaN
template <typename T> __device__ __forceinline__ T k2_max(T a, T b) {
  return (a > b || a != a) ? a : b;
}
"""


# bfloat16 in registers: loads widen to float, each op's result is rounded
# to bfloat16 (to nearest, ties to even; NaN stays NaN), stores narrow
BF16_SOURCE = """#include <cuda_bf16.h>
// bfloat16 held in a float: each op's result rounded, loads, stores, and
// a value from the host passed in its pointer's place (its low 16 bits)
__device__ __forceinline__ float k2_rbf(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float k2_ldbf(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ __nv_bfloat16 k2_stbf(float x) { return __float2bfloat16_rn(x); }
__device__ __forceinline__ float k2_bfbits(const void* q) {
  return __bfloat162float(__ushort_as_bfloat16((unsigned short)(unsigned long long)q));
}
// K1's 16-byte vector of eight bfloat16 values, widened to floats
template <typename I> __device__ __forceinline__ void k1_load(const __nv_bfloat16* p, I j, float* v) {
  const uint4 q = reinterpret_cast<const uint4*>(p)[j];
  const __nv_bfloat16* h = reinterpret_cast<const __nv_bfloat16*>(&q);
#pragma unroll
  for (int k = 0; k < 8; ++k) v[k] = __bfloat162float(h[k]);
}
template <typename I> __device__ __forceinline__ void k1_store(__nv_bfloat16* p, I j, const float* v) {
  uint4 q;
  __nv_bfloat16* h = reinterpret_cast<__nv_bfloat16*>(&q);
#pragma unroll
  for (int k = 0; k < 8; ++k) h[k] = __float2bfloat16_rn(v[k]);
  reinterpret_cast<uint4*>(p)[j] = q;
}
"""

# complex64 and complex128 as float2 and double2: numpy's definitions of
# each op K1 emits (its loops for add, sub, mul and Smith's division, and
# npy_math's cabs, carg, cexp, clog and csqrt)
COMPLEX_SOURCE = r"""// complex64 / complex128 as float2 / double2 (the real part, then the
// imaginary part), numpy's definitions of each op
__device__ __forceinline__ float2 kc_make(float re, float im) {
  float2 z;
  z.x = re;
  z.y = im;
  return z;
}
__device__ __forceinline__ double2 kc_make(double re, double im) {
  double2 z;
  z.x = re;
  z.y = im;
  return z;
}
#define KC_DEFINE(C, R, F)                                                        \
  __device__ __forceinline__ C kc_add(C a, C b) { return kc_make(a.x + b.x, a.y + b.y); } \
  __device__ __forceinline__ C kc_sub(C a, C b) { return kc_make(a.x - b.x, a.y - b.y); } \
  __device__ __forceinline__ C kc_neg(C a) { return kc_make(-a.x, -a.y); }             \
  __device__ __forceinline__ C kc_conj(C a) { return kc_make(a.x, -a.y); }            \
  __device__ __forceinline__ bool kc_eq(C a, C b) { return a.x == b.x && a.y == b.y; } \
  __device__ __forceinline__ bool kc_neq(C a, C b) { return a.x != b.x || a.y != b.y; } \
  __device__ __forceinline__ C kc_mul(C a, C b) {                                 \
    return kc_make(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);                 \
  }                                                                               \
  /* Smith's division, as numpy's loop; a zero divisor gives inf or NaN */        \
  __device__ __forceinline__ C kc_div(C a, C b) {                                 \
    const R br = fabs##F(b.x), bi = fabs##F(b.y);                                 \
    if (br >= bi) {                                                               \
      if (br == 0 && bi == 0) return kc_make(a.x / br, a.y / br);                 \
      const R rat = b.y / b.x, scl = (R)1 / (b.x + b.y * rat);                    \
      return kc_make((a.x + a.y * rat) * scl, (a.y - a.x * rat) * scl);           \
    }                                                                             \
    const R rat = b.x / b.y, scl = (R)1 / (b.y + b.x * rat);                      \
    return kc_make((a.x * rat + a.y) * scl, (a.y * rat - a.x) * scl);             \
  }                                                                               \
  /* the modulus without overflow or underflow */                                 \
  __device__ __forceinline__ R kc_abs(C a) { return hypot##F(a.x, a.y); }          \
  __device__ __forceinline__ R kc_angle(C a) { return atan2##F(a.y, a.x); }        \
  __device__ __forceinline__ C kc_exp(C a) {                                      \
    const R e = exp##F(a.x);                                                      \
    if (a.y == 0) return kc_make(e, a.y);                                         \
    return kc_make(e * cos##F(a.y), e * sin##F(a.y));                             \
  }                                                                               \
  /* npy_clog: log1p near |z| = 1, where log(|z|) would cancel */                 \
  __device__ __forceinline__ C kc_log(C a) {                                      \
    const R ax = fabs##F(a.x), ay = fabs##F(a.y);                                 \
    const R h = hypot##F(ax, ay);                                                 \
    R rr;                                                                         \
    if (h >= (R)0.71 && h <= (R)1.73) {                                           \
      const R am = ax > ay ? ax : ay, an = ax > ay ? ay : ax;                     \
      rr = log1p##F((am - 1) * (am + 1) + an * an) / 2;                           \
    } else {                                                                      \
      rr = log##F(h);                                                             \
    }                                                                             \
    return kc_make(rr, atan2##F(a.y, a.x));                                       \
  }
KC_DEFINE(float2, float, f)
KC_DEFINE(double2, double, )
#undef KC_DEFINE
// npy_csqrt (C99's csqrt): the branch cut's sign, infinities and NaN as C
// says; a complex128 is scaled by 1/4 near overflow, a complex64 computed
// in double
__device__ __forceinline__ double2 kc_sqrt(double2 z) {
  const double a = z.x, b = z.y;
  if (a == 0 && b == 0) return kc_make(0.0, b);
  if (isinf(b)) return kc_make((double)INFINITY, b);
  if (isnan(a)) return kc_make(a, (b - b) / (b - b));
  if (isinf(a)) {
    if (signbit(a)) return kc_make(fabs(b - b), copysign(a, b));
    return kc_make(a, copysign(b - b, b));
  }
  const double big = 7.446288774449766337959726e+307;
  const bool scale = fabs(a) >= big || fabs(b) >= big;
  const double s = scale ? 0.25 : 1.0, x = a * s, y = b * s;
  double2 r;
  if (x >= 0) {
    const double t = sqrt((x + hypot(x, y)) * 0.5);
    r = kc_make(t, y / (2 * t));
  } else {
    const double t = sqrt((-x + hypot(x, y)) * 0.5);
    r = kc_make(fabs(y) / (2 * t), copysign(t, y));
  }
  return scale ? kc_make(r.x * 2, r.y * 2) : r;
}
__device__ __forceinline__ float2 kc_sqrt(float2 z) {
  const double2 r = kc_sqrt(kc_make((double)z.x, (double)z.y));
  return kc_make((float)r.x, (float)r.y);
}
"""

# helper functions an expression may call, by name; a source defines the
# ones its expressions call (``helpers``)
HELPERS = {
    "kc_make": COMPLEX_SOURCE,
    "k2_rbf": BF16_SOURCE,
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
# the special functions (``link/cuda/special.py``) after the helpers above
HELPERS.update(special.HELPERS)
# the other helpers that a helper calls
_HELPER_NEEDS = {"k2_mod": ("k2_floordiv",), **special.NEEDS}
# the functions a helper defines, where its name is not the one called
_HELPER_ENTRIES = {"k2_rbf": ("k2_rbf", "k2_ldbf", "k2_stbf", "k2_bfbits"),
                   "kc_make": ("kc_make", "kc_add", "kc_sub", "kc_neg", "kc_conj", "kc_eq",
                               "kc_neq", "kc_mul", "kc_div", "kc_abs", "kc_angle", "kc_exp",
                               "kc_log", "kc_sqrt"),
                   **special.ENTRIES}


def helpers(body: str, have=("k2_max",)) -> str:
    """The sources of the helpers that ``body`` calls, and of the helpers
    those call, in ``HELPERS``' order, less those in ``have`` (already in
    the source's prelude)."""
    names = {n for n in HELPERS
             if any(e + "(" in body for e in _HELPER_ENTRIES.get(n, (n,)))}
    todo = list(names)
    while todo:
        for m in _HELPER_NEEDS.get(todo.pop(), ()):
            if m not in names:
                names.add(m)
                todo.append(m)
    return "".join(HELPERS[n] for n in HELPERS if n in names and n not in have)


def ctype(dtype) -> str:
    """The C type of a dtype in memory."""
    return CTYPES[str(dtype)]


def rtype(dtype) -> str:
    """The C type of a dtype in registers: a bfloat16 value is a float."""
    return "float" if str(dtype) == "bfloat16" else CTYPES[str(dtype)]


def load(expr, dtype) -> str:
    """A value of ``dtype`` read from memory (``expr``), in registers."""
    return f"k2_ldbf({expr})" if dtype == "bfloat16" else expr


def store(expr, dtype) -> str:
    """A register value of ``dtype`` as it is written to memory."""
    return f"k2_stbf({expr})" if dtype == "bfloat16" else expr


def operand(expr, src, dst) -> str:
    """Register value ``expr`` of dtype ``src`` as one of dtype ``dst``:
    narrowed to bfloat16 it is rounded (through float, as torch converts)."""
    if src == dst or (src == "bfloat16" and dst == "float32"):
        return expr
    if dst in COMPLEX:
        r = rtype(_REAL[dst])
        if src in COMPLEX:
            return f"kc_make(({r})({expr}).x, ({r})({expr}).y)"
        return f"kc_make(({r}){expr}, ({r})0)"
    if dst == "bfloat16":
        return f"k2_rbf((float){expr})"
    return f"(({rtype(dst)}){expr})"


def expression(name, args, comp, out) -> str:
    """The register value of dtype ``out`` of scalar op ``name`` over
    register operands ``args``, already in their compute dtypes ``comp``.
    A bfloat16 op computes in float (a special function in double) and
    rounds its result to bfloat16; a variadic add or mul rounds after each
    pair, as the plain version's fold does, and ``sigmoid`` after each of
    its ops, as ``jax.nn.sigmoid`` does."""
    t = comp[0]
    if out in COMPLEX or any(c in COMPLEX for c in comp):
        # each expression is of the output's C type already
        return CCEXPR[name](args)
    if "bfloat16" not in comp:
        return f"({rtype(out)}){CEXPR[name](args, t)}"
    wide = "float64" if name in special.CEXPR else "float32"
    args = [operand(a, c, wide) if c == "bfloat16" else a for a, c in zip(args, comp)]
    if name == "sigmoid":
        # jax.nn.sigmoid in bfloat16, as XLA computes it: 1 / (1 + exp(-x)),
        # each op rounded (the plain version's too)
        return f"k2_rbf(1.0f / k2_rbf(1.0f + k2_rbf(expf(-{args[0]}))))"
    if name in ("add", "mul") and len(args) > 2:
        acc = args[0]
        for a in args[1:]:
            acc = expression(name, [acc, a], ["bfloat16"] * 2, out)
        return acc
    # deg2rad and rad2deg multiply by their constant rounded to bfloat16
    e = CEXPR[name](args, wide if t == "bfloat16" and name not in _TABLES else t)
    return operand(f"({e})", wide, out) if out == "bfloat16" else f"({rtype(out)}){e}"


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
_DEG2RAD = {"float32": np.float32(np.pi / 180), "float64": np.pi / 180,
            "bfloat16": np_dtype("bfloat16").type(np.pi / 180)}
_RAD2DEG = {"float32": np.float32(180) / np.float32(np.pi), "float64": 180 / np.pi,
            "bfloat16": np_dtype("bfloat16").type(180 / np.pi)}

_TABLES = ("deg2rad", "rad2deg")

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
    # the special functions of scalar/math.py (link/cuda/special.py)
    **special.CEXPR,
}


_REAL = {"complex64": "float32", "complex128": "float64"}


def _fold(fn, a):
    acc = a[0]
    for b in a[1:]:
        acc = f"{fn}({acc}, {b})"
    return acc


def _part(field):
    return lambda a: f"({a[0]}).{field}"


# scalar op name -> C++ expression over complex operands (``float2`` or
# ``double2``), already cast to their compute dtypes: the ops K1 emits for
# complex64 and complex128 (``tensor/fused_kernel.py _COMPLEX_OPS``)
CCEXPR = {
    "real": _part("x"),
    "imag": _part("y"),
    "conj": lambda a: f"kc_conj({a[0]})",
    "angle": lambda a: f"kc_angle({a[0]})",
    "abs": lambda a: f"kc_abs({a[0]})",
    "complex": lambda a: f"kc_make({a[0]}, {a[1]})",
    "neg": lambda a: f"kc_neg({a[0]})",
    "add": lambda a: _fold("kc_add", a),
    "sub": lambda a: f"kc_sub({a[0]}, {a[1]})",
    "mul": lambda a: _fold("kc_mul", a),
    "true_div": lambda a: f"kc_div({a[0]}, {a[1]})",
    "sqr": lambda a: f"kc_mul({a[0]}, {a[0]})",
    "exp": lambda a: f"kc_exp({a[0]})",
    "log": lambda a: f"kc_log({a[0]})",
    "sqrt": lambda a: f"kc_sqrt({a[0]})",
    "eq": lambda a: f"kc_eq({a[0]}, {a[1]})",
    "neq": lambda a: f"kc_neq({a[0]}, {a[1]})",
    "identity": lambda a: a[0],
}


def literal(value, dtype) -> str:
    """An exact C++ literal of ``value`` in ``dtype`` (a hex float for a
    float: ``0x1.999999999999ap-4`` is float64's 0.1)."""
    if dtype in COMPLEX:
        v = complex(np.asarray(value).astype(dtype).item())
        return f"kc_make({literal(v.real, _REAL[dtype])}, {literal(v.imag, _REAL[dtype])})"
    v = np.asarray(value).astype(np_dtype(dtype)).item()
    if dtype == "bool":
        return "true" if v else "false"
    if dtype == "bfloat16":
        # the bfloat16 value, exact as a float literal
        return literal(float(v), "float32")
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

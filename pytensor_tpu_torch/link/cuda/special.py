"""The special functions as CUDA device functions, for K1 and K2.

Entries of ``link/cuda/cexpr.py``'s ``HELPERS`` and ``CEXPR``: the ops of
``scalar/math.py`` that run on the device, each a ``__device__``
function over one element, in float32 and float64.  CUDA's math library
gives what it has (``erf``, ``erfc``, ``erfinv``, ``erfcinv``, ``erfcx``,
``lgamma``, ``tgamma``, ``j0``, ``j1``, ``cyl_bessel_i0``,
``cyl_bessel_i1``, ``normcdf``, ``normcdfinv``, each with its ``f``
form for float32).  The rest is written here:

- digamma and trigamma (reflection, recurrence to x >= 10, the
  asymptotic series), and polygamma through the Hurwitz zeta function
  (Cephes' Euler-Maclaurin sum);
- the regularized incomplete gamma, its series below x = k + 1 and its
  Lentz continued fraction above (``pytensor_tpu/scalar/math.py:444``),
  and the incomplete beta's continued fraction (``:332``);
- softplus, log1mexp, logit, xlogy and xlog1py at the JAX package's
  branch points (``scalar/math.py:187-240``);
- the Bessel cores of ``pytensor_tpu/scalar/bessel.py``: ``I``/``K``
  (``:99 _ik_core``: CF1, the downward recurrence, Temme's series below
  x = 2 or Steed's CF2 above, the Wronskian, the upward recurrence),
  ``J``/``Y`` (``:366 _jy_core``, with the complex CF2), their
  asymptotic expansions above max(90, 3 v^2) and scipy's contracts at
  x <= 0 and for negative order (``:297-360``).

The JAX package evaluates each continued fraction over the whole array
until every lane has converged; here each thread loops until its own
element converges, capped at ``KS_CF_MAXIT``, with no read of the device
on the host.  The iterative functions (the gamma, beta and Bessel ones)
compute in double and round the result, in float32 as in float64: a
thread's loop costs the same either way, and the float32 results then
carry float64's error, not the JAX package's float32 error.  The card's
float64 rate is half its float32 rate, and these functions are bound by
their operations, not their bytes.

A source defines only the helpers its expressions call (``helpers``);
``NEEDS`` gives the helpers that each of these calls.
"""

from __future__ import annotations

# the bessel code's domain split points and caps (scalar/bessel.py:44-48)
X_SERIES, X_ASYM, CF_MAXIT, ASYM_TERMS = 2.0, 90.0, 40000, 12

_BASE = r"""// special functions: limits, and the math library by overload
#ifndef KS_BASE
#define KS_BASE
#define KS_CF_MAXIT %(maxit)d
#define KS_PI 3.14159265358979323846
#define KS_EPS 2.220446049250313e-16
#define KS_FPMIN (2.2250738585072014e-308 / KS_EPS)
#define KS_INF ((double)INFINITY)
// the long functions are called, not inlined: a K1 kernel holds its op at
// each of its 5 sites (4 vector lanes and the tail), twice (32- and 64-bit
// indices), and inlining a fraction at each multiplies nvcc's time
#ifndef __noinline__
#define __noinline__ __attribute__((noinline))
#endif
__device__ __forceinline__ float ks_lgamma(float x) { return lgammaf(x); }
__device__ __forceinline__ double ks_lgamma(double x) { return lgamma(x); }
__device__ __forceinline__ float ks_tgamma(float x) { return tgammaf(x); }
__device__ __forceinline__ double ks_tgamma(double x) { return tgamma(x); }
__device__ __forceinline__ float ks_log1p(float x) { return log1pf(x); }
__device__ __forceinline__ double ks_log1p(double x) { return log1p(x); }
__device__ __forceinline__ float ks_log(float x) { return logf(x); }
__device__ __forceinline__ double ks_log(double x) { return log(x); }
__device__ __forceinline__ float ks_exp(float x) { return expf(x); }
__device__ __forceinline__ double ks_exp(double x) { return exp(x); }
__device__ __forceinline__ float ks_expm1(float x) { return expm1f(x); }
__device__ __forceinline__ double ks_expm1(double x) { return expm1(x); }
// sin(pi x), cos(pi x) with x reduced exactly first
__device__ inline double ks_sinpi(double x) {
  if (isinf(x)) return NAN;
  const double n = rint(2.0 * x), f = x - 0.5 * n;
  double q = fmod(n, 4.0);
  if (q < 0) q += 4.0;
  const double s = sin(KS_PI * f), c = cos(KS_PI * f);
  return q == 0 ? s : q == 1 ? c : q == 2 ? -s : -c;
}
__device__ inline double ks_cospi(double x) { return ks_sinpi(x + 0.5); }
#endif
""" % {"maxit": CF_MAXIT}

_DIGAMMA = r"""// digamma: reflection below 0, recurrence up to 10, asymptotic series
__device__ __noinline__ double ks_psi(double x) {
  if (isnan(x) || x == KS_INF) return x;
  if (x == -KS_INF) return x - x;
  if (x == 0) return signbit(x) ? KS_INF : -KS_INF;
  double r = 0;
  if (x < 0) {
    if (x == floor(x)) return NAN;
    r = -KS_PI * ks_cospi(x) / ks_sinpi(x);
    x = 1.0 - x;
  }
  while (x < 10.0) { r -= 1.0 / x; x += 1.0; }
  const double f = 1.0 / (x * x);
  const double t = f * (-1.0 / 12 + f * (1.0 / 120 + f * (-1.0 / 252 + f * (1.0 / 240
      + f * (-1.0 / 132 + f * (691.0 / 32760 + f * (-1.0 / 12)))))));
  return r + log(x) - 0.5 / x + t;
}
__device__ __forceinline__ float ks_psi(float x) { return (float)ks_psi((double)x); }
"""

_TRIGAMMA = r"""// trigamma: reflection below 0, recurrence up to 10, asymptotic series
__device__ __noinline__ double ks_trigamma(double x) {
  if (isnan(x)) return x;
  if (x == KS_INF) return 0.0;
  if (x <= 0 && x == floor(x)) return KS_INF;
  double r = 0;
  if (x < 0) {
    const double s = ks_sinpi(x);
    r = KS_PI * KS_PI / (s * s);
    x = 1.0 - x;
    // psi1(x) = pi^2 / sin^2(pi x) - psi1(1 - x)
    double q = 0;
    while (x < 10.0) { q += 1.0 / (x * x); x += 1.0; }
    const double f = 1.0 / (x * x);
    q += 1.0 / x + f / 2 + f / x * (1.0 / 6 + f * (-1.0 / 30 + f * (1.0 / 42 + f * (-1.0 / 30
         + f * (5.0 / 66 + f * (-691.0 / 2730 + f * (7.0 / 6)))))));
    return r - q;
  }
  while (x < 10.0) { r += 1.0 / (x * x); x += 1.0; }
  const double f = 1.0 / (x * x);
  return r + 1.0 / x + f / 2 + f / x * (1.0 / 6 + f * (-1.0 / 30 + f * (1.0 / 42
         + f * (-1.0 / 30 + f * (5.0 / 66 + f * (-691.0 / 2730 + f * (7.0 / 6)))))));
}
__device__ __forceinline__ float ks_trigamma(float x) { return (float)ks_trigamma((double)x); }
"""

_ZETA = r"""// Hurwitz zeta(s, q), Cephes' zeta.c: a direct sum, then Euler-Maclaurin
__device__ __noinline__ double ks_zeta(double s, double q) {
  const double A[12] = {12.0, -720.0, 30240.0, -1209600.0, 47900160.0,
      -1.8924375803183791606e9, 7.47242496e10, -2.950130727918164224e12,
      1.1646782814350067249e14, -4.5979787224074726105e15, 1.8152105401943546773e17,
      -7.1661652561756670113e18};
  if (isnan(s) || isnan(q)) return s + q;
  if (s == 1.0) return KS_INF;
  if (s < 1.0) return NAN;
  if (q <= 0.0) {
    if (q == floor(q)) return KS_INF;
    if (s != floor(s)) return NAN;
  }
  if (q > 1e8) return (1.0 / (s - 1.0) + 1.0 / (2.0 * q)) * pow(q, 1.0 - s);
  double sum = pow(q, -s), a = q, b = 0.0;
  int i = 0;
  while (i < 9 || a <= 9.0) {
    i += 1;
    a += 1.0;
    b = pow(a, -s);
    sum += b;
    if (fabs(b / sum) < KS_EPS) return sum;
  }
  const double w = a;
  sum += b * w / (s - 1.0);
  sum -= 0.5 * b;
  double fac = 1.0, k = 0.0;
  for (i = 0; i < 12; ++i) {
    fac *= s + k;
    b /= w;
    const double t = fac * b / A[i];
    sum += t;
    if (fabs(t / sum) < KS_EPS) break;
    k += 1.0;
    fac *= s + k;
    b /= w;
    k += 1.0;
  }
  return sum;
}
"""

_POLYGAMMA = r"""// polygamma(n, x) = (-1)^(n+1) n! zeta(n + 1, x); digamma at n = 0
__device__ __noinline__ double ks_polygamma(double n, double x) {
  if (isnan(n) || isnan(x)) return n + x;
  if (n < 0 || n != floor(n)) return NAN;
  if (n == 0) return ks_psi(x);
  const double z = ks_zeta(n + 1.0, x);
  const double sgn = fmod(n, 2.0) == 0 ? -1.0 : 1.0;
  return sgn * exp(lgamma(n + 1.0)) * z;
}
__device__ __forceinline__ float ks_polygamma(float n, float x) {
  return (float)ks_polygamma((double)n, (double)x);
}
"""

_GAMMAINC = r"""// regularized incomplete gamma: the series below x = k + 1, the Lentz
// continued fraction for the complement above; each to convergence
__device__ inline double ks_gamma_front(double k, double x) {
  return exp(-x + k * log(x) - lgamma(k));
}
__device__ inline double ks_gser(double k, double x) {
  double ap = k, del = 1.0 / k, sum = del;
  for (int n = 0; n < KS_CF_MAXIT; ++n) {
    ap += 1.0;
    del *= x / ap;
    sum += del;
    if (fabs(del) < fabs(sum) * KS_EPS) break;
  }
  return sum * ks_gamma_front(k, x);
}
__device__ inline double ks_gcf(double k, double x) {
  double b = x + 1.0 - k, c = 1.0 / KS_FPMIN, d = 1.0 / b, h = d;
  for (int i = 1; i <= KS_CF_MAXIT; ++i) {
    const double an = -i * (i - k);
    b += 2.0;
    d = an * d + b;
    if (fabs(d) < KS_FPMIN) d = KS_FPMIN;
    c = b + an / c;
    if (fabs(c) < KS_FPMIN) c = KS_FPMIN;
    d = 1.0 / d;
    const double del = d * c;
    h *= del;
    if (fabs(del - 1.0) < KS_EPS) break;
  }
  return ks_gamma_front(k, x) * h;
}
// P(k, x) (upper = 0) or Q(k, x) (upper = 1), scipy's values at the edges
__device__ __noinline__ double ks_gammainc_pq(double k, double x, int upper) {
  if (isnan(k) || isnan(x) || k < 0 || x < 0) return NAN;
  if (k == 0) return x > 0 ? (double)!upper : NAN;
  if (x == 0) return (double)upper;
  if (isinf(k)) return isinf(x) ? NAN : (double)upper;
  if (isinf(x)) return (double)!upper;
  if (x < k + 1.0) {
    const double p = ks_gser(k, x);
    return upper ? 1.0 - p : p;
  }
  const double q = ks_gcf(k, x);
  return upper ? q : 1.0 - q;
}
__device__ inline double ks_gammainc(double k, double x) { return ks_gammainc_pq(k, x, 0); }
__device__ inline double ks_gammaincc(double k, double x) { return ks_gammainc_pq(k, x, 1); }
__device__ __forceinline__ float ks_gammainc(float k, float x) {
  return (float)ks_gammainc_pq((double)k, (double)x, 0);
}
__device__ __forceinline__ float ks_gammaincc(float k, float x) {
  return (float)ks_gammainc_pq((double)k, (double)x, 1);
}
"""

_BETAINC = r"""// regularized incomplete beta: the continued fraction (Lentz), on the
// side of (a + 1) / (a + b + 2) where it converges
__device__ __noinline__ double ks_betacf(double a, double b, double x) {
  const double qab = a + b, qap = a + 1.0, qam = a - 1.0;
  double c = 1.0, d = 1.0 - qab * x / qap;
  if (fabs(d) < KS_FPMIN) d = KS_FPMIN;
  d = 1.0 / d;
  double h = d;
  for (int m = 1; m <= KS_CF_MAXIT; ++m) {
    const double m2 = 2.0 * m;
    double aa = m * (b - m) * x / ((qam + m2) * (a + m2));
    d = 1.0 + aa * d;
    if (fabs(d) < KS_FPMIN) d = KS_FPMIN;
    c = 1.0 + aa / c;
    if (fabs(c) < KS_FPMIN) c = KS_FPMIN;
    d = 1.0 / d;
    h *= d * c;
    aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2));
    d = 1.0 + aa * d;
    if (fabs(d) < KS_FPMIN) d = KS_FPMIN;
    c = 1.0 + aa / c;
    if (fabs(c) < KS_FPMIN) c = KS_FPMIN;
    d = 1.0 / d;
    const double del = d * c;
    h *= del;
    if (fabs(del - 1.0) < KS_EPS) break;
  }
  return h;
}
__device__ __noinline__ double ks_betainc(double a, double b, double x) {
  if (isnan(a) || isnan(b) || isnan(x) || a < 0 || b < 0 || x < 0 || x > 1) return NAN;
  if (a == 0 && b == 0) return NAN;
  if (a == 0) return 1.0;
  if (b == 0) return 0.0;
  if (x == 0) return 0.0;
  if (x == 1) return 1.0;
  if (isinf(a) || isinf(b)) return isinf(a) && isinf(b) ? NAN : isinf(a) ? 0.0 : 1.0;
  const double bt = exp(lgamma(a + b) - lgamma(a) - lgamma(b) + a * log(x) + b * log1p(-x));
  if (x < (a + 1.0) / (a + b + 2.0)) return bt * ks_betacf(a, b, x) / a;
  return 1.0 - bt * ks_betacf(b, a, 1.0 - x) / b;
}
__device__ __forceinline__ float ks_betainc(float a, float b, float x) {
  return (float)ks_betainc((double)a, (double)b, (double)x);
}
"""

_ELEMENTARY = r"""// softplus, log1mexp, logit, xlogy, xlog1py: the JAX package's branches
template <typename T> __device__ __forceinline__ T ks_softplus(T x) {
  return (x > (T)0 ? x : (T)0) + ks_log1p(ks_exp(-(x < (T)0 ? -x : x)));
}
template <typename T> __device__ __forceinline__ T ks_log1mexp(T x) {
  return x > (T)-0.693147180559945 ? ks_log(-ks_expm1(x)) : ks_log1p(-ks_exp(x));
}
template <typename T> __device__ __forceinline__ T ks_logit(T x) {
  return ks_log(x / ((T)1 - x));
}
template <typename T> __device__ __forceinline__ T ks_xlogy(T x, T y) {
  return (x == (T)0 && y == y) ? (T)0 : x * ks_log(y);
}
template <typename T> __device__ __forceinline__ T ks_xlog1py(T x, T y) {
  return (x == (T)0 && y == y) ? (T)0 : x * ks_log1p(y);
}
template <typename T> __device__ __forceinline__ T ks_betaln(T a, T b) {
  return ks_lgamma(a) + ks_lgamma(b) - ks_lgamma(a + b);
}
"""

_IK = r"""// Temme's Gamma1, Gamma2 and 1 / Gamma(1 +- mu), |mu| <= 1/2
__device__ inline void ks_gam12(double mu, double* gam1, double* gam2, double* gampl,
                                double* gammi) {
  const double euler = 0.57721566490153286060651209008240243;
  const double a3 = euler * euler * euler / 6 - euler * KS_PI * KS_PI / 12
                    + 0.4006856343865314;
  *gampl = exp(-lgamma(1.0 + mu));
  *gammi = exp(-lgamma(1.0 - mu));
  *gam1 = fabs(mu) < 1e-2 ? -(euler + a3 * mu * mu) : (*gammi - *gampl) / (2.0 * mu);
  *gam2 = 0.5 * (*gammi + *gampl);
}
__device__ inline double ks_sinc_pi(double z) {
  return fabs(z) < 1e-7 ? 1.0 : sin(KS_PI * z) / (KS_PI * z);
}
__device__ inline double ks_sinhc(double e) { return fabs(e) < 1e-7 ? 1.0 : sinh(e) / e; }
// (I_v e^-x, K_v e^x) for v >= 0, 0 < x <= the asymptotic gate (_ik_core)
__device__ __noinline__ void ks_ik_core(double v, double x, double* ive, double* kve) {
  const double nl = floor(v + 0.5), mu = v - nl, mu2 = mu * mu, xi = 1.0 / x, xi2 = 2.0 * xi;
  // CF1 (Lentz): h = I_{v+1} / I_v, ~x iterations
  double h = fmax(v * xi, KS_FPMIN), b = xi2 * v, d = 0.0, c = h;
  for (int i = 0; i < KS_CF_MAXIT; ++i) {
    b += xi2;
    d = 1.0 / (b + d);
    c = b + 1.0 / c;
    const double del = c * d;
    h *= del;
    if (fabs(del - 1.0) < KS_EPS) break;
  }
  // downward recurrence from v to mu, renormalised when it grows
  const double big = 1.3407807929942596e150;  // sqrt(DBL_MAX) * 1e-4
  double ril = KS_FPMIN, ripl = h * ril, fact = v * xi, ril1 = ril;
  for (double l = 0; l < nl; l += 1.0) {
    const double ritemp = fact * ril + ripl;
    fact -= xi;
    ripl = fact * ritemp + ril;
    ril = ritemp;
    if (fabs(ril) > big) { ril /= big; ripl /= big; ril1 /= big; }
  }
  const double f = ripl / ril;
  double rkmu, rk1;
  if (x < %(xser)r) {
    // Temme's series for K_mu, K_{mu+1}
    const double x2 = 0.5 * x, dlog = -log(x2), e = mu * dlog;
    double gam1, gam2, gampl, gammi;
    ks_gam12(mu, &gam1, &gam2, &gampl, &gammi);
    double ff = (1.0 / ks_sinc_pi(mu)) * (gam1 * cosh(e) + gam2 * ks_sinhc(e) * dlog);
    const double ee = exp(e);
    double p = 0.5 * ee / gampl, q = 0.5 / (ee * gammi), cc = 1.0;
    const double dser = x2 * x2;
    double s0 = ff, s1 = p;
    for (int i = 0; i < KS_CF_MAXIT; ++i) {
      const double k = i + 1.0;
      ff = (k * ff + p + q) / (k * k - mu2);
      cc *= dser / k;
      p /= k - mu;
      q /= k + mu;
      const double del = cc * ff;
      s0 += del;
      s1 += cc * (p - k * ff);
      if (fabs(del) < fabs(s0) * KS_EPS) break;
    }
    rkmu = s0 * exp(x);
    rk1 = s1 * (2.0 / x) * exp(x);
  } else {
    // Steed's CF2, naturally scaled by e^x
    const double a1 = 0.25 - mu2;
    double bb = 2.0 * (1.0 + x), dd = 1.0 / bb, hh = dd, delh = dd, q1 = 0.0, q2 = 1.0;
    double q = a1, cc = a1, a = -a1, s = 1.0 + q * delh;
    for (int i = 0; i < KS_CF_MAXIT; ++i) {
      const double k = i + 2.0;
      a -= 2.0 * (k - 1.0);
      cc = -a * cc / k;
      const double qnew = (q1 - bb * q2) / a;
      q1 = q2;
      q2 = qnew;
      q += cc * qnew;
      bb += 2.0;
      dd = 1.0 / (bb + a * dd);
      delh = (bb * dd - 1.0) * delh;
      hh += delh;
      const double dels = q * delh;
      s += dels;
      if (fabs(dels) < KS_EPS * fabs(s)) break;
    }
    rkmu = sqrt(KS_PI / (2.0 * x)) / s;
    rk1 = rkmu * (mu + x + 0.5 - a1 * hh) / x;
  }
  // the Wronskian gives I_mu; the upward recurrence K_v
  const double rkmup = mu * xi * rkmu - rk1;
  *ive = xi / (f * rkmu - rkmup) * (ril1 / ril);
  double rkm = rkmu;
  for (double l = 0; l < nl; l += 1.0) {
    const double rktemp = (mu + l + 1.0) * xi2 * rk1 + rkm;
    rkm = rk1;
    rk1 = rktemp;
  }
  *kve = rkm;
}
// the scaled asymptotic expansions, x >> v^2 (_ik_asym)
__device__ inline void ks_ik_asym(double v, double x, double* ive, double* kve) {
  const double mu4 = 4.0 * v * v;
  double tI = 1.0, tK = 1.0, sI = 1.0, sK = 1.0;
  for (int i = 0; i < %(terms)d; ++i) {
    const double k = i + 1.0;
    const double fac = (mu4 - (2.0 * k - 1.0) * (2.0 * k - 1.0)) / (8.0 * k * x);
    tI *= -fac;
    tK *= fac;
    sI += tI;
    sK += tK;
  }
  *ive = sI / sqrt(2.0 * KS_PI * x);
  *kve = sK * sqrt(KS_PI / (2.0 * x));
}
// (ive, kve) for v >= 0, x > 0
__device__ inline void ks_ik_pos(double v, double x, double* ive, double* kve) {
  const double gate = fmax(%(xasym)r, 3.0 * v * v);
  if (x > gate) ks_ik_asym(v, x, ive, kve);
  else ks_ik_core(v, fmin(fmax(x, 2e-30), gate), ive, kve);
}
// K_v(x) e^x: K_{-v} = K_v; inf at x = 0, NaN below
__device__ __noinline__ double ks_kve(double v, double x) {
  if (isnan(v) || isnan(x)) return v + x;
  if (x < 0) return NAN;
  if (x == 0) return KS_INF;
  if (isinf(v) || isinf(x)) return NAN;
  double i_, k_;
  ks_ik_pos(fabs(v), x, &i_, &k_);
  return k_;
}
__device__ __forceinline__ float ks_kve(float v, float x) { return (float)ks_kve((double)v, (double)x); }
__device__ inline double ks_kv(double v, double x) {
  return x == KS_INF && !isnan(v) ? 0.0 : ks_kve(v, x) * exp(-x);
}
__device__ __forceinline__ float ks_kv(float v, float x) { return (float)ks_kv((double)v, (double)x); }
// I_v(x) e^-|x|: I_{-v} = I_v + (2/pi) sin(pi v) K_v; for x < 0, integer
// v by parity, NaN otherwise
__device__ __noinline__ double ks_ive(double v, double x) {
  if (isnan(v) || isnan(x)) return v + x;
  const bool vint = v == rint(v);
  if (isinf(v) || isinf(x)) return NAN;
  if (x == 0) return v == 0 ? 1.0 : 0.0;
  if (x < 0 && !vint) return NAN;
  const double ax = fmax(fabs(x), 2e-30), av = fabs(v);
  double ive, kve;
  ks_ik_pos(av, ax, &ive, &kve);
  if (v < 0 && !vint) ive += (2.0 / KS_PI) * ks_sinpi(av) * kve * exp(-2.0 * ax);
  return x < 0 && fmod(rint(v), 2.0) != 0 ? -ive : ive;
}
__device__ __forceinline__ float ks_ive(float v, float x) { return (float)ks_ive((double)v, (double)x); }
__device__ inline double ks_iv(double v, double x) { return ks_ive(v, x) * exp(fabs(x)); }
__device__ __forceinline__ float ks_iv(float v, float x) { return (float)ks_iv((double)v, (double)x); }
""" % {"xser": X_SERIES, "xasym": X_ASYM, "terms": ASYM_TERMS}

_JY = r"""// (J_v, Y_v) for v >= 0, 0 < x <= the asymptotic gate (_jy_core)
__device__ __noinline__ void ks_jy_core(double v, double x, double* jv, double* yv) {
  const bool ser = x < %(xser)r;
  const double nl = ser ? floor(v + 0.5) : fmax(0.0, floor(v - x + 1.5));
  const double mu = v - nl, mu2 = mu * mu, xi = 1.0 / x, xi2 = 2.0 * xi, w = xi2 / KS_PI;
  // CF1 with sign tracking: h = J_{v+1} / J_v
  double h = fmax(v * xi, KS_FPMIN), b = xi2 * v, d = 0.0, c = h, isign = 1.0;
  for (int i = 0; i < KS_CF_MAXIT; ++i) {
    b += xi2;
    d = b - d;
    if (fabs(d) < KS_FPMIN) d = KS_FPMIN;
    c = b - 1.0 / c;
    if (fabs(c) < KS_FPMIN) c = KS_FPMIN;
    d = 1.0 / d;
    if (d < 0) isign = -isign;
    const double del = c * d;
    h *= del;
    if (fabs(del - 1.0) < KS_EPS) break;
  }
  const double big = 1.3407807929942596e150;
  double rjl = isign * KS_FPMIN, rjpl = h * rjl, fact = v * xi, rjl1 = rjl;
  for (double l = 0; l < nl; l += 1.0) {
    const double rjtemp = fact * rjl + rjpl;
    fact -= xi;
    rjpl = fact * rjtemp - rjl;
    rjl = rjtemp;
    if (fabs(rjl) > big) { rjl /= big; rjpl /= big; rjl1 /= big; }
  }
  const double f = rjpl / rjl;
  double rjmu, rymu, ry1;
  if (ser) {
    // Temme's series for Y_mu, Y_{mu+1}
    const double x2 = 0.5 * x, pimu = KS_PI * mu, dlog = -log(x2), e = mu * dlog;
    double gam1, gam2, gampl, gammi;
    ks_gam12(mu, &gam1, &gam2, &gampl, &gammi);
    double ff = (2.0 / KS_PI) * (1.0 / ks_sinc_pi(mu)) * (gam1 * cosh(e) + gam2 * ks_sinhc(e) * dlog);
    const double ee = exp(e);
    double p = ee / (gampl * KS_PI), q = 1.0 / (ee * KS_PI * gammi);
    const double fact3 = ks_sinc_pi(0.5 * mu), r = KS_PI * (0.5 * pimu) * fact3 * fact3;
    double cc = 1.0, s0 = ff + r * q, s1 = p;
    const double dser = -x2 * x2;
    for (int i = 0; i < KS_CF_MAXIT; ++i) {
      const double k = i + 1.0;
      ff = (k * ff + p + q) / (k * k - mu2);
      cc *= dser / k;
      p /= k - mu;
      q /= k + mu;
      const double del = cc * (ff + r * q);
      s0 += del;
      s1 += cc * p - k * del;
      if (fabs(del) < (1.0 + fabs(s0)) * KS_EPS) break;
    }
    rymu = -s0;
    ry1 = -s1 * (2.0 * xi);
    const double rymup = mu * xi * rymu - ry1;
    rjmu = w / (rymup - f * rymu);
  } else {
    // Steed's complex CF2 for p + i q
    double a = 0.25 - mu2, p = -0.5 * xi, q = 1.0;
    const double br = 2.0 * x;
    double bi = 2.0;
    double fct = a * xi / (p * p + q * q);
    double cr = br + q * fct, ci = bi + p * fct;
    double den = br * br + bi * bi, dr = br / den, di = -bi / den;
    double dlr = cr * dr - ci * di, dli = cr * di + ci * dr;
    double temp = p * dlr - q * dli;
    q = p * dli + q * dlr;
    p = temp;
    for (int i = 0; i < KS_CF_MAXIT; ++i) {
      const double k = i + 2.0;
      a += 2.0 * (k - 1.0);
      bi += 2.0;
      dr = a * dr + br;
      di = a * di + bi;
      if (fabs(dr) + fabs(di) < KS_FPMIN) dr = KS_FPMIN;
      fct = a / (cr * cr + ci * ci);
      cr = br + cr * fct;
      ci = bi - ci * fct;
      if (fabs(cr) + fabs(ci) < KS_FPMIN) cr = KS_FPMIN;
      den = dr * dr + di * di;
      dr /= den;
      di = -di / den;
      dlr = cr * dr - ci * di;
      dli = cr * di + ci * dr;
      temp = p * dlr - q * dli;
      q = p * dli + q * dlr;
      p = temp;
      if (fabs(dlr - 1.0) + fabs(dli) < KS_EPS) break;
    }
    const double gam = (p - f) / q;
    rjmu = fabs(sqrt(w / ((p - f) * gam + q)));
    if (rjl < 0) rjmu = -rjmu;
    rymu = rjmu * gam;
    const double rymup = rymu * (p + q / gam);
    ry1 = mu * xi * rymu - rymup;
  }
  *jv = rjmu * (rjl1 / rjl);
  double rym = rymu;
  for (double l = 0; l < nl; l += 1.0) {
    const double rytemp = (mu + l + 1.0) * xi2 * ry1 - rym;
    rym = ry1;
    ry1 = rytemp;
  }
  *yv = rym;
}
// Hankel's asymptotic expansion (_jy_asym)
__device__ inline void ks_jy_asym(double v, double x, double* jv, double* yv) {
  const double mu4 = 4.0 * v * v, z8 = 8.0 * x;
  double t = 1.0, P = 1.0, Q = 0.0;
  for (int i = 0; i < %(terms)d; ++i) {
    const double m = i + 1.0;
    t *= (mu4 - (2.0 * m - 1.0) * (2.0 * m - 1.0)) / (m * z8);
    if (i %% 2 == 0) Q += i %% 4 == 0 ? t : -t;
    else P += (i + 1) %% 4 == 2 ? -t : t;
  }
  const double chi = x - (0.5 * v + 0.25) * KS_PI, amp = sqrt(2.0 / (KS_PI * x));
  *jv = amp * (P * cos(chi) - Q * sin(chi));
  *yv = amp * (P * sin(chi) + Q * cos(chi));
}
__device__ inline void ks_jy_pos(double v, double x, double* jv, double* yv) {
  const double gate = fmax(%(xasym)r, 3.0 * v * v);
  if (x > gate) ks_jy_asym(v, x, jv, yv);
  else ks_jy_core(v, fmin(fmax(x, 1e-30), gate), jv, yv);
}
// J_v(x): J_{-v} = cos(pi v) J_v - sin(pi v) Y_v, (-1)^n J_n for integer
// order; for x < 0, integer v by parity, NaN otherwise
__device__ __noinline__ double ks_jv(double v, double x) {
  if (isnan(v) || isnan(x)) return v + x;
  if (isinf(v)) return 0.0;
  const bool vint = v == rint(v);
  if (x == 0) return v == 0 ? 1.0 : (v > 0 || vint) ? 0.0 : KS_INF;
  if (isinf(x)) return NAN;
  if (x < 0 && !vint) return NAN;
  const double av = fabs(v);
  double jp, yp;
  ks_jy_pos(av, fmax(fabs(x), 1e-30), &jp, &yp);
  double out = jp;
  if (v < 0) out = vint ? (fmod(rint(av), 2.0) == 0 ? jp : -jp)
                        : ks_cospi(av) * jp - ks_sinpi(av) * yp;
  return x < 0 && fmod(rint(v), 2.0) != 0 ? -out : out;
}
__device__ __forceinline__ float ks_jv(float v, float x) { return (float)ks_jv((double)v, (double)x); }
// Y_v(x): Y_{-v} = sin(pi v) J_v + cos(pi v) Y_v; -inf at 0, NaN below
__device__ __noinline__ double ks_yv(double v, double x) {
  if (isnan(v) || isnan(x)) return v + x;
  if (isinf(v) || isinf(x) || x < 0) return NAN;
  if (x == 0) return -KS_INF;
  const double av = fabs(v);
  double jp, yp;
  ks_jy_pos(av, fmax(x, 1e-30), &jp, &yp);
  if (v >= 0) return yp;
  if (v == rint(v)) return fmod(rint(av), 2.0) == 0 ? yp : -yp;
  return ks_sinpi(av) * jp + ks_cospi(av) * yp;
}
__device__ __forceinline__ float ks_yv(float v, float x) { return (float)ks_yv((double)v, (double)x); }
""" % {"xser": X_SERIES, "xasym": X_ASYM, "terms": ASYM_TERMS}

# name -> source; a source's place in this order puts it after what it calls
HELPERS = {
    "ks_base": _BASE,
    "ks_psi": _DIGAMMA,
    "ks_trigamma": _TRIGAMMA,
    "ks_zeta": _ZETA,
    "ks_polygamma": _POLYGAMMA,
    "ks_gammainc": _GAMMAINC,
    "ks_betainc": _BETAINC,
    "ks_softplus": _ELEMENTARY,
    "ks_kve": _IK,
    "ks_jv": _JY,
}
# the other helpers each one calls
NEEDS = {
    "ks_psi": ("ks_base",),
    "ks_trigamma": ("ks_base",),
    "ks_zeta": ("ks_base",),
    "ks_polygamma": ("ks_base", "ks_psi", "ks_zeta"),
    "ks_gammainc": ("ks_base",),
    "ks_betainc": ("ks_base",),
    "ks_softplus": ("ks_base",),
    "ks_kve": ("ks_base",),
    "ks_jv": ("ks_base", "ks_kve"),
}
# the entry points each helper defines, by which an expression calls it
ENTRIES = {
    "ks_psi": ("ks_psi",), "ks_trigamma": ("ks_trigamma",), "ks_zeta": ("ks_zeta",),
    "ks_polygamma": ("ks_polygamma",),
    "ks_gammainc": ("ks_gammainc", "ks_gammaincc"),
    "ks_betainc": ("ks_betainc",),
    "ks_softplus": ("ks_softplus", "ks_log1mexp", "ks_logit", "ks_xlogy", "ks_xlog1py",
                    "ks_betaln"),
    "ks_kve": ("ks_kve", "ks_kv", "ks_ive", "ks_iv"),
    "ks_jv": ("ks_jv", "ks_yv"),
    "ks_base": ("ks_lgamma", "ks_tgamma", "ks_exp", "ks_log", "ks_log1p", "ks_expm1"),
}


def _lib(f32, f64):
    """A CUDA math-library function: its ``f`` form in float32."""
    return lambda a, t: f"{f32 if t == 'float32' else f64}({', '.join(a)})"


def _call(name):
    return lambda a, t: f"{name}({', '.join(a)})"


def _cast(t):
    return "float" if t == "float32" else "double"


def _nan_at_inf(f32, f64):
    """A math-library function, NaN at an infinite argument (scipy's)."""
    return lambda a, t: (f"(isinf({a[0]}) ? ({_cast(t)})NAN : "
                         f"{f32 if t == 'float32' else f64}({a[0]}))")


# scalar op name -> C++ expression over operands in their compute dtype
CEXPR = {
    "erf": _lib("erff", "erf"),
    "erfc": _lib("erfcf", "erfc"),
    "erfinv": _lib("erfinvf", "erfinv"),
    "erfcinv": _lib("erfcinvf", "erfcinv"),
    "erfcx": _lib("erfcxf", "erfcx"),
    "gamma": _lib("tgammaf", "tgamma"),
    "gammaln": _lib("lgammaf", "lgamma"),
    "psi": _call("ks_psi"),
    "tri_gamma": _call("ks_trigamma"),
    "polygamma": _call("ks_polygamma"),
    "gammainc": _call("ks_gammainc"),
    "gammaincc": _call("ks_gammaincc"),
    "gammau": lambda a, t: f"(ks_gammaincc({a[0]}, {a[1]}) * ks_tgamma({a[0]}))",
    "gammal": lambda a, t: f"(ks_gammainc({a[0]}, {a[1]}) * ks_tgamma({a[0]}))",
    "betainc": _call("ks_betainc"),
    "betaln": _call("ks_betaln"),
    "softplus": _call("ks_softplus"),
    "log1mexp": _call("ks_log1mexp"),
    "logit": _call("ks_logit"),
    "xlogy": _call("ks_xlogy"),
    "xlog1py": _call("ks_xlog1py"),
    "iv": _call("ks_iv"),
    "ive": _call("ks_ive"),
    "jv": _call("ks_jv"),
    "yv": _call("ks_yv"),
    "kve": _call("ks_kve"),
    "kv": _call("ks_kv"),
    # scipy's i0, i1, j0 and j1 are NaN at +-inf
    "i0": _nan_at_inf("cyl_bessel_i0f", "cyl_bessel_i0"),
    "i1": _nan_at_inf("cyl_bessel_i1f", "cyl_bessel_i1"),
    "j0": _nan_at_inf("j0f", "j0"),
    "j1": _nan_at_inf("j1f", "j1"),
    "ndtr": _lib("normcdff", "normcdf"),
    "ndtri": _lib("normcdfinvf", "normcdfinv"),
    "ndtri_exp": lambda a, t: (f"{'normcdfinvf(expf' if t == 'float32' else 'normcdfinv(exp'}"
                               f"({a[0]}))"),
    # chi2sf(x, k) = Q(k / 2, x / 2)
    "chi2sf": lambda a, t: (f"ks_gammaincc(({_cast(t)})0.5 * {a[1]}, "
                            f"({_cast(t)})0.5 * {a[0]})"),
}

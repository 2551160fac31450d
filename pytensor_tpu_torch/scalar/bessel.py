"""Bessel functions in torch ops: the plain version of K1's device functions.

Counterpart of ``pytensor_tpu/scalar/bessel.py``, the JAX package's own
algorithms (Numerical Recipes 6.7, Temme 1975), kept here as the port
needs them and written against torch:

- ``I_v``/``K_v`` (``:99 _ik_core``): the Lentz fraction for
  I_{v+1}/I_v, the downward recurrence to mu in [-1/2, 1/2], Temme's
  series for K_mu below x = 2 or Steed's fraction above, the Wronskian
  and the upward recurrence for K; the scaled asymptotic expansions above
  max(90, 3 v^2) (``:255 _ik_asym``);
- ``J_v``/``Y_v`` (``:366 _jy_core``, ``:552 _jy_asym``) on the same
  skeleton, with the complex fraction;
- scipy's contracts at x <= 0 and for negative order (``:297-360``).

Every function works in float64 on any device and the caller rounds the
result, as the device functions of ``link/cuda/special.py`` do.  Each
fraction and series runs until every element has converged (or
``CF_MAXIT``), as ``_while_converge`` (``:58``); an element that has
converged keeps its state.  The loops test convergence on the host, so
this version is for the CPU and for comparisons: K1 runs these functions
on the card.
"""

from __future__ import annotations

import math

import torch

from pytensor_tpu_torch.link.cuda.special import ASYM_TERMS, CF_MAXIT, X_ASYM, X_SERIES

_EULER = 0.57721566490153286060651209008240243
# x^3 coefficient of 1/Gamma(1+x)
_A3 = _EULER ** 3 / 6 - _EULER * math.pi ** 2 / 12 + 0.4006856343865314
_EPS = torch.finfo(torch.float64).eps
_FPMIN = torch.finfo(torch.float64).tiny / _EPS
_BIG = math.sqrt(torch.finfo(torch.float64).max) * 1e-4


def _converge(body, state, done):
    """Run ``body(state, live) -> (state, converged)`` until every element
    has converged or ``CF_MAXIT``; converged elements keep their state."""
    for _ in range(CF_MAXIT):
        if bool(done.all()):
            break
        new, conv = body(state, ~done)
        state = [torch.where(done, old, n) for old, n in zip(state, new)]
        done = done | conv
    return state


def _recur(nl, body, state):
    """``nl`` steps of a recurrence, each element its own count."""
    for i in range(int(nl.max()) if nl.numel() else 0):
        live = i < nl
        new = body(state, i)
        state = [torch.where(live, n, old) for old, n in zip(state, new)]
    return state


def _gam12(mu):
    gampl = torch.exp(-torch.lgamma(1.0 + mu))
    gammi = torch.exp(-torch.lgamma(1.0 - mu))
    small = mu.abs() < 1e-2
    gam1 = torch.where(small, -(_EULER + _A3 * mu * mu),
                       (gammi - gampl) / (2.0 * torch.where(small, 1.0, mu)))
    return gam1, 0.5 * (gammi + gampl), gampl, gammi


def _sinc_pi(z):
    small = z.abs() < 1e-7
    zs = torch.where(small, 1.0, z)
    return torch.where(small, 1.0, torch.sin(math.pi * zs) / (math.pi * zs))


def _sinhc(e):
    small = e.abs() < 1e-7
    es = torch.where(small, 1.0, e)
    return torch.where(small, 1.0, torch.sinh(es) / es)


def _sinpi(x):
    """sin(pi x) with x reduced exactly first (``ks_sinpi``)."""
    n = torch.round(2.0 * x)
    f = x - 0.5 * n
    q = torch.remainder(n, 4.0)
    s, c = torch.sin(math.pi * f), torch.cos(math.pi * f)
    return torch.where(q == 0, s, torch.where(q == 1, c, torch.where(q == 2, -s, -c)))


def _cospi(x):
    return _sinpi(x + 0.5)


def _odd(v):
    """An integer order is odd."""
    return torch.remainder(torch.round(v), 2.0) != 0


def _ik_core(v, x):
    """(I_v e^-x, K_v e^x) for v >= 0, 0 < x <= the asymptotic gate."""
    nl = torch.floor(v + 0.5)
    mu = v - nl
    mu2 = mu * mu
    xi = 1.0 / x
    xi2 = 2.0 * xi
    h0 = torch.clamp(v * xi, min=_FPMIN)

    def cf1(st, live):
        b, c, d, h = st
        b = b + xi2
        d = 1.0 / (b + d)
        c = b + 1.0 / c
        delt = c * d
        return [b, c, d, h * delt], (delt - 1.0).abs() < _EPS

    zero = torch.zeros_like(x)
    _, _, _, h = _converge(cf1, [xi2 * v, h0, zero, h0], torch.zeros_like(x, dtype=torch.bool))

    def down(st, i):
        ril, ripl, fact, ril1 = st
        ritemp = fact * ril + ripl
        fact = fact - xi
        ripl = fact * ritemp + ril
        scale = torch.where(ritemp.abs() > _BIG, 1.0 / _BIG, 1.0)
        return [ritemp * scale, ripl * scale, fact, ril1 * scale]

    ril0 = torch.full_like(x, _FPMIN)
    ril, ripl, _, ril1 = _recur(nl, down, [ril0, h * ril0, v * xi, ril0])
    f = ripl / ril

    # Temme's series (x < 2), on x clamped into its window
    use_ser = x < X_SERIES
    xs = torch.clamp(x, max=X_SERIES)
    x2 = 0.5 * xs
    d_log = -torch.log(x2)
    e = mu * d_log
    gam1, gam2, gampl, gammi = _gam12(mu)
    ff0 = (1.0 / _sinc_pi(mu)) * (gam1 * torch.cosh(e) + gam2 * _sinhc(e) * d_log)
    ee = torch.exp(e)
    dser = x2 * x2

    def ser(st, live):
        k, ffi, p, q, c, s0, s1 = st
        k = k + 1.0
        ffi = (k * ffi + p + q) / (k * k - mu2)
        c = c * dser / k
        p = p / (k - mu)
        q = q / (k + mu)
        dl = c * ffi
        s0 = s0 + dl
        s1 = s1 + c * (p - k * ffi)
        return [k, ffi, p, q, c, s0, s1], (dl.abs() < s0.abs() * _EPS) | ~use_ser

    p0 = 0.5 * ee / gampl
    st = _converge(ser, [zero, ff0, p0, 0.5 / (ee * gammi), torch.ones_like(x), ff0, p0],
                   ~use_ser)
    rkmu_ser = st[5] * torch.exp(xs)
    rk1_ser = st[6] * (2.0 / xs) * torch.exp(xs)

    # Steed's CF2 (x >= 2)
    xc = torch.clamp(x, min=X_SERIES)
    a1 = 0.25 - mu2

    def cf2(st, live):
        k, b, c, d, h, delh, q1, q2, q, a, s = st
        k = k + 1.0
        a = a - 2.0 * (k - 1.0)
        c = -a * c / k
        qnew = (q1 - b * q2) / a
        q = q + c * qnew
        b = b + 2.0
        d = 1.0 / (b + a * d)
        delh = (b * d - 1.0) * delh
        h = h + delh
        dels = q * delh
        s = s + dels
        return [k, b, c, d, h, delh, q2, qnew, q, a, s], (dels.abs() < _EPS * s.abs()) | use_ser

    b0 = 2.0 * (1.0 + xc)
    d0 = 1.0 / b0
    st = _converge(cf2, [torch.ones_like(x), b0, a1, d0, d0, d0, zero, torch.ones_like(x), a1,
                         -a1, 1.0 + a1 * d0], use_ser)
    rkmu_cf = torch.sqrt(math.pi / (2.0 * xc)) / st[10]
    rk1_cf = rkmu_cf * (mu + xc + 0.5 - a1 * st[4]) / xc

    rkmu = torch.where(use_ser, rkmu_ser, rkmu_cf)
    rk1 = torch.where(use_ser, rk1_ser, rk1_cf)
    rkmup = mu * xi * rkmu - rk1
    ive = xi / (f * rkmu - rkmup) * (ril1 / ril)

    def up(st, i):
        rkm, rk = st
        return [rk, (mu + i + 1.0) * xi2 * rk + rkm]

    kve, _ = _recur(nl, up, [rkmu, rk1])
    return ive, kve


def _ik_asym(v, x):
    mu4 = 4.0 * v * v
    tI = tK = sI = sK = torch.ones_like(x)
    for i in range(ASYM_TERMS):
        k = i + 1.0
        fac = (mu4 - (2.0 * k - 1.0) ** 2) / (8.0 * k * x)
        tI = tI * -fac
        tK = tK * fac
        sI, sK = sI + tI, sK + tK
    return sI / torch.sqrt(2.0 * math.pi * x), sK * torch.sqrt(math.pi / (2.0 * x))


def _ik_pos(v, x):
    """(ive, kve) for v >= 0, x > 0."""
    gate = torch.clamp(3.0 * v * v, min=X_ASYM)
    big = x > gate
    ive_c, kve_c = _ik_core(v, torch.minimum(torch.clamp(x, min=2e-30), gate))
    ive_a, kve_a = _ik_asym(v, torch.maximum(x, gate))
    return torch.where(big, ive_a, ive_c), torch.where(big, kve_a, kve_c)


def _finite(v, x):
    """The elements where both are finite, and their values made safe."""
    ok = torch.isfinite(v) & torch.isfinite(x)
    return ok, torch.where(ok, v, 0.0), torch.where(ok, x, 1.0)


def kve(v, x):
    """K_v(x) e^x; inf at x = 0, NaN below, NaN at an infinite operand."""
    ok, vs, xs = _finite(v, x)
    _, k = _ik_pos(vs.abs(), torch.clamp(xs.abs(), min=2e-30))
    out = torch.where(ok, k, math.nan)
    out = torch.where(x < 0, math.nan, torch.where(x == 0, math.inf, out))
    return torch.where(v.isnan() | x.isnan(), math.nan, out)


def kv(v, x):
    return torch.where((x == math.inf) & ~v.isnan(), 0.0, kve(v, x) * torch.exp(-x))


def ive(v, x):
    """I_v(x) e^-|x|: I_{-v} = I_v + (2/pi) sin(pi v) K_v; x < 0 by parity
    for an integer order, NaN otherwise; at x = 0, 1 for v = 0, else 0."""
    ok, vs, xs = _finite(v, x)
    vint = vs == torch.round(vs)
    ax = torch.clamp(xs.abs(), min=2e-30)
    av = vs.abs()
    i, k = _ik_pos(av, ax)
    i = torch.where((vs < 0) & ~vint, i + (2.0 / math.pi) * _sinpi(av) * k * torch.exp(-2.0 * ax), i)
    i = torch.where((xs < 0) & _odd(vs), -i, i)
    out = torch.where(xs == 0, torch.where(vs == 0, 1.0, 0.0),
                      torch.where((xs < 0) & ~vint, math.nan, i))
    return torch.where(ok, out, math.nan)


def iv(v, x):
    return ive(v, x) * torch.exp(x.abs())


def _jy_core(v, x):
    """(J_v, Y_v) for v >= 0, 0 < x <= the asymptotic gate."""
    is_ser = x < X_SERIES
    nl = torch.where(is_ser, torch.floor(v + 0.5), torch.clamp(torch.floor(v - x + 1.5), min=0.0))
    mu = v - nl
    mu2 = mu * mu
    xi = 1.0 / x
    xi2 = 2.0 * xi
    w = xi2 / math.pi
    h0 = torch.clamp(v * xi, min=_FPMIN)
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)

    def guard(t):
        return torch.where(t.abs() < _FPMIN, _FPMIN, t)

    def cf1(st, live):
        b, c, d, h, isign = st
        b = b + xi2
        d = 1.0 / guard(b - d)
        c = guard(b - 1.0 / c)
        isign = torch.where(d < 0, -isign, isign)
        delt = c * d
        return [b, c, d, h * delt, isign], (delt - 1.0).abs() < _EPS

    _, _, _, h, isign = _converge(cf1, [xi2 * v, h0, zero, h0, one],
                                  torch.zeros_like(x, dtype=torch.bool))

    def down(st, i):
        rjl, rjpl, fact, rjl1 = st
        rjtemp = fact * rjl + rjpl
        fact = fact - xi
        rjpl = fact * rjtemp - rjl
        scale = torch.where(rjtemp.abs() > _BIG, 1.0 / _BIG, 1.0)
        return [rjtemp * scale, rjpl * scale, fact, rjl1 * scale]

    rjl0 = isign * _FPMIN
    rjl, rjpl, _, rjl1 = _recur(nl, down, [rjl0, h * rjl0, v * xi, rjl0])
    f = rjpl / rjl

    # Temme's series (x < 2)
    xs = torch.clamp(x, max=X_SERIES)
    x2 = 0.5 * xs
    d_log = -torch.log(x2)
    e = mu * d_log
    gam1, gam2, gampl, gammi = _gam12(mu)
    ff0 = (2.0 / math.pi) * (1.0 / _sinc_pi(mu)) * (gam1 * torch.cosh(e)
                                                     + gam2 * _sinhc(e) * d_log)
    ee = torch.exp(e)
    fact3 = _sinc_pi(0.5 * mu)
    r = math.pi * (0.5 * math.pi * mu) * fact3 * fact3
    dser = -x2 * x2

    def ser(st, live):
        k, ffi, p, q, c, s0, s1 = st
        k = k + 1.0
        ffi = (k * ffi + p + q) / (k * k - mu2)
        c = c * dser / k
        p = p / (k - mu)
        q = q / (k + mu)
        dl = c * (ffi + r * q)
        return ([k, ffi, p, q, c, s0 + dl, s1 + c * p - k * dl],
                (dl.abs() < (1.0 + (s0 + dl).abs()) * _EPS) | ~is_ser)

    p0 = ee / (gampl * math.pi)
    q0 = 1.0 / (ee * math.pi * gammi)
    st = _converge(ser, [zero, ff0, p0, q0, one, ff0 + r * q0, p0], ~is_ser)
    rymu_s = -st[5]
    ry1_s = -st[6] * (2.0 / xs)
    rymup_s = mu * (1.0 / xs) * rymu_s - ry1_s
    rjmu_s = w / (rymup_s - f * rymu_s)

    # Steed's complex fraction (x >= 2)
    xc = torch.clamp(x, min=X_SERIES)
    xic = 1.0 / xc
    a0 = 0.25 - mu2
    pp, qq = -0.5 * xic, one
    br = 2.0 * xc
    bi = torch.full_like(x, 2.0)
    fct = a0 * xic / (pp * pp + qq * qq)
    cr, ci = br + qq * fct, bi + pp * fct
    den = br * br + bi * bi
    dr, di = br / den, -bi / den
    dlr, dli = cr * dr - ci * di, cr * di + ci * dr
    pp, qq = pp * dlr - qq * dli, pp * dli + qq * dlr

    def cf2(st, live):
        k, pp, qq, bi, cr, ci, dr, di, a = st
        k = k + 1.0
        a = a + 2.0 * (k - 1.0)
        bi = bi + 2.0
        dr = a * dr + br
        di = a * di + bi
        dr = torch.where(dr.abs() + di.abs() < _FPMIN, _FPMIN, dr)
        fct = a / (cr * cr + ci * ci)
        cr = br + cr * fct
        ci = bi - ci * fct
        cr = torch.where(cr.abs() + ci.abs() < _FPMIN, _FPMIN, cr)
        den = dr * dr + di * di
        dr, di = dr / den, -di / den
        dlr, dli = cr * dr - ci * di, cr * di + ci * dr
        return ([k, pp * dlr - qq * dli, pp * dli + qq * dlr, bi, cr, ci, dr, di, a],
                ((dlr - 1.0).abs() + dli.abs() < _EPS) | is_ser)

    st = _converge(cf2, [one, pp, qq, bi, cr, ci, dr, di, a0.expand_as(x).clone()], is_ser)
    pp, qq = st[1], st[2]
    gam = (pp - f) / qq
    rjmu_c = torch.sqrt(w / ((pp - f) * gam + qq)).abs()
    rjmu_c = torch.where(rjl < 0, -rjmu_c, rjmu_c)
    rymu_c = rjmu_c * gam
    ry1_c = mu * xic * rymu_c - rymu_c * (pp + qq / gam)

    rjmu = torch.where(is_ser, rjmu_s, rjmu_c)
    rymu = torch.where(is_ser, rymu_s, rymu_c)
    ry1 = torch.where(is_ser, ry1_s, ry1_c)

    def up(st, i):
        rym, ry = st
        return [ry, (mu + i + 1.0) * xi2 * ry - rym]

    yv, _ = _recur(nl, up, [rymu, ry1])
    return rjmu * (rjl1 / rjl), yv


def _jy_asym(v, x):
    mu4 = 4.0 * v * v
    z8 = 8.0 * x
    t, P, Q = torch.ones_like(x), torch.ones_like(x), torch.zeros_like(x)
    for i in range(ASYM_TERMS):
        m = i + 1.0
        t = t * (mu4 - (2.0 * m - 1.0) ** 2) / (m * z8)
        if i % 2 == 0:
            Q = Q + (t if i % 4 == 0 else -t)
        else:
            P = P + (-t if (i + 1) % 4 == 2 else t)
    chi = x - (0.5 * v + 0.25) * math.pi
    amp = torch.sqrt(2.0 / (math.pi * x))
    return amp * (P * torch.cos(chi) - Q * torch.sin(chi)), amp * (P * torch.sin(chi)
                                                                  + Q * torch.cos(chi))


def _jy_pos(v, x):
    gate = torch.clamp(3.0 * v * v, min=X_ASYM)
    big = x > gate
    jc, yc = _jy_core(v, torch.minimum(torch.clamp(x, min=1e-30), gate))
    ja, ya = _jy_asym(v, torch.maximum(x, gate))
    return torch.where(big, ja, jc), torch.where(big, ya, yc)


def jv(v, x):
    """J_v(x): J_{-v} = cos(pi v) J_v - sin(pi v) Y_v, (-1)^n J_n at an
    integer order; x < 0 by parity for an integer order, NaN otherwise."""
    ok, vs, xs = _finite(v, x)
    vint = vs == torch.round(vs)
    av = vs.abs()
    jp, yp = _jy_pos(av, torch.clamp(xs.abs(), min=1e-30))
    neg = torch.where(vint, torch.where(_odd(av), -jp, jp), _cospi(av) * jp - _sinpi(av) * yp)
    out = torch.where(vs >= 0, jp, neg)
    out = torch.where((xs < 0) & _odd(vs), -out, out)
    at0 = torch.where(vs == 0, 1.0, torch.where((vs > 0) | vint, 0.0, math.inf))
    out = torch.where(xs == 0, at0, torch.where((xs < 0) & ~vint, math.nan, out))
    out = torch.where(v.isinf() & ~x.isnan(), 0.0, out)
    return torch.where(ok | (v.isinf() & ~x.isnan()), out, math.nan)


def yv(v, x):
    """Y_v(x): Y_{-v} = sin(pi v) J_v + cos(pi v) Y_v; -inf at 0, NaN below."""
    ok, vs, xs = _finite(v, x)
    av = vs.abs()
    jp, yp = _jy_pos(av, torch.clamp(xs, min=1e-30))
    vint = vs == torch.round(vs)
    neg = torch.where(vint, torch.where(_odd(av), -yp, yp), _sinpi(av) * jp + _cospi(av) * yp)
    out = torch.where(vs >= 0, yp, neg)
    out = torch.where(xs > 0, out, torch.where(xs == 0, -math.inf, math.nan))
    return torch.where(ok, out, math.nan)

"""Scalar special functions.

Counterpart of ``pytensor_tpu/scalar/math.py``: every op but the seven
shape-parameter gradient ops (``betainc_dda``, ``betainc_ddb``,
``gammainc_ddk``, ``gammaincc_ddk``, ``hyp2f1_dda``, ``hyp2f1_ddb``,
``hyp2f1_ddc``), which the JAX package gets from jax autodiff through its
continued fractions (``:332-640``) and which wait for ROADMAP.md Queue 1
item 10b: each raises ``NotImplementedError``, and so does a gradient
that needs one.

Each op carries scipy as its numpy implementation (the oracle), the
gradient the JAX package defines and a plain torch version: the
``torch.special`` call where torch has the function, else the JAX
package's algorithm in torch ops (``scalar/bessel.py``, the incomplete
beta's fraction).  Where the device function computes in double (the
digamma, polygamma, incomplete gamma and beta and Bessel functions), the
plain version computes in float64 too and rounds.  On a CUDA device an
Elemwise of one of these ops runs as K1 (fused, or one node alone), never
the plain version, which runs on CPU tensors only.

``gammaincinv``, ``gammainccinv``, ``betaincinv``, ``hyp2f1`` and
``owens_t`` run scipy on the host, as the JAX package's ``_host``
lowering (``:37``) does through ``jax.pure_callback``: K1 cannot emit
them, and their lowering declares ``reads_back``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pytensor_tpu_torch.scalar import bessel
from pytensor_tpu_torch.scalar.basic import _op, _tm, upcast_float

_SQRT_PI = float(np.sqrt(np.pi))
_2_OVER_SQRT_PI = 2.0 / _SQRT_PI
_ITEM_10B = "ROADMAP.md Queue 1 item 10b (the shape-parameter gradients of the special functions)"


def _sps():
    import scipy.special as sps

    return sps


def _special(name, nin, np_fn, torch_fn, grad_fn=None, **kw):
    """A special function: float output, K1 on the card."""
    return _op(name, nin, np_fn, torch_fn, grad_fn, dtype_rule=kw.pop("dtype_rule", "float"),
               special=True, **kw)


def _in_float64(fn):
    """``fn`` computed in float64 and rounded to the operands' dtype, as
    the iterative device functions compute."""
    def wrapped(*args):
        out = fn(*[a.to(torch.float64) for a in args])
        return out.to(args[0].dtype)

    return wrapped


def _dg():
    from pytensor_tpu_torch import gradient

    return gradient


def _deferred(op, pos, x, what):
    return _dg().grad_not_implemented(op, pos, x, f"{what}: {_ITEM_10B}")


# --- error function family ---

erf = _special("erf", 1, lambda x: _sps().erf(x), torch.erf,
               lambda i, o, gz: [gz[0] * _2_OVER_SQRT_PI * _tm().exp(-i[0] * i[0])])
erfc = _special("erfc", 1, lambda x: _sps().erfc(x), torch.erfc,
                lambda i, o, gz: [-gz[0] * _2_OVER_SQRT_PI * _tm().exp(-i[0] * i[0])])
erfinv = _special("erfinv", 1, lambda x: _sps().erfinv(x), torch.erfinv,
                  lambda i, o, gz: [gz[0] * _SQRT_PI / 2 * _tm().exp(o[0] * o[0])])


def _torch_erfcinv(y):
    # erfc(x) = y  <=>  x = -ndtri(y / 2) / sqrt(2), accurate in both tails
    return -torch.special.ndtri(0.5 * y) * math.sqrt(0.5)


erfcinv = _special("erfcinv", 1, lambda x: _sps().erfcinv(x), _torch_erfcinv,
                   lambda i, o, gz: [-gz[0] * _SQRT_PI / 2 * _tm().exp(o[0] * o[0])])
erfcx = _special("erfcx", 1, lambda x: _sps().erfcx(x), torch.special.erfcx,
                 lambda i, o, gz: [gz[0] * (2 * i[0] * o[0] - _2_OVER_SQRT_PI)])


# --- gamma family ---

def _torch_gamma(x):
    """Gamma(x) = sign * exp(lgamma(x)); NaN at the poles below 0, +-inf
    at +-0, as scipy."""
    neg = x < 0
    odd = torch.remainder(torch.floor(x), 2.0) != 0
    out = torch.exp(torch.lgamma(x))
    out = torch.where(neg & odd, -out, out)
    out = torch.where(neg & (x == torch.floor(x)), math.nan, out)
    return torch.where(x == 0, torch.copysign(torch.full_like(x, math.inf), x), out)


gamma = _special("gamma", 1, lambda x: _sps().gamma(x), _torch_gamma,
                 lambda i, o, gz: [gz[0] * o[0] * _tm().psi(i[0])])
gammaln = _special("gammaln", 1, lambda x: _sps().gammaln(x), torch.lgamma,
                   lambda i, o, gz: [gz[0] * _tm().psi(i[0])])
psi = _special("psi", 1, lambda x: _sps().psi(x), _in_float64(torch.special.digamma),
               lambda i, o, gz: [gz[0] * _tm().tri_gamma(i[0])])
digamma = psi


def _torch_trigamma(x):
    # inf at the poles, 0 and below, as scipy (torch's is finite there)
    return torch.where((x <= 0) & (x == torch.floor(x)), math.inf, torch.special.polygamma(1, x))


tri_gamma = _special("tri_gamma", 1, lambda x: _sps().polygamma(1, x),
                     _in_float64(_torch_trigamma),
                     lambda i, o, gz: [gz[0] * _tm().polygamma(2, i[0])])


def _polygamma_grad(i, o, gz):
    n, x = i
    return [_dg().grad_undefined(polygamma, 0, n, "order is discrete"),
            gz[0] * _tm().polygamma(n + 1, x)]


def _polygamma_dtype(n, x):
    # the order is discrete, the argument real (the JAX package's rule)
    if not (n == "bool" or n.startswith(("int", "uint"))):
        raise TypeError(f"Polygamma order parameter must be discrete, got {n}")
    if x.startswith("complex"):
        raise TypeError("Polygamma: complex argument not supported")
    return upcast_float(x)


def _torch_polygamma(n, x):
    """psi^(n)(x) = (-1)^(n+1) n! zeta(n + 1, x), digamma at n = 0; the
    order is a tensor, so through torch's elementwise Hurwitz zeta."""
    sign = torch.where(torch.remainder(n, 2.0) == 0, -1.0, 1.0)
    # zeta(s, +inf) = 0 and zeta(s, -inf) = inf, as scipy's (torch's is NaN)
    zeta = torch.where(x == math.inf, 0.0,
                       torch.where(x == -math.inf, math.inf, torch.special.zeta(n + 1.0, x)))
    out = sign * torch.exp(torch.lgamma(n + 1.0)) * zeta
    out = torch.where(n == 0, torch.special.digamma(x), out)
    return torch.where((n < 0) | (n != torch.floor(n)), math.nan, out)


polygamma = _special("polygamma", 2,
                     lambda n, x: _sps().polygamma(np.asarray(n, dtype=int), x),
                     _in_float64(_torch_polygamma), _polygamma_grad,
                     dtype_rule=_polygamma_dtype)


def _gamma_pdf(k, x):
    tm = _tm()
    return tm.exp(-x + (k - 1) * tm.log(x) - tm.gammaln(k))


gammainc = _special("gammainc", 2, lambda k, x: _sps().gammainc(k, x),
                    _in_float64(torch.special.gammainc),
                    lambda i, o, gz: [_deferred(gammainc, 0, i[0], "gammainc_ddk"),
                                      gz[0] * _gamma_pdf(*i)])
gammaincc = _special("gammaincc", 2, lambda k, x: _sps().gammaincc(k, x),
                     _in_float64(torch.special.gammaincc),
                     lambda i, o, gz: [_deferred(gammaincc, 0, i[0], "gammaincc_ddk"),
                                       -gz[0] * _gamma_pdf(*i)])
gammau = _special("gammau", 2, lambda k, x: _sps().gammaincc(k, x) * _sps().gamma(k),
                  _in_float64(lambda k, x: torch.special.gammaincc(k, x) * _torch_gamma(k)))
gammal = _special("gammal", 2, lambda k, x: _sps().gammainc(k, x) * _sps().gamma(k),
                  _in_float64(lambda k, x: torch.special.gammainc(k, x) * _torch_gamma(k)))


# --- the host ops: scipy through a device-to-host round trip ---

def _host(fn_name):
    """scipy's ``fn_name`` on the host values of the operands, the result
    moved back to their device (the JAX package's ``_host``)."""
    def fn(*args):
        out = getattr(_sps(), fn_name)(*[a.detach().cpu().numpy() for a in args])
        return torch.from_numpy(np.asarray(out, dtype=np.dtype(str(args[0].dtype)[6:]))).to(
            args[0].device)

    return fn


def _host_op(name, nin, grad_fn=None):
    return _op(name, nin, lambda *a: getattr(_sps(), name)(*a), _host(name), grad_fn,
               dtype_rule="float", on_host=True)


gammaincinv = _host_op("gammaincinv", 2)
gammainccinv = _host_op("gammainccinv", 2)


# --- beta family ---

def _betacf(a, b, x):
    """The incomplete beta's continued fraction (Lentz), each element to
    its own convergence (``pytensor_tpu/scalar/math.py:332``)."""
    eps = torch.finfo(torch.float64).eps
    fpmin = torch.finfo(torch.float64).tiny / eps

    def guard(t):
        return torch.where(t.abs() < fpmin, fpmin, t)

    qab, qap, qam = a + b, a + 1.0, a - 1.0
    c = torch.ones_like(x)
    d = 1.0 / guard(1.0 - qab * x / qap)
    h = d
    done = torch.zeros_like(x, dtype=torch.bool)
    for m in range(1, bessel.CF_MAXIT + 1):
        if bool(done.all()):
            break
        m2 = 2.0 * m
        aa = m * (b - m) * x / ((qam + m2) * (a + m2))
        dn = 1.0 / guard(1.0 + aa * d)
        cn = guard(1.0 + aa / c)
        hn = h * dn * cn
        aa = -(a + m) * (qab + m) * x / ((a + m2) * (qap + m2))
        dn = 1.0 / guard(1.0 + aa * dn)
        cn = guard(1.0 + aa / cn)
        delt = dn * cn
        c, d, h = (torch.where(done, old, new) for old, new in ((c, cn), (d, dn), (h, hn * delt)))
        done = done | ((delt - 1.0).abs() < eps)
    return h


def _torch_betainc(a, b, x):
    """I_x(a, b) by the fraction on the side of (a + 1)/(a + b + 2) where it
    converges; scipy's values at the edges."""
    a, b, x = torch.broadcast_tensors(a, b, x)
    nan = a.isnan() | b.isnan() | x.isnan() | (a < 0) | (b < 0) | (x < 0) | (x > 1) \
        | ((a == 0) & (b == 0)) | (a.isinf() & b.isinf())
    edge = (a == 0) | (b == 0) | (x == 0) | (x == 1) | a.isinf() | b.isinf()
    ok = ~nan & ~edge
    a_, b_ = torch.where(ok, a, 1.0), torch.where(ok, b, 1.0)
    x_ = torch.where(ok, x, 0.5)
    bt = torch.exp(torch.lgamma(a_ + b_) - torch.lgamma(a_) - torch.lgamma(b_)
                   + a_ * torch.log(x_) + b_ * torch.log1p(-x_))
    direct = x_ < (a_ + 1.0) / (a_ + b_ + 2.0)
    # each element runs the fraction of its own side
    aa, bb = torch.where(direct, a_, b_), torch.where(direct, b_, a_)
    xx = torch.where(direct, x_, 1.0 - x_)
    cf = bt * _betacf(aa, bb, xx) / aa
    out = torch.where(direct, cf, 1.0 - cf)
    edge_val = torch.where((a == 0) | (x == 1) | b.isinf(), 1.0, 0.0)
    return torch.where(nan, math.nan, torch.where(edge, edge_val, out))


def _betainc_grad(i, o, gz):
    a, b, x = i
    tm = _tm()
    gx = gz[0] * tm.exp((a - 1) * tm.log(x) + (b - 1) * tm.log1p(-x) - tm.betaln(a, b))
    return [_deferred(betainc, 0, a, "betainc_dda"), _deferred(betainc, 1, b, "betainc_ddb"),
            gx]


betainc = _special("betainc", 3, lambda a, b, x: _sps().betainc(a, b, x),
                   _in_float64(_torch_betainc), _betainc_grad)
betaincinv = _host_op("betaincinv", 3)
betaln = _special("betaln", 2, lambda a, b: _sps().betaln(a, b),
                  lambda a, b: torch.lgamma(a) + torch.lgamma(b) - torch.lgamma(a + b),
                  lambda i, o, gz: [gz[0] * (_tm().psi(i[0]) - _tm().psi(i[0] + i[1])),
                                    gz[0] * (_tm().psi(i[1]) - _tm().psi(i[0] + i[1]))])


# --- sigmoid / softplus family ---

def _np_sigmoid(x):
    with np.errstate(over="ignore"):
        return 1 / (1 + np.exp(-np.asarray(x)))


def _torch_sigmoid(x):
    """torch's sigmoid, but in bfloat16 the value of ``jax.nn.sigmoid``,
    which XLA computes as ``1 / (1 + exp(-x))`` with each op rounded to
    bfloat16 (torch's computes in float and rounds once)."""
    if x.dtype == torch.bfloat16:
        return 1 / (1 + torch.exp(-x))
    return torch.sigmoid(x)


# jax.nn.sigmoid, which the JAX package lowers it to, refuses integer and
# bool inputs
sigmoid = _op("sigmoid", 1, _np_sigmoid, _torch_sigmoid,
              lambda i, o, gz: [gz[0] * o[0] * (1 - o[0])], dtype_rule="float",
              float_inputs=True)
expit = sigmoid


def _np_softplus(x):
    x = np.asarray(x)
    return np.maximum(x, 0) + np.log1p(np.exp(-np.abs(x)))


softplus = _special("softplus", 1, _np_softplus,
                    lambda x: torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs())),
                    lambda i, o, gz: [gz[0] * _tm().sigmoid(i[0])])

_LN2 = 0.693147180559945


def _np_log1mexp(x):
    x = np.asarray(x, dtype="float64")
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(x > -_LN2, np.log(-np.expm1(x)), np.log1p(-np.exp(x)))


def _log1mexp_pullback(i, o, gz):
    # d/dx log(1-exp(x)) = -1/expm1(-x), -inf at 0 (the JAX package pins
    # the sign there: expm1(-0.0) = -0.0 would give +inf)
    tm = _tm()
    res = -1.0 / tm.expm1(-i[0])
    res = tm.switch(tm.isinf(res), -np.inf, res)
    return [gz[0] * res]


log1mexp = _special("log1mexp", 1, _np_log1mexp,
                    lambda x: torch.where(x > -_LN2, torch.log(-torch.expm1(x)),
                                          torch.log1p(-torch.exp(x))),
                    _log1mexp_pullback)
logit = _special("logit", 1, lambda x: _sps().logit(x), lambda x: torch.log(x / (1.0 - x)),
                 lambda i, o, gz: [gz[0] / (i[0] * (1 - i[0]))])
# x * log(y) with 0 * log(y) = 0 unless y is NaN
xlogy = _special("xlogy", 2, lambda x, y: _sps().xlogy(x, y), torch.special.xlogy,
                 lambda i, o, gz: [gz[0] * _tm().log(i[1]), gz[0] * i[0] / i[1]])
xlog1py = _special("xlog1py", 2, lambda x, y: _sps().xlog1py(x, y), torch.special.xlog1py,
                   lambda i, o, gz: [gz[0] * _tm().log1p(i[1]), gz[0] * i[0] / (1 + i[1])])


# --- bessel (scalar/bessel.py, the JAX package's cores in torch ops) ---

def _order_grad(op, v):
    return _dg().grad_not_implemented(op, 0, v, "grad wrt bessel order")


def _iv_grad(i, o, gz):
    tm = _tm()
    v, x = i
    return [_order_grad(iv, v), gz[0] * 0.5 * (tm.iv(v - 1, x) + tm.iv(v + 1, x))]


def _ive_grad(i, o, gz):
    # d/dx [e^-|x| I_v(x)] = e^-|x| ((I_{v-1} + I_{v+1}) / 2 - sign(x) I_v)
    tm = _tm()
    v, x = i
    return [_order_grad(ive, v),
            gz[0] * (0.5 * (tm.ive(v - 1, x) + tm.ive(v + 1, x)) - tm.sign(x) * o[0])]


def _jv_grad(i, o, gz):
    tm = _tm()
    v, x = i
    return [_order_grad(jv, v), gz[0] * 0.5 * (tm.jv(v - 1.0, x) - tm.jv(v + 1.0, x))]


def _kve_grad(i, o, gz):
    # d/dx [e^x K_v(x)] = e^x (K_v(x) - (K_{v-1}(x) + K_{v+1}(x)) / 2)
    tm = _tm()
    v, x = i
    return [_order_grad(kve, v), gz[0] * (o[0] - 0.5 * (tm.kve(v - 1, x) + tm.kve(v + 1, x)))]


def _kv_grad(i, o, gz):
    tm = _tm()
    v, x = i
    return [_order_grad(kv, v), -gz[0] * 0.5 * (tm.kv(v - 1.0, x) + tm.kv(v + 1.0, x))]


iv = _special("iv", 2, lambda v, x: _sps().iv(v, x), _in_float64(bessel.iv), _iv_grad)
ive = _special("ive", 2, lambda v, x: _sps().ive(v, x), _in_float64(bessel.ive), _ive_grad)
jv = _special("jv", 2, lambda v, x: _sps().jv(v, x), _in_float64(bessel.jv), _jv_grad)
yv = _special("yv", 2, lambda v, x: _sps().yv(v, x), _in_float64(bessel.yv))
kve = _special("kve", 2, lambda v, x: _sps().kve(v, x), _in_float64(bessel.kve), _kve_grad)
kv = _special("kv", 2, lambda v, x: _sps().kv(v, x), _in_float64(bessel.kv), _kv_grad)
kn = kv  # integer order: scipy's kn(n, x) is kv(n, x)
i0 = _special("i0", 1, lambda x: _sps().i0(x), torch.special.i0,
              lambda i, o, gz: [gz[0] * _tm().i1(i[0])])
i1 = _special("i1", 1, lambda x: _sps().i1(x), torch.special.i1,
              lambda i, o, gz: [gz[0] * 0.5 * (_tm().i0(i[0]) + _tm().iv(2.0, i[0]))])
# J_0 and J_1 through the J/Y core (the JAX package's j1, bessel.py:j1_jax):
# torch's bessel_j0 and bessel_j1 err by ~4e-7 in float64
j0 = _special("j0", 1, lambda x: _sps().j0(x),
              _in_float64(lambda x: bessel.jv(torch.zeros_like(x), x)))
j1 = _special("j1", 1, lambda x: _sps().j1(x),
              _in_float64(lambda x: bessel.jv(torch.ones_like(x), x)))


# --- hypergeometric (host) ---

def _hyp2f1_grad(i, o, gz):
    tm = _tm()
    a, b, c, z = i
    # d/dz 2F1(a, b; c; z) = ab/c 2F1(a+1, b+1; c+1; z)
    return [_deferred(hyp2f1, 0, a, "hyp2f1_dda"), _deferred(hyp2f1, 1, b, "hyp2f1_ddb"),
            _deferred(hyp2f1, 2, c, "hyp2f1_ddc"),
            gz[0] * (a * b / c) * tm.hyp2f1(a + 1, b + 1, c + 1, z)]


hyp2f1 = _host_op("hyp2f1", 4, _hyp2f1_grad)

# --- the normal distribution ---

# jax.scipy.special's ndtr and ndtri, which the JAX package lowers these to,
# take float32 and float64 only
_HALF_FLOATS = ("float16", "bfloat16")
ndtr = _special("ndtr", 1, lambda x: _sps().ndtr(x), torch.special.ndtr,
                lambda i, o, gz: [gz[0] * float(1 / np.sqrt(2 * np.pi))
                                  * _tm().exp(-i[0] * i[0] / 2)], refused=_HALF_FLOATS)
ndtri = _special("ndtri", 1, lambda x: _sps().ndtri(x), torch.special.ndtri,
                 lambda i, o, gz: [gz[0] * float(np.sqrt(2 * np.pi))
                                   * _tm().exp(o[0] * o[0] / 2)], refused=_HALF_FLOATS)


# --- the long tail ---

def _owens_t_grad(i, o, gz):
    # dT/dh = -exp(-h^2/2) erf(a h / sqrt(2)) / (2 sqrt(2 pi))
    # dT/da =  exp(-(1+a^2) h^2 / 2) / (2 pi (1+a^2))
    tm = _tm()
    h, a = i
    gh = (-gz[0] * tm.exp(-h * h / 2.0) * tm.erf(a * h / float(np.sqrt(2.0)))
          / float(2.0 * np.sqrt(2.0 * np.pi)))
    ga = gz[0] * tm.exp(-0.5 * (a * a + 1.0) * h * h) / (2.0 * float(np.pi) * (a * a + 1.0))
    return [gh, ga]


owens_t = _host_op("owens_t", 2, _owens_t_grad)


def _ndtri_exp_grad(i, o, gz):
    # exp(x) / pdf(z) as sqrt(2 pi) exp(x + z^2 / 2)
    tm = _tm()
    return [gz[0] * float(np.sqrt(2.0 * np.pi)) * tm.exp(i[0] + o[0] * o[0] / 2.0)]


ndtri_exp = _special("ndtri_exp", 1, lambda x: _sps().ndtri(np.exp(x)),
                     lambda x: torch.special.ndtri(torch.exp(x)), _ndtri_exp_grad,
                     refused=_HALF_FLOATS)


def _chi2sf_grad(i, o, gz):
    tm = _tm()
    x, k = i
    # d/dx sf = -pdf(x; k)
    gx = -gz[0] * tm.exp(-x / 2.0 + (k / 2.0 - 1.0) * tm.log(x / 2.0)
                         - tm.gammaln(k / 2.0)) / 2.0
    return [gx, _dg().grad_not_implemented(chi2sf, 1, k, "grad wrt df")]


chi2sf = _special("chi2sf", 2, lambda x, k: _sps().chdtrc(k, x),
                  _in_float64(lambda x, k: torch.special.gammaincc(0.5 * k, 0.5 * x)),
                  _chi2sf_grad)


# --- the shape-parameter gradient ops: ROADMAP.md Queue 1 item 10b ---

def _not_ported(name):
    def fn(*args):
        raise NotImplementedError(f"{name} is not ported: {_ITEM_10B}")

    fn.__name__ = name
    return fn


betainc_dda = _not_ported("betainc_dda")
betainc_ddb = _not_ported("betainc_ddb")
gammainc_ddk = _not_ported("gammainc_ddk")
gammaincc_ddk = _not_ported("gammaincc_ddk")
hyp2f1_dda = _not_ported("hyp2f1_dda")
hyp2f1_ddb = _not_ported("hyp2f1_ddb")
hyp2f1_ddc = _not_ported("hyp2f1_ddc")

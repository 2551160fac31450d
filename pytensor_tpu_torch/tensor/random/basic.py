"""The distribution library: jax's samplers in torch, on threefry bits.

Counterpart of ``pytensor_tpu/tensor/random/basic.py``.  Each sampler
computes what the JAX package's ``jax_sampler`` computes, step for step,
from the same threefry bits (``tensor/random/threefry.py``): the same
uniforms and normals, the same arithmetic in the same dtypes (jax's
promotion of a float32 parameter with a float64 draw is float64; torch
would keep a 0-d tensor's operand at float32, so ``_p`` casts both
operands of each step to jax's common dtype), the same splits of the key.
A float draw is a float64 draw from 64-bit bits, as the JAX package's
``jax.random`` calls draw under ``enable_x64``, rounded to the variable's
dtype; ``bernoulli``, ``geometric``, ``categorical`` and ``choice`` draw
in their probability's dtype, as jax does.

Tier A is jax's closed form of the bits, held to the JAX package's
draws.  ``hypergeometric`` draws with numpy on the host from a seed of the
key, as the JAX package's ``pure_callback`` does, so its lowering reads
back.  Tier B, the distributions whose jax sampler is a loop (``gamma``,
``beta``, ``dirichlet``, ``chisquare``, ``invgamma``, ``gengamma``, ``t``,
``negative_binomial``, ``poisson``, ``binomial``, ``betabinom``,
``multinomial``), are the JAX package's compositions of jax's samplers,
which ``tensor/random/samplers.py`` ports step for step: on the card the
gamma, Poisson and binomial kernels, on the CPU their plain loops.  jax
draws gamma, beta, dirichlet, chisquare and t in float64 whatever the
parameters' dtype (``dtype=None`` under ``enable_x64``), Poisson in
float32, and binomial in the probability's dtype; ``binomial`` and
``betabinom`` cast that draw to int64 as XLA casts it, on the card in the
binomial kernel.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from pytensor_tpu_torch.tensor.random import samplers as sp
from pytensor_tpu_torch.tensor.random import threefry as tf
from pytensor_tpu_torch.tensor.random.op import RandomVariable

F64 = torch.float64


def _full_shape(shape, *params):
    if shape is not None:
        return tuple(int(s) for s in shape)
    return tuple(torch.broadcast_shapes(*(p.shape for p in params))) if params else ()


def _p(*xs):
    """``xs`` cast to their common dtype under jax's promotion of arrays
    (which, for the float and integer dtypes here, is ``promote_types``);
    a Python number stays as it is (weakly typed in both)."""
    dtype = functools.reduce(torch.promote_types,
                             [x.dtype for x in xs if isinstance(x, torch.Tensor)])
    return [x.to(dtype) if isinstance(x, torch.Tensor) and x.dtype != dtype else x
            for x in xs]


def _add(a, b):
    a, b = _p(a, b)
    return a + b


def _sub(a, b):
    a, b = _p(a, b)
    return a - b


def _mul(a, b):
    a, b = _p(a, b)
    return a * b


def _div(a, b):
    a, b = _p(a, b)
    return a / b


def _inexact(x):
    """jax's ``promote_dtypes_inexact`` of one array: an integer is float64."""
    return x if x.is_floating_point() else x.to(F64)


def _locscale(std_sampler):
    def sampler(key, shape, loc, scale):
        z = std_sampler(key, _full_shape(shape, loc, scale))
        return _add(loc, _mul(scale, z))

    return sampler


# --- jax's standard samplers (jax/_src/random.py), float64 unless said -------

FINFO64 = np.finfo(np.float64)


def _exponential(key, shp):
    return -torch.log1p(-tf.uniform(key, shp))


def _logistic(key, shp):
    x = tf.uniform(key, shp, F64, float(FINFO64.tiny), 1.0)
    return torch.log(x) - torch.log1p(-x)


def _cauchy(key, shp):
    u = tf.uniform(key, shp, F64, float(FINFO64.eps), 1.0)
    return torch.tan(math.pi * (u - 0.5))


def _gumbel(key, shp, dtype=F64):
    tiny = float(np.finfo(np.float64 if dtype == F64 else np.float32).tiny)
    return -torch.log(-torch.log(tf.uniform(key, shp, dtype, tiny, 1.0)))


def _laplace(key, shp):
    u = tf.uniform(key, shp, F64, -1.0 + float(FINFO64.epsneg), 1.0)
    return torch.sign(u) * torch.log1p(-torch.abs(u))


def _uniform_param_dtype(p):
    """The float dtype jax draws a probability's uniforms in."""
    return torch.float32 if p.dtype in (torch.float32, torch.float16) else F64


# --- continuous ---------------------------------------------------------------

uniform = RandomVariable(
    "uniform", [0, 0], 0, "floatX",
    lambda key, shape, low, high: _add(low, _mul(_sub(high, low), tf.uniform(
        key, _full_shape(shape, low, high)))),
    defaults=(0.0, 1.0),
)

normal = RandomVariable(
    "normal", [0, 0], 0, "floatX",
    _locscale(lambda key, shp: tf.normal(key, shp)),
    defaults=(0.0, 1.0),
)

standard_normal = RandomVariable(
    "standard_normal", [], 0, "floatX",
    lambda key, shape: tf.normal(key, _full_shape(shape)),
)

halfnormal = RandomVariable(
    "halfnormal", [0, 0], 0, "floatX",
    _locscale(lambda key, shp: torch.abs(tf.normal(key, shp))),
    defaults=(0.0, 1.0),
)

lognormal = RandomVariable(
    "lognormal", [0, 0], 0, "floatX",
    lambda key, shape, mean, sigma: torch.exp(_add(mean, _mul(
        sigma, tf.normal(key, _full_shape(shape, mean, sigma))))),
    defaults=(0.0, 1.0),
)

beta = RandomVariable(
    "beta", [0, 0], 0, "floatX",
    lambda key, shape, a, b: sp.beta(key, a, b, _full_shape(shape, a, b)),
)

_gamma = RandomVariable(
    "gamma", [0, 0], 0, "floatX",
    lambda key, shape, shape_p, scale: _mul(
        sp.gamma(key, shape_p, _full_shape(shape, shape_p, scale)), scale),
)


def gamma(shape, rate=None, scale=None, **kwargs):
    """Gamma draws; the positional second argument is the RATE, as in the
    JAX package (``basic.py:82``); scale by keyword."""
    if rate is not None and scale is not None:
        raise ValueError("gamma: pass rate or scale, not both")
    if rate is None and scale is None:
        raise ValueError("gamma: must specify rate or scale")
    if scale is None:
        scale = 1.0 / rate
    return _gamma(shape, scale, **kwargs)


chisquare = RandomVariable(
    "chisquare", [0], 0, "floatX",
    lambda key, shape, df: sp.chisquare(key, df, _full_shape(shape, df)),
)

exponential = RandomVariable(
    "exponential", [0], 0, "floatX",
    lambda key, shape, scale: _mul(_exponential(key, _full_shape(shape, scale)), scale),
    defaults=(1.0,),
)


def _weibull(key, shape, a):
    # jax's weibull_min(key, 1.0, a): (-log1p(-u)) ** (1.0 / a) * 1.0
    u = tf.uniform(key, _full_shape(shape, a))
    inv = 1.0 / (a if a.is_floating_point() else a.to(F64))
    return torch.pow(-torch.log1p(-u), inv.to(F64))


weibull = RandomVariable("weibull", [0], 0, "floatX", _weibull)

logistic = RandomVariable(
    "logistic", [0, 0], 0, "floatX", _locscale(_logistic), defaults=(0.0, 1.0),
)


def _vonmises(key, shape, mu, kappa):
    # the JAX package's Best-Fisher loop of 24 fixed rounds (basic.py:131)
    shp = _full_shape(shape, mu, kappa)
    mu_b = mu.expand(shp)
    kappa_b = kappa.expand(shp)
    tau = 1 + torch.sqrt(1 + 4 * (kappa_b * kappa_b))
    rho = (tau - torch.sqrt(2 * tau)) / (2 * kappa_b)
    r = (1 + rho * rho) / (2 * rho)
    accepted = torch.zeros(shp, dtype=torch.bool, device=key.device)
    draw = torch.zeros(shp, dtype=F64, device=key.device)
    for _ in range(24):
        keys = tf.split(key, 4)
        key = keys[0]
        u1, u2, u3 = (tf.uniform(keys[j], shp) for j in (1, 2, 3))
        z = torch.cos(math.pi * u1)
        f = _div(_add(_mul(r, z), 1), _add(r, z))
        c = _mul(kappa_b, _sub(r, f))
        accept = (c * (2 - c) - u2 > 0) | (torch.log(c / u2) + 1 - c >= 0)
        theta = torch.sign(u3 - 0.5) * torch.arccos(torch.clip(f, -1, 1))
        draw = torch.where(~accepted & accept, theta, draw)
        accepted = accepted | accept
    return _add(mu_b, draw)


vonmises = RandomVariable("vonmises", [0, 0], 0, "floatX", _vonmises)

invgamma = RandomVariable(
    "invgamma", [0, 0], 0, "floatX",
    lambda key, shape, a, scale: _div(scale, sp.gamma(key, a, _full_shape(shape, a, scale))),
)


def _truncexpon(key, shape, b, loc, scale):
    u = tf.uniform(key, _full_shape(shape, b, loc, scale))
    # inverse CDF of the exponential truncated to [0, b]
    return _add(loc, _mul(scale, -torch.log1p(-_mul(u, 1.0 - torch.exp(-b)))))


truncexpon = RandomVariable("truncexpon", [0, 0, 0], 0, "floatX", _truncexpon)

def _betabinom(key, shape, n, a, b):
    # the JAX package's beta, then binomial on the second key (basic.py:179)
    keys = tf.split(key)
    shp = _full_shape(shape, n, a, b)
    return sp.binomial(keys[1], n, sp.beta(keys[0], a, b, shp), shp, torch.int64)


betabinom = RandomVariable("betabinom", [0, 0, 0], 0, "int64", _betabinom)


def _gengamma(key, shape, alpha, p, lambd):
    # scipy's convention, as the JAX package (basic.py:191):
    # lambd * gamma(alpha / p) ** (1 / p)
    shp = _full_shape(shape, alpha, p, lambd)
    g = sp.gamma(key, _div(_inexact(alpha), _inexact(p)), shp)
    return _mul(lambd, torch.pow(g, sp.true_div(1.0, p.to(g.dtype))))


gengamma = RandomVariable("gengamma", [0, 0, 0], 0, "floatX", _gengamma,
                          defaults=(1.0, 1.0, 1.0))


def _hypergeometric(key, shape, ngood, nbad, nsample):
    # no device algorithm without dynamic shapes (the support depends on the
    # parameters' values): as the JAX package's pure_callback, numpy on the
    # host, seeded by the sum of the key's words
    shp = _full_shape(shape, ngood, nbad, nsample)
    seed = int(key.cpu().sum())
    host = np.random.default_rng(seed)
    g, b, n = (np.broadcast_to(p.cpu().numpy(), shp) for p in (ngood, nbad, nsample))
    draws = host.hypergeometric(g, b, n, size=shp).astype(np.int64)
    return torch.as_tensor(draws).to(key.device)


hypergeometric = RandomVariable(
    "hypergeometric", [0, 0, 0], 0, "int64", _hypergeometric,
    reads_back="hypergeometric draws with numpy on the host from the key",
)

cauchy = RandomVariable(
    "cauchy", [0, 0], 0, "floatX", _locscale(_cauchy), defaults=(0.0, 1.0),
)

halfcauchy = RandomVariable(
    "halfcauchy", [0, 0], 0, "floatX",
    _locscale(lambda key, shp: torch.abs(_cauchy(key, shp))),
    defaults=(0.0, 1.0),
)


def _pareto(key, shape, b, scale):
    # jax's pareto(key, b): exp(e / b), b in float64; then * scale
    e = _exponential(key, _full_shape(shape, b, scale))
    return _mul(torch.exp(e / b.to(F64)), scale)


pareto = RandomVariable("pareto", [0, 0], 0, "floatX", _pareto, defaults=(1.0,))

gumbel = RandomVariable(
    "gumbel", [0, 0], 0, "floatX", _locscale(_gumbel), defaults=(0.0, 1.0),
)

laplace = RandomVariable(
    "laplace", [0, 0], 0, "floatX", _locscale(_laplace), defaults=(0.0, 1.0),
)


def _wald(key, shape, mean, scale):
    # the JAX package's Michael-Schucany-Haas transform (basic.py:273)
    shp = _full_shape(shape, mean, scale)
    k = tf.split(key)
    nu = tf.normal(k[0], shp)
    y = nu * nu
    mu = mean.expand(shp)
    lam = scale.expand(shp)
    two_lam = 2 * lam
    root = torch.sqrt(_add(_mul(_mul(4 * mu, lam), y), _mul(_mul(_mul(mu, mu), y), y)))
    x = _sub(_add(mu, _div(_mul(_mul(mu, mu), y), two_lam)), _mul(mu / two_lam, root))
    z = tf.uniform(k[1], shp)
    return torch.where(z <= _div(mu, _add(mu, x)), x, _div(_mul(mu, mu), x))


wald = RandomVariable("wald", [0, 0], 0, "floatX", _wald, defaults=(1.0, 1.0))

t = RandomVariable(
    "t", [0, 0, 0], 0, "floatX",
    lambda key, shape, df, loc, scale: _add(loc, _mul(scale, sp.t(
        key, df, _full_shape(shape, df, loc, scale)))),
    defaults=(0.0, 1.0),
)


def _triangular(key, shape, left, mode, right):
    # jax's triangular: the parameters in their dtype, u in float64
    shp = _full_shape(shape, left, mode, right)
    left, mode, right = (p.expand(shp) for p in (left, mode, right))
    fc = _div(_sub(mode, left), _sub(right, left))
    u = tf.uniform(key, shp)
    out1 = _add(left, torch.sqrt(_mul(_mul(u, _sub(right, left)), _sub(mode, left))))
    out2 = _sub(right, torch.sqrt(_mul(_mul(1 - u, _sub(right, left)), _sub(right, mode))))
    u_, fc_ = _p(u, fc)
    return torch.where(u_ < fc_, out1, out2)


triangular = RandomVariable("triangular", [0, 0, 0], 0, "floatX", _triangular)


def _rayleigh(key, shape, scale):
    shp = _full_shape(shape, scale)
    u = tf.uniform(key, shp)
    return scale.to(F64).expand(shp) * torch.sqrt(torch.log(u) * -2)


rayleigh = RandomVariable("rayleigh", [0], 0, "floatX", _rayleigh, defaults=(1.0,))


def _truncated_normal(key, shape, loc, scale, lower, upper):
    # loc + scale * jax's truncated_normal(key, (lower - loc) / scale,
    # (upper - loc) / scale) in float64
    shp = _full_shape(shape, loc, scale, lower, upper)
    lo = _div(_sub(lower, loc), scale).to(F64)
    hi = _div(_sub(upper, loc), scale).to(F64)
    a = torch.erf(lo / tf.SQRT2)
    b = torch.erf(hi / tf.SQRT2)
    u = tf.uniform(key, shp, F64, a, b)
    out = tf.SQRT2 * torch.erfinv(u)
    inf = torch.tensor(math.inf, dtype=F64, device=key.device)
    out = torch.clip(out, torch.nextafter(lo, inf), torch.nextafter(hi, -inf))
    return _add(loc, _mul(scale, out))


truncated_normal = RandomVariable(
    "truncated_normal", [0, 0, 0, 0], 0, "floatX", _truncated_normal,
)

# --- multivariate -------------------------------------------------------------


def _multivariate_normal(key, shape, mean, cov):
    # jax's method="cholesky": the draws in the parameters' common dtype
    from pytensor_tpu_torch.link.torch.dispatch import _cholesky_lower

    mean, cov = _p(_inexact(mean), _inexact(cov))
    if shape is None:
        shape = tuple(torch.broadcast_shapes(mean.shape[:-1], cov.shape[:-2]))
    factor = _cholesky_lower(cov, {})
    z = tf.normal(key, tuple(shape) + tuple(mean.shape[-1:]), mean.dtype)
    return mean + torch.matmul(factor, z[..., None])[..., 0]


multivariate_normal = RandomVariable(
    "multivariate_normal", [1, 2], 1, "floatX", _multivariate_normal,
)
mvnormal = multivariate_normal

dirichlet = RandomVariable(
    "dirichlet", [1], 1, "floatX",
    lambda key, shape, alpha: sp.dirichlet(key, alpha, None if shape is None else tuple(shape)),
)

# --- discrete -----------------------------------------------------------------

poisson = RandomVariable(
    "poisson", [0], 0, "int64",
    lambda key, shape, lam: sp.poisson(key, lam, _full_shape(shape, lam)),
    defaults=(1.0,),
)


def _bernoulli(key, shape, p):
    # jax's bernoulli: a uniform in p's dtype below p
    p = _inexact(p)
    return tf.uniform(key, _full_shape(shape, p), _uniform_param_dtype(p)) < p


bernoulli = RandomVariable("bernoulli", [0], 0, "int64", _bernoulli)

binomial = RandomVariable(
    "binomial", [0, 0], 0, "int64",
    lambda key, shape, n, p: sp.binomial(key, n, p, _full_shape(shape, n, p), torch.int64),
)


def _negbinom(key, shape, n, p):
    # the JAX package's gamma-Poisson mixture on two keys (basic.py:358)
    keys = tf.split(key)
    shp = _full_shape(shape, n, p)
    g = _div(_mul(sp.gamma(keys[0], n, shp), _sub(1, p)), p)
    return sp.poisson(keys[1], g, shp)


negative_binomial = RandomVariable("negative_binomial", [0, 0], 0, "int64", _negbinom)
nbinom = negative_binomial


def _geometric(key, shape, p):
    p = _inexact(p)
    shp = _full_shape(shape, p)
    u = tf.uniform(key, shp, _uniform_param_dtype(p))
    return torch.floor(_div(torch.log(u), torch.log1p(-p).expand(shp))) + 1


geometric = RandomVariable("geometric", [0], 0, "int64", _geometric)


def _categorical(key, shape, p):
    # jax's categorical(key, log(p)): argmax of logits + Gumbel noise in
    # p's dtype along the last axis
    logits = torch.log(_inexact(p))
    if shape is None and logits.ndim <= 1:
        shape = ()
    shape = _full_shape(shape, logits[..., 0])
    batch = tuple(logits.shape[:-1])
    prefix = shape[: len(shape) - len(batch)]
    noise = _gumbel(key, (*prefix, *shape[len(prefix):], logits.shape[-1]),
                    _uniform_param_dtype(logits))
    return torch.argmax(noise + logits.reshape((1,) * len(prefix) + tuple(logits.shape)),
                        dim=-1)


categorical = RandomVariable("categorical", [1], 0, "int64", _categorical)

def _multinomial(key, shape, n, p):
    # the JAX package's broadcasting (basic.py:385), then jax's multinomial
    batch = _full_shape(shape, n, p[..., 0])
    n_b = n.expand(batch).to(p.dtype)
    p_b = p.expand(batch + tuple(p.shape[-1:]))
    return sp.multinomial(key, n_b, p_b)


multinomial = RandomVariable("multinomial", [0, 1], 1, "int64", _multinomial)


def _urem(a, b):
    """The remainder of uint64 values held in int64."""
    from pytensor_tpu_torch.link.torch.dispatch import _udivmod64

    return _udivmod64(a, b)[1]


def _randint(key, shape, low, high):
    # jax's randint in int64: 2 x 64 bits a draw, reduced modulo the span
    shp = _full_shape(shape, low, high)
    low, high = low.to(torch.int64), high.to(torch.int64)
    keys = tf.split(key)
    higher, lower = tf.random_bits(keys[0], 64, shp), tf.random_bits(keys[1], 64, shp)
    span = torch.where(high <= low, torch.ones_like(high), high - low).expand(shp)
    multiplier = _urem(torch.full_like(span, 2 ** 32), span)
    multiplier = _urem(multiplier * multiplier, span)
    offset = _urem(_urem(higher, span) * multiplier + _urem(lower, span), span)
    return low + offset


integers = RandomVariable("integers", [0, 0], 0, "int64", _randint)


def randint(low, high=None, size=None, rng=None, **kwargs):
    if high is None:
        low, high = 0, low
    return integers(low, high, size=size, rng=rng, **kwargs)


def _shuffle(key, x):
    # jax's _shuffle along axis 0: rounds of a stable sort by 32-bit keys
    rounds = int(np.ceil(3 * np.log(max(1, x.shape[0] if x.ndim else 1))
                         / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        keys = tf.split(key)
        key = keys[0]
        order = torch.sort(tf.random_bits(keys[1], 32, (x.shape[0],)), stable=True).indices
        x = x[order]
    return x


def _choice(key, a, shape, replace, p=None):
    # jax's choice along axis 0 (random.py:731)
    n_inputs = int(a) if a.ndim == 0 else a.shape[0]
    n_draws = math.prod(shape)
    if n_draws == 0:
        return torch.zeros(shape, dtype=a.dtype, device=key.device)
    if p is None:
        if replace:
            ind = _randint(key, shape, torch.zeros((), dtype=torch.int64, device=key.device),
                           torch.full((), n_inputs, dtype=torch.int64, device=key.device))
        else:
            perm = _shuffle(key, torch.arange(n_inputs, device=key.device)
                            if a.ndim == 0 else a)
            return perm[:n_draws].reshape(shape + tuple(a.shape[1:] if a.ndim else ()))
    else:
        p = _inexact(p)
        if replace:
            cuml = torch.cumsum(p, 0)
            r = cuml[-1] * (1 - tf.uniform(key, shape, _uniform_param_dtype(p)))
            ind = torch.searchsorted(cuml, r.reshape(-1)).reshape(shape)
        else:
            g = _gumbel(key, (n_inputs,), _uniform_param_dtype(p)) + torch.log(p)
            ind = torch.topk(g, n_draws).indices
    ind = ind.to(torch.int64)
    result = ind if a.ndim == 0 else a[ind.reshape(-1)]
    return result.reshape(shape + tuple(a.shape[1:] if a.ndim else ()))


def choice(a, size=None, replace=True, p=None, rng=None):
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable

    a = as_tensor_variable(a)

    def sampler(key, shape, a_val, p_val=None):
        return _choice(key, a_val, () if shape is None else tuple(int(s) for s in shape),
                       replace, p_val)

    host = (0,) if a.type.ndim == 0 else ()
    if p is not None:
        rv = RandomVariable("choice", [1, 1], 0, str(a.type.dtype), sampler, host_params=host)
        return rv(a, p, size=size, rng=rng)
    rv = RandomVariable("choice", [1], 0, str(a.type.dtype), sampler, host_params=host)
    return rv(a, size=size, rng=rng)


choice_rv = RandomVariable(
    "choice", [1], 0, "floatX",
    lambda key, shape, a: _choice(key, a, () if shape is None else tuple(shape), True),
)


def _permutation(key, x):
    # jax's permutation: a shuffle of x, or of the row indices of a
    # matrix taken from x
    if x.ndim == 0:
        return _shuffle(key, torch.arange(int(x), device=key.device))
    if x.ndim == 1:
        return _shuffle(key, x)
    return x[_shuffle(key, torch.arange(x.shape[0], device=key.device))]


permutation_rv = RandomVariable(
    "permutation", [1], 1, "floatX", lambda key, shape, x: _permutation(key, x),
)


def permutation(x, rng=None, **kwargs):
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable

    x = as_tensor_variable(x)
    if x.type.ndim == 0:
        rv = RandomVariable("permutation", [0], 1, "int64",
                            lambda key, shape, n: _permutation(key, n), host_params=(0,))
        return rv(x, rng=rng, **kwargs)
    rv = RandomVariable("permutation", [x.type.ndim], x.type.ndim, str(x.type.dtype),
                        lambda key, shape, xv: _permutation(key, xv))
    return rv(x, rng=rng, **kwargs)


# the generated per-name classes (random/op.py _rv_class) under the JAX
# package's names (NormalRV, UniformRV, ...)
from pytensor_tpu_torch.tensor.random.op import (  # noqa: E402,F401
    ScipyRandomVariable,
    _rv_classes as _generated_rv_classes,
)

globals().update(_generated_rv_classes)

# a choice without replacement is the same op, as in the JAX package
ChoiceWithoutReplacement = ChoiceRV  # noqa: F821

"""jax's loop samplers, step for step, in torch: the plain version of the
gamma, Poisson and binomial kernels, and the samplers built on them.

The JAX package draws these distributions through ``jax.random``, whose
samplers are ``while_loop``s (``jax/_src/random.py``):

- ``_gamma_one`` (``:1298``, Marsaglia and Tsang's two nested loops) under
  ``_gamma_impl`` (``:1398``): element ``i`` draws under
  ``split(key, n)[i]`` and runs its loops alone (``vmap``), so each
  element's draw is its own; ``log_space`` is ``loggamma``;
- ``_poisson`` (``:1600``): Knuth's loop (``:1547``) where ``lam < 10``
  or is NaN, Hormann's transformed rejection (PTRS, ``:1572``) elsewhere,
  both on the same key, in float32 whatever ``lam``'s dtype;
- ``_binomial`` (``:2781``): the inversion loop (``:2707``) where ``count
  * q <= 10`` (or ``count`` is NaN or negative), BTRS (``:2734``)
  elsewhere, on the same key, in the probability's dtype;
- ``multinomial`` (``:2895``), ``_beta`` (``:1133``), ``_dirichlet``
  (``:1240``), ``_t`` (``:1978``) and ``_chisquare`` (``:2032``) on them.

Each loop is a whole-array loop: it runs until no element is left, and its
body draws every element's uniforms from the iteration's key.  Knuth's and
the inversion loop are monotone (an element that has stopped never
changes), but PTRS and BTRS write ``k_out = select(accept, k, k_out)``
unmasked, so an element's draw is the k of its last accepting iteration
before the whole array's loop ends: it depends on every other element.
The loops here keep that: each runs over the whole array and ends on a
host read of ``.any()``, and the path not taken runs on jax's dummy
parameters (``lam = 1e5`` for PTRS, ``count = 1e4, q = 0.5`` for BTRS).
Where jax's loop bound is its dtype's largest value, these stop after
``MAX_ITERS`` iterations: no draw that ends comes near it (every loop
accepts with probability above one half a pass), and a loop that would not
end in jax (a count of inf with q 0) then ends, as it must on the card.

This is the CPU path and the kernels' oracle: ``gamma_loops``,
``poisson_loops`` and ``binomial_loops`` are the plain versions of
``csrc/gamma.cu``, ``csrc/poisson.cu`` and ``csrc/binomial.cu``
(``link/cuda/{gamma,poisson,binomial}_kernel.py``), which a key on the
card takes instead, with no host read.  Given a ``tally`` (a list), each
adds to it the threefry hashes the draw needs, for the kernels' bounds:
each hash of an element's own key chain that its draw reads (gamma's
next keys only where another pass follows), each element's uniforms in each
pass it needs (a PTRS or BTRS element up to its first accept and from its
last accept to the end of the whole array's loop, a Knuth or inversion
element up to its own end and, where some element takes PTRS or BTRS and
so reads N, on jax's dummy parameters up to its first accept), and the
key chain that the whole array shares once a pass.  Where no element
takes PTRS or BTRS, nothing reads that loop, so none of its hashes count.
XLA on the CPU contracts multiplies and adds into fused ones and rounds
its own ``log`` and ``lgamma``; these loops round each torch op on its
own, so a float draw is jax's within a few ulps, and an integer draw is
jax's unless an accept test falls within that rounding of its
threshold.
"""

from __future__ import annotations

import math

import torch

from pytensor_tpu_torch.link.cuda import threefry_kernel as tk
from pytensor_tpu_torch.tensor.random import threefry as tf

F32, F64 = torch.float32, torch.float64
# the loops' bound in place of jax's (its dtype's largest value)
MAX_ITERS = 1 << 16
THIRD = 1.0 / 3.0
# jax's table of the Stirling tail at k = 0..9 (random.py:2681)
STIRLING_TAIL = (0.0810614667953272, 0.0413406959554092, 0.0276779256849983,
                 0.02079067210376509, 0.0166446911898211, 0.0138761288230707,
                 0.0118967099458917, 0.0104112652619720, 0.00925546218271273,
                 0.00833056343336287)


def saturating_cast(x, dtype):
    """``x`` in ``dtype``; a float cast to an integer dtype as XLA casts it:
    toward zero, NaN to 0, out of range to the nearest end (torch's
    ``.to`` leaves those undefined)."""
    if not x.is_floating_point() or dtype.is_floating_point or dtype.is_complex \
            or dtype == torch.bool:
        return x.to(dtype)
    info = torch.iinfo(dtype)
    xd = x.to(F64)
    big, small, nan = xd >= 2.0 ** (info.bits - 1), xd < info.min, torch.isnan(xd)
    mid = torch.where(big | small | nan, 0.0, xd).to(dtype)
    return torch.where(big, info.max, torch.where(small, info.min, mid))


def _tally(tally, shared, per_element, need):
    """Add to ``tally`` the hashes of one pass: ``per_element`` for each
    element in ``need`` and, if there is one, ``shared`` for the whole
    array's keys."""
    if tally is not None:
        tally.append(need.any() * shared + per_element * need.sum())


class _RejectionTally:
    """The hashes a whole-array rejection loop's draw needs: the pass's
    shared keys, each element's uniforms up to its first accept and, for
    an element whose draw is the loop's (``every_pass``, not one on jax's
    dummy parameters), those from its last accept to the loop's end, which
    the kernels search down from pass N - 1 for; the passes between its
    first and last accepts are not needed."""

    def __init__(self, tally, every_pass):
        self.tally, self.every_pass = tally, every_pass
        self.first = torch.full(every_pass.shape, -1, device=every_pass.device)
        self.last = self.first.clone()

    def before(self, accepted):
        _tally(self.tally, 3, 2, ~accepted)

    def after(self, accepted, accept, it):
        self.first = torch.where(~accepted & accept, it, self.first)
        self.last = torch.where(accept, it, self.last)

    def end(self, accepted, passes):
        after = passes - torch.maximum(self.last, self.first + 1)
        self.tally.append(2 * torch.where(self.every_pass & accepted, after, 0).sum())


def true_div(c, x):
    """The number ``c`` over the tensor ``x`` as one rounded division, as
    jax divides (torch computes a number over a tensor as the tensor's
    reciprocal times the number, two roundings)."""
    return torch.div(torch.full_like(x, c), x)


# --- the key chains -------------------------------------------------------------------


def _split_each(keys, j):
    """``split(key)[j]`` of each key of ``keys`` (2, n): the hash of the
    counter j."""
    zero = torch.zeros_like(keys[0])
    b1, b2 = tf.hash_counts(keys, zero, zero + j)
    return torch.stack([b1, b2])


def _uniform64_each(keys, lo=0.0, hi=1.0):
    """jax's scalar float64 uniform under each key of ``keys`` (2, n)."""
    zero = torch.zeros_like(keys[0])
    b1, b2 = tf.hash_counts(keys, zero, zero)
    return tf.uniform64_from_bits((b1 << 32) | b2, lo, hi)


def _normal64_each(keys):
    """jax's scalar float64 normal under each key of ``keys`` (2, n)."""
    return tf.SQRT2 * torch.erfinv(_uniform64_each(keys, tk.NORMAL_LO, 1.0))


def _uniform(key, n, dtype):
    """jax's uniforms in [0, 1) at the counters 0..n-1 under ``key``."""
    return tk.plain(key, n, tk.UNIFORM64 if dtype == F64 else tk.UNIFORM32)


def _split(key, num):
    return tk.plain(key, num, tk.KEYS)


# --- the gamma loops (jax/_src/random.py:1298 _gamma_one, :1398 _gamma_impl) ---------


def _gamma_cond(X, V, U, d):
    return (U >= 1.0 - 0.0331 * (X * X)) & (
        torch.log(U) >= X * 0.5 + d * ((1.0 - V) + torch.log(V)))


def gamma_loops(key, alpha, log_space=False, tally=None, passes=None):
    """jax's standard gamma (``loggamma`` with ``log_space``) of each
    element of ``alpha`` (float64, flat) under ``split(key, n)[i]``, in
    float64: the plain version of the gamma kernel.  Each element hashes
    its own keys; ``tally`` gets the hashes its draw reads: its key and
    the loop's key; the boost's subkey and uniform only where the draw is
    boosted (alpha below 1, or NaN); 3 an outer pass (its two keys, U) and
    1 more where another outer pass follows (the next key); 2 an inner
    pass (the normal's key and bits) and 1 more where another inner pass
    follows.  ``passes`` gets the outer and inner passes and the boosted
    draws (``"outer"``, ``"inner"``, ``"boosted"``)."""
    n = alpha.numel()
    keys = _split(key, n).T.contiguous()
    boost = alpha >= 1.0
    if tally is not None:
        tally.append(2 * n + 2 * (~boost).sum())
    if passes is not None:
        passes.update(outer=0, inner=0, boosted=int((~boost).sum()))
    alpha_b = torch.where(boost, alpha, alpha + 1.0)
    d = alpha_b - THIRD
    c = true_div(THIRD, torch.sqrt(d))
    kk, subkey = _split_each(keys, 0), _split_each(keys, 1)
    X = torch.zeros_like(alpha)
    V = torch.ones_like(alpha)
    U = torch.full_like(alpha, 2.0)
    live = _gamma_cond(X, V, U, d)
    it = 0
    while it < MAX_ITERS and bool(live.any()):
        _tally(tally, 0, 3, live)
        if passes is not None:
            passes["outer"] += int(live.sum())
        nk, xk, uk = (_split_each(kk, j) for j in range(3))
        x, v = torch.zeros_like(alpha), torch.full_like(alpha, -1.0)
        inner, jt = live.clone(), 0
        while jt < MAX_ITERS and bool(inner.any()):
            _tally(tally, 0, 2, inner)
            if passes is not None:
                passes["inner"] += int(inner.sum())
            xk_next, sub = _split_each(xk, 0), _split_each(xk, 1)
            xn = _normal64_each(sub)
            x = torch.where(inner, xn, x)
            v = torch.where(inner, 1.0 + xn * c, v)
            xk = torch.where(inner, xk_next, xk)
            inner = inner & (v <= 0.0)
            jt += 1
            if jt < MAX_ITERS:
                # the next key, where another inner pass reads it
                _tally(tally, 0, 1, inner)
        X = torch.where(live, x * x, X)
        V = torch.where(live, (v * v) * v, V)
        U = torch.where(live, _uniform64_each(uk), U)
        kk = torch.where(live, nk, kk)
        live = live & _gamma_cond(X, V, U, d)
        it += 1
        if it < MAX_ITERS:
            _tally(tally, 0, 1, live)
    if log_space:
        # -exponential(subkey) = -(-log1p(-u))
        log_samples = -(-torch.log1p(-_uniform64_each(subkey)))
        log_boost = torch.where(boost | (log_samples == 0), 0.0, log_samples * true_div(1.0, alpha))
        return (torch.log(d) + torch.log(V)) + log_boost
    samples = 1.0 - _uniform64_each(subkey)
    return (d * V) * torch.where(boost, 1.0, torch.pow(samples, true_div(1.0, alpha)))


# --- Poisson (random.py:1547 _poisson_knuth, :1572 _poisson_rejection, :1600) -----


def _poisson_knuth(key, lam, tally=None):
    n = lam.numel()
    k = torch.zeros(n, dtype=torch.int64, device=lam.device)
    log_prod = torch.zeros(n, dtype=F32, device=lam.device)
    it = 0
    while it < MAX_ITERS:
        live = log_prod > -lam
        if not bool(live.any()):
            break
        _tally(tally, 2, 1, live)
        keys = _split(key, 2)
        key = keys[0]
        k = torch.where(live, k + 1, k)
        log_prod = log_prod + torch.log(_uniform(keys[1], n, F32))
        it += 1
    return k - 1


def _poisson_rejection(key, lam, tally=None, every_pass=None):
    # every_pass: the elements whose draw is this loop's (not those on
    # the dummy lam, which only set the pass count)
    n = lam.numel()
    log_lam = torch.log(lam)
    b = 0.931 + 2.53 * torch.sqrt(lam)
    a = -0.059 + 0.02483 * b
    inv_alpha = 1.1239 + true_div(1.1328, b - 3.4)
    v_r = 0.9277 - true_div(3.6224, b - 2)
    k_out = torch.full_like(lam, -1.0)
    accepted = torch.zeros(n, dtype=torch.bool, device=lam.device)
    count_hashes = _RejectionTally(tally, every_pass) if tally is not None else None
    it = 0
    while it < MAX_ITERS and not bool(accepted.all()):
        if count_hashes is not None:
            count_hashes.before(accepted)
        keys = _split(key, 3)
        key = keys[0]
        u = _uniform(keys[1], n, F32) - 0.5
        v = _uniform(keys[2], n, F32)
        u_shifted = 0.5 - torch.abs(u)
        k = torch.floor((2 * a / u_shifted + b) * u + lam + 0.43)
        s = torch.log(v * inv_alpha / (a / (u_shifted * u_shifted) + b))
        t = -lam + k * log_lam - torch.lgamma(k + 1)
        accept1 = (u_shifted >= 0.07) & (v <= v_r)
        reject = (k < 0) | ((u_shifted < 0.013) & (v > u_shifted))
        accept = accept1 | (~reject & (s <= t))
        if count_hashes is not None:
            count_hashes.after(accepted, accept, it)
        k_out = torch.where(accept, k, k_out)
        accepted = accepted | accept
        it += 1
    if count_hashes is not None:
        count_hashes.end(accepted, it)
    return saturating_cast(k_out, torch.int64)


def poisson_loops(key, lam, tally=None):
    """jax's ``_poisson`` of ``lam`` (float32, flat) under ``key``, as int64:
    the plain version of the Poisson kernel."""
    use_knuth = torch.isnan(lam) | (lam < 10)
    lam_knuth = torch.where(use_knuth, lam, 0.0)
    lam_rejection = torch.where(use_knuth, 1e5, lam)
    # the rejection loop's hashes count only where an element reads its N
    rejection_tally = tally if bool((~use_knuth).any()) else None
    result = torch.where(use_knuth, _poisson_knuth(key, lam_knuth, tally),
                         _poisson_rejection(key, lam_rejection, rejection_tally, ~use_knuth))
    return torch.where(lam == 0, 0, result)


# --- binomial (random.py:2681-2838) --------------------------------------------------


def _stirling_approx_tail(k):
    table = torch.tensor(STIRLING_TAIL, dtype=k.dtype, device=k.device)
    use_tail_values = k <= 9
    k = torch.clamp(k, 0.0, 9.0)
    kp1sq = (k + 1) * (k + 1)
    approx = (1.0 / 12 - (1.0 / 360 - true_div(1.0 / 1260, kp1sq)) / kp1sq) / (k + 1)
    idx = torch.floor(torch.where(torch.isnan(k), 0.0, k)).to(torch.int64)
    return torch.where(use_tail_values, table[idx], approx)


def _binomial_inversion(key, count, prob, tally=None, own=None):
    # own: the elements that take this loop (the others run on a count of 0)
    n = prob.numel()
    log1minusprob = torch.log1p(-prob)
    num_geom = torch.zeros_like(prob)
    geom_sum = torch.zeros_like(prob)
    it = 0
    while it < MAX_ITERS:
        live = geom_sum <= count
        if not bool(live.any()):
            break
        if tally is not None:
            _tally(tally, 2, 1, live & own)
        keys = _split(key, 2)
        key = keys[1]
        num_geom = torch.where(live, num_geom + 1, num_geom)
        u = _uniform(keys[0], n, prob.dtype)
        geom_sum = geom_sum + torch.ceil(torch.log(u) / log1minusprob)
        it += 1
    return num_geom - 1


def _btrs(key, count, prob, tally=None, every_pass=None):
    # every_pass: as in _poisson_rejection
    n = prob.numel()
    stddev = torch.sqrt(count * prob * (1 - prob))
    b = 1.15 + 2.53 * stddev
    a = -0.0873 + 0.0248 * b + 0.01 * prob
    c = count * prob + 0.5
    v_r = 0.92 - true_div(4.2, b)
    r = prob / (1 - prob)
    alpha = (2.83 + true_div(5.1, b)) * stddev
    m = torch.floor((count + 1) * prob)
    k_out = torch.full_like(prob, -1.0)
    accepted = torch.zeros(n, dtype=torch.bool, device=prob.device)
    count_hashes = _RejectionTally(tally, every_pass) if tally is not None else None
    it = 0
    while it < MAX_ITERS and not bool(accepted.all()):
        if count_hashes is not None:
            count_hashes.before(accepted)
        keys = _split(key, 3)
        key = keys[0]
        u = _uniform(keys[1], n, prob.dtype)
        v = _uniform(keys[2], n, prob.dtype)
        u = u - 0.5
        us = 0.5 - torch.abs(u)
        accept1 = (us >= 0.07) & (v <= v_r)
        k = torch.floor((2 * a / us + b) * u + c)
        reject = (k < 0) | (k > count)
        v = torch.log(v * alpha / (a / (us * us) + b))
        ub = ((m + 0.5) * torch.log((m + 1) / (r * (count - m + 1)))
              + (count + 1) * torch.log((count - m + 1) / (count - k + 1))
              + (k + 0.5) * torch.log(r * (count - k + 1) / (k + 1))
              + _stirling_approx_tail(m)
              + _stirling_approx_tail(count - m)
              - _stirling_approx_tail(k)
              - _stirling_approx_tail(count - k))
        accept = accept1 | (~reject & (v <= ub))
        if count_hashes is not None:
            count_hashes.after(accepted, accept, it)
        k_out = torch.where(accept, k, k_out)
        accepted = accepted | accept
        it += 1
    if count_hashes is not None:
        count_hashes.end(accepted, it)
    return k_out


def binomial_loops(key, count, prob, dtype=F64, tally=None):
    """jax's ``_binomial`` of ``count`` and ``prob`` (flat, both in the
    probability's float dtype) under ``key``, in ``dtype``: the plain
    version of the binomial kernel.  An int64 ``dtype`` is the float64
    draw cast as XLA casts it."""
    if dtype == torch.int64:
        return saturating_cast(binomial_loops(key, count, prob, F64, tally), dtype)
    p_lt_half = prob < 0.5
    q = torch.where(p_lt_half, prob, 1.0 - prob)
    count_nan_or_neg = torch.isnan(count) | (count < 0.0)
    count_inf = torch.isinf(count)
    q_is_nan = torch.isnan(q)
    q_l_0 = q < 0.0
    q = torch.where(q_is_nan | q_l_0, 0.01, q)
    use_inversion = count_nan_or_neg | (count * q <= 10.0)
    count = torch.floor(count)
    count_inv = torch.where(use_inversion, count, 0.0)
    count_btrs = torch.where(use_inversion, 1e4, count)
    q_btrs = torch.where(use_inversion, 0.5, q)
    # BTRS's hashes count only where an element reads its N
    btrs_tally = tally if bool((~use_inversion).any()) else None
    samples = torch.where(
        use_inversion, _binomial_inversion(key, count_inv, q, tally, use_inversion).to(dtype),
        _btrs(key, count_btrs, q_btrs, btrs_tally, ~use_inversion).to(dtype))
    invalid = q_l_0 | q_is_nan | count_nan_or_neg
    samples = torch.where(invalid, math.nan, samples)
    samples = torch.where(count_inf & ~invalid, math.inf, samples)
    return torch.where(p_lt_half | count_nan_or_neg | q_is_nan | count_inf, samples,
                       count.to(dtype) - samples)


# --- the samplers (jax's API, float64 by default as under jax_enable_x64) -------------


def _flat(x, shape, dtype):
    """``x`` cast to ``dtype`` (jax's ``convert_element_type``), broadcast
    to ``shape`` and made flat and contiguous for a kernel."""
    return x.to(dtype).expand(shape).reshape(-1).contiguous()


def _gamma(key, a, shape, log_space):
    from pytensor_tpu_torch.link.cuda import gamma_kernel

    shape = tuple(a.shape) if shape is None else tuple(shape)
    a = _flat(a, shape, F64)
    draws = tf.folded(key, a.numel(), lambda k, s: gamma_kernel.draw(k, a, log_space, split=s))
    return draws.reshape(shape)


def gamma(key, a, shape=None):
    """``jax.random.gamma(key, a, shape)`` in float64."""
    return _gamma(key, a, shape, False)


def loggamma(key, a, shape=None):
    """``jax.random.loggamma(key, a, shape)`` in float64."""
    return _gamma(key, a, shape, True)


def poisson(key, lam, shape=None):
    """``jax.random.poisson(key, lam, shape)``: int64 draws of ``lam``
    broadcast to ``shape`` and rounded to float32."""
    from pytensor_tpu_torch.link.cuda import poisson_kernel

    shape = tuple(lam.shape) if shape is None else tuple(shape)
    lam = lam.expand(shape).to(F32).reshape(-1).contiguous()
    return tf.folded(key, lam.numel(),
                     lambda k, s: poisson_kernel.draw(k, lam, split=s)).reshape(shape)


def _inexact_dtype(x):
    return x.dtype if x.is_floating_point() else F64


def binomial(key, n, p, shape=None, dtype=F64):
    """``jax.random.binomial(key, n, p, shape, dtype)``: the draws in the
    float ``dtype``, computed in ``p``'s (inexact) dtype; an int64
    ``dtype`` is the float64 draws cast as XLA casts them (the binomial
    random variables' ``.astype("int64")``), by the kernel itself on the
    card."""
    from pytensor_tpu_torch.link.cuda import binomial_kernel

    if shape is None:
        shape = tuple(torch.broadcast_shapes(n.shape, p.shape))
    shape = tuple(shape)
    pdt = _inexact_dtype(p)
    n, p = _flat(n, shape, pdt), _flat(p, shape, pdt)
    draws = tf.folded(key, p.numel(),
                      lambda k, s: binomial_kernel.draw(k, n, p, dtype, split=s))
    return draws.reshape(shape)


def _reverse_cumsum(p):
    """XLA's reverse cumulative sum on axis 0 (a reduce window): element j
    sums ``p[j:]`` from the left."""
    acc = p.clone()
    for m in range(1, p.shape[0]):
        acc[: p.shape[0] - m] = acc[: p.shape[0] - m] + p[m:]
    return acc


def multinomial(key, n, p, shape=None, dtype=F64):
    """``jax.random.multinomial(key, n, p, shape=shape, dtype=dtype)``: a
    binomial a category on what the earlier ones left, under
    ``split(key, K)[j]``."""
    dt = torch.promote_types(_inexact_dtype(n), _inexact_dtype(p))
    n, p = n.to(dt), p.to(dt)
    shape = tuple(p.shape) if shape is None else tuple(shape)
    remainder = n.expand(shape[:-1])
    p = torch.movedim(p.expand(shape), -1, 0)
    remaining = _reverse_cumsum(p)
    ratios = p / torch.where(remaining == 0, 1.0, remaining)
    keys = tf.split(key, ratios.shape[0])
    counts = []
    for j in range(ratios.shape[0]):
        count = binomial(keys[j], remainder, ratios[j].clip(0, 1), dtype=remainder.dtype)
        remainder = remainder - count
        counts.append(count)
    return torch.movedim(torch.stack(counts), 0, -1).to(dtype)


def beta(key, a, b, shape=None):
    """``jax.random.beta(key, a, b, shape)`` in float64: two loggammas
    scaled by their larger."""
    if shape is None:
        shape = tuple(torch.broadcast_shapes(a.shape, b.shape))
    keys = tf.split(key)
    log_gamma_a = loggamma(keys[0], a.to(F64).expand(shape), shape)
    log_gamma_b = loggamma(keys[1], b.to(F64).expand(shape), shape)
    log_max = torch.maximum(log_gamma_a, log_gamma_b)
    gamma_a_scaled = torch.exp(log_gamma_a - log_max)
    gamma_b_scaled = torch.exp(log_gamma_b - log_max)
    return gamma_a_scaled / (gamma_a_scaled + gamma_b_scaled)


def _sum_last(x):
    """A sum over the last axis, left to right, as XLA's reduce on the CPU."""
    acc = x[..., 0]
    for j in range(1, x.shape[-1]):
        acc = acc + x[..., j]
    return acc[..., None]


def dirichlet(key, alpha, shape=None):
    """``jax.random.dirichlet(key, alpha, shape)`` in float64: a loggamma
    a component, then jax's softmax."""
    if alpha.ndim < 1:
        raise ValueError(f"dirichlet requires alpha.ndim >= 1, got alpha.ndim == {alpha.ndim}")
    batch = tuple(alpha.shape[:-1]) if shape is None else tuple(shape)
    x = loggamma(key, alpha.to(F64), batch + tuple(alpha.shape[-1:]))
    x_max = torch.amax(x, -1, keepdim=True)
    unnormalized = torch.exp(x - x_max)
    return unnormalized / _sum_last(unnormalized)


def t(key, df, shape=None):
    """``jax.random.t(key, df, shape)`` in float64."""
    shape = tuple(df.shape) if shape is None else tuple(shape)
    df = df.to(F64)
    keys = tf.split(key)
    n = tf.normal(keys[0], shape)
    half_df = df / 2
    g = gamma(keys[1], half_df, shape)
    return n * torch.sqrt(half_df / g)


def chisquare(key, df, shape=None):
    """``jax.random.chisquare(key, df, shape)`` in float64."""
    shape = tuple(df.shape) if shape is None else tuple(shape)
    half_df = df.to(F64) / 2
    return torch.exp(loggamma(key, half_df, shape)) * 2

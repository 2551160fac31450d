"""jax's threefry2x32 PRNG, in torch: keys, splits, bits, uniforms, normals.

The JAX package draws through ``jax.random`` (threefry2x32, with
``jax_threefry_partitionable`` on, as in jax 0.9), so the port's draws
are jax's, bit for bit where jax's draw is a closed form of the bits.
This module is the port's copy of what the JAX package takes from
``jax/_src/prng.py`` and ``jax/_src/random.py``:

- ``threefry_2x32`` (``prng.py:1092``): the hash of a flat count array,
  split in two halves as jax splits it;
- ``threefry_seed``: the key ``[seed >> 32, seed & 0xFFFFFFFF]`` of an int;
- ``split`` (``prng.py:1156 _threefry_split_foldlike``): key ``i`` of a
  split into ``num`` is the hash of the counter ``(hi(i), lo(i))``;
- ``random_bits`` (``prng.py:1184 _threefry_random_bits_partitionable``,
  the counters of ``prng.py:989 iota_2x32_shape``, the flat index): the
  32-bit bits are ``b1 ^ b2``, the 64-bit bits ``(b1 << 32) | b2``;
- ``uniform`` and ``normal`` (``random.py:435 _uniform``, ``:867
  _normal_real``).

A key is a tensor of two int64, each a uint32 (the port holds a uint32 in
int64: ``link/torch/convert.py UNSIGNED``); 64-bit bits are int64 of the
same bits.  The hash here is the plain version: int64 torch ops, each
add masked to 32 bits and each rotation a shift of a masked value.  A key
on the CPU takes it; a key on the card takes the threefry kernel
(``link/cuda/threefry_kernel.py``), one launch a draw, and nothing is
read back on the host.  The draws take a ``SplitKey`` too (a random
variable's key with its split deferred, ``RandomVariable.draw``): the
first of them makes the split in its own launch, a kernel's or, on the
CPU, the plain split then the plain draw.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from pytensor_tpu_torch.link.cuda import threefry_kernel as tk

MASK = 0xFFFFFFFF
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
SQRT2 = float(np.sqrt(2.0))


def hash_counts(key, x0, x1):
    """threefry2x32 of the counters ``(x0, x1)`` (int64 tensors of uint32
    values) under ``key``; returns ``(b1, b2)``.  The key's words stay 0-d
    tensors: nothing is read on the host."""
    k0, k1 = key[0], key[1]
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for g in range(5):
        for r in ROTATIONS[g % 2]:
            x0 = (x0 + x1) & MASK
            x1 = ((x1 << r) | (x1 >> (32 - r))) & MASK
            x1 = x1 ^ x0
        x0 = (x0 + ks[(g + 1) % 3]) & MASK
        x1 = (x1 + ks[(g + 2) % 3] + (g + 1)) & MASK
    return x0, x1


def uniform64_from_bits(bits, lo, hi):
    """jax's float64 uniform in ``[lo, hi)`` from 64-bit bits (int64)."""
    f = (((bits >> 12) & ((1 << 52) - 1)) | 0x3FF0000000000000).view(torch.float64) - 1.0
    return torch.clamp_min(f * (hi - lo) + lo, lo)


def uniform32_from_bits(bits, lo, hi):
    """jax's float32 uniform in ``[lo, hi)`` from 32-bit bits (int64)."""
    flo, fhi = np.float32(lo), np.float32(hi)
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(f * float(fhi - flo) + float(flo), float(flo))


# --- jax's API -----------------------------------------------------------------

def as_key(key) -> torch.Tensor:
    """A key as the port holds it: two int64 on the key's device (a
    ``SplitKey``'s draw key, made if no draw made it)."""
    if isinstance(key, SplitKey):
        return key.key()
    if isinstance(key, torch.Tensor):
        return key.to(torch.int64).contiguous()
    return torch.as_tensor(np.asarray(key, dtype=np.uint32).astype(np.int64))


def threefry_seed(seed: int) -> torch.Tensor:
    """jax's key of an integer seed: ``[seed >> 32, seed & 0xFFFFFFFF]`` of
    its 64 bits (``jax.random.PRNGKey``)."""
    seed = int(seed) % 2 ** 64
    return torch.tensor([(seed >> 32) & MASK, seed & MASK], dtype=torch.int64)


def threefry_2x32(key, count) -> torch.Tensor:
    """jax's ``threefry_2x32(keypair, count)``: the flat count (uint32
    values) padded to an even length, its halves hashed as the pairs
    ``(x0[j], x1[j])``, the results joined and cut back (plain version)."""
    key = as_key(key)
    count = torch.as_tensor(count).to(torch.int64)
    flat = count.reshape(-1)
    odd = flat.shape[0] % 2
    if odd:
        flat = torch.cat([flat, flat.new_zeros(1)])
    half = flat.shape[0] // 2
    b1, b2 = hash_counts(key, flat[:half], flat[half:])
    out = torch.cat([b1, b2])
    return (out[:-1] if odd else out).reshape(count.shape)


class SplitKey:
    """``split(parent)`` not made yet: a random variable's draw key
    ``split(parent)[1]`` and its next key ``split(parent)[0]``.

    ``fold`` runs the first non-empty draw under it as a draw that makes
    the split itself (one launch on the card, the plain split then the
    plain draw on the CPU) and keeps the split; ``key`` and ``next_key``
    read it, making it by a draw of keys (one launch on the card) if no
    draw did.
    """

    def __init__(self, parent):
        self.parent = parent
        self.keys = None

    @property
    def device(self):
        return self.parent.device

    def fold(self, n, fn):
        """``fn(key, split)``: with this split not made and ``n`` draws,
        ``fn(parent, split)`` draws under ``split(parent)[1]`` and writes
        ``split(parent)`` into ``split``, a new (2, 2) int64 tensor; an
        empty draw, which reads no key, ``fn(parent, None)``; else
        ``fn(self.key(), None)``."""
        if n <= 0:
            return fn(self.parent, None)
        if self.keys is not None:
            return fn(self.key(), None)
        keys = torch.empty((2, 2), dtype=torch.int64, device=self.parent.device)
        out = fn(self.parent, keys)
        self.keys = keys
        return out

    def key(self):
        """The draw key, ``split(parent)[1]``."""
        if self.keys is None:
            self.keys = tk.draw(self.parent, 2, tk.KEYS)
        return self.keys[1]

    def next_key(self):
        """The random variable's next key, ``split(parent)[0]``."""
        self.key()
        return self.keys[0]


def folded(key, n, fn):
    """``fn(key, split)`` for a draw of ``n`` under ``key``: a ``SplitKey``
    folds its split into the draw (``SplitKey.fold``); any other key is
    drawn under as it is (``as_key``), with ``split`` None."""
    if isinstance(key, SplitKey):
        return key.fold(n, fn)
    return fn(as_key(key), None)


def _draw(key, n, mode, lo=0.0, hi=1.0):
    """The kernel's ``n`` draws of ``mode`` under ``key`` (its plain
    version for a key on the CPU), a ``SplitKey``'s split folded in."""
    return folded(key, n, lambda k, s: tk.draw(k, n, mode, lo, hi, split=s))


def split(key, num: int = 2) -> torch.Tensor:
    """``num`` new keys from ``key``, as a ``(num, 2)`` tensor; on the card
    one launch of the kernel."""
    return _draw(key, int(num), tk.KEYS)


def _size(shape) -> int:
    return int(math.prod(shape))


def random_bits(key, bit_width: int, shape) -> torch.Tensor:
    """jax's random bits of ``shape``: 32- or 64-bit (int64 of the bits), or
    8- or 16-bit (the 32-bit bits cut to the width)."""
    shape = tuple(int(s) for s in shape)
    if bit_width not in (8, 16, 32, 64):
        raise TypeError("requires 8-, 16-, 32- or 64-bit field width.")
    mode = tk.BITS64 if bit_width == 64 else tk.BITS32
    bits = _draw(key, _size(shape), mode).reshape(shape)
    if bit_width < 32:
        bits = bits & ((1 << bit_width) - 1)
    return bits


def uniform(key, shape, dtype=torch.float64, minval=0.0, maxval=1.0) -> torch.Tensor:
    """jax's ``uniform(key, shape, dtype, minval, maxval)`` in float32 or
    float64.  Python-number bounds are the kernel's; tensor bounds (cast to
    ``dtype``, broadcast) are applied to the draw in ``[0, 1)``, which is
    the same arithmetic."""
    shape = tuple(int(s) for s in shape)
    key = key if isinstance(key, SplitKey) else as_key(key)
    mode = {torch.float64: tk.UNIFORM64, torch.float32: tk.UNIFORM32}.get(dtype)
    if mode is None:
        raise TypeError(f"uniform draws float32 or float64, not {dtype}")
    if isinstance(minval, torch.Tensor) or isinstance(maxval, torch.Tensor):
        lo = torch.as_tensor(minval).to(dtype=dtype, device=key.device)
        hi = torch.as_tensor(maxval).to(dtype=dtype, device=key.device)
        f = _draw(key, _size(shape), mode).reshape(shape)
        return torch.maximum(f * (hi - lo) + lo, lo)
    if dtype == torch.float32:
        minval, maxval = float(np.float32(minval)), float(np.float32(maxval))
    return _draw(key, _size(shape), mode, float(minval), float(maxval)).reshape(shape)


def normal(key, shape, dtype=torch.float64) -> torch.Tensor:
    """jax's standard ``normal``: ``sqrt(2) erfinv(u)``, ``u`` uniform in
    ``[nextafter(-1, 0), 1)``; in float64 one launch of the kernel on the
    card."""
    shape = tuple(int(s) for s in shape)
    if dtype == torch.float64:
        return _draw(key, _size(shape), tk.NORMAL64).reshape(shape)
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
    u = uniform(key, shape, dtype, lo, 1.0)
    return torch.erfinv(u) * float(np.float32(SQRT2))

"""RandomStream and the shared RNG variables.

Counterpart of ``pytensor_tpu/tensor/random/utils.py``
(``RandomGeneratorSharedVariable``, ``rng_shared``, the
``np.random.Generator`` shared constructor, ``default_rng_variable``,
``default_rng`` and ``RandomStream:49``).  Each sampler call of a
``RandomStream`` makes a fresh shared key whose ``default_update`` is the
op's next key, so a compiled function advances the key on every call
(``compile/rebuild.py``).  The seeds are the JAX package's: key ``j`` of a
stream comes from ``np.random.SeedSequence(seed).spawn(1)`` taken ``j``
times, ``generate_state(1)[0] & 0x7FFFFFFF``, so both packages start from
the same keys.  A shared key lives on an explicit device, the card unless
the caller asks for another, as every entry point of the port.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.compile.sharedvalue import SharedVariable
from pytensor_tpu_torch.tensor.random.type import random_generator_type


class RandomGeneratorSharedVariable(SharedVariable):
    """A shared threefry key: two int64 (each a uint32) on its device."""

    __slots__ = ()

    def get_value(self, borrow=False):
        """The key as a uint32 tensor of two words (a copy), or with
        ``borrow`` the int64 tensor itself."""
        from pytensor_tpu_torch.link.torch.convert import unheld

        v = self.storage[0]
        return v if borrow else unheld(v.clone(), "uint32")

    def set_value(self, new_value):
        """A new key: anything ``RandomGeneratorType.filter`` takes (an int
        seed, a ``np.random.Generator``, the JAX package's ``uint32[2]``
        key, a tensor of one), on this variable's device."""
        from pytensor_tpu_torch.link.torch.convert import as_torch

        self.storage[0] = as_torch(random_generator_type.filter(new_value), self.device)

    def __str__(self):
        return self.name or f"RNG({id(self.storage):x})"


def rng_shared(seed_or_key, name=None, *, device="cuda"):
    """A shared key from a seed, a generator or a key, on ``device``."""
    from pytensor_tpu_torch.link.torch.convert import as_torch

    key = as_torch(random_generator_type.filter(seed_or_key), device)
    return RandomGeneratorSharedVariable(random_generator_type, key, name=name)


_default_counter = [0]


def default_rng_variable(device="cuda"):
    """The fresh shared key of an RV built without an ``rng``."""
    _default_counter[0] += 1
    seed = np.random.SeedSequence(_default_counter[0]).generate_state(1)[0] & 0x7FFFFFFF
    return rng_shared(int(seed), device=device)


def default_rng(seed=None, *, device="cuda"):
    return rng_shared(0 if seed is None else seed, device=device)


class RandomStream:
    """Factory of seeded samplers with automatic state updates; its keys
    live on ``device``."""

    def __init__(self, seed=None, namespace=None, *, device="cuda"):
        self.seed_generator = np.random.SeedSequence(seed)
        self.state_updates: list = []
        self.default_instance_seed = seed
        self.device = device
        from pytensor_tpu_torch.tensor import random as _random_ns

        self.namespaces = [namespace if namespace is not None else _random_ns]

    def updates(self):
        return list(self.state_updates)

    def seed(self, seed=None):
        self.seed_generator = np.random.SeedSequence(seed)
        for rng_var, _ in self.state_updates:
            (new_seed,) = self.seed_generator.spawn(1)
            rng_var.set_value(int(new_seed.generate_state(1)[0] & 0x7FFFFFFF))

    def gen(self, op, *args, **kwargs):
        (seed,) = self.seed_generator.spawn(1)
        rng = rng_shared(int(seed.generate_state(1)[0] & 0x7FFFFFFF), device=self.device)
        rng.tag.is_rng = True
        out = op(*args, rng=rng, **kwargs)
        out.rng = rng
        next_rng = out.owner.outputs[0]
        rng.default_update = next_rng
        out.update = (rng, next_rng)
        self.state_updates.append((rng, next_rng))
        return out

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        for ns in self.namespaces:
            op = getattr(ns, name, None)
            if op is not None and callable(op):
                def sampler(*args, **kwargs):
                    return self.gen(op, *args, **kwargs)

                sampler.__name__ = name
                return sampler
        raise AttributeError(f"RandomStream has no sampler {name!r}")

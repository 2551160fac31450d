"""Random variables: jax's threefry draws in torch.

Counterpart of ``pytensor_tpu/tensor/random/__init__.py``, with the same
names: the distributions of ``basic``, ``RandomVariable``, the RNG type,
``RandomStream``, ``default_rng``, ``shared_rng`` and ``rng``, and the
lift rewrites of ``rewriting``.  ``threefry`` holds the port's copy of
jax's threefry2x32, which the draws come from.
"""

from pytensor_tpu_torch.tensor.random import basic  # noqa: F401
from pytensor_tpu_torch.tensor.random.basic import *  # noqa: F401,F403
from pytensor_tpu_torch.tensor.random.op import RandomVariable  # noqa: F401
from pytensor_tpu_torch.tensor.random.type import (  # noqa: F401
    RandomGeneratorType,
    random_generator_type,
)
from pytensor_tpu_torch.tensor.random.utils import RandomStream, default_rng  # noqa: F401
from pytensor_tpu_torch.tensor.random import op, threefry, type, utils  # noqa: F401,E402


def shared_rng(seed=None, name=None, *, device="cuda"):
    """A shared RNG key (the JAX package's ``random.shared_rng``)."""
    out = default_rng(seed, device=device)
    if name:
        out.name = name
    return out


rng = shared_rng

from pytensor_tpu_torch.tensor.random import rewriting, variable  # noqa: F401,E402

"""The RNG variable's type (counterpart of ``pytensor_tpu/tensor/random/variable.py``)."""

from pytensor_tpu_torch.tensor.random.type import (  # noqa: F401
    RandomGeneratorType,
    random_generator_type,
)

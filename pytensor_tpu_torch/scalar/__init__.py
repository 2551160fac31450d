"""Scalar op descriptors."""

from pytensor_tpu_torch.scalar.basic import *  # noqa: F401,F403

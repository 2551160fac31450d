"""Tensor exceptions (counterpart of ``pytensor_tpu/tensor/exceptions.py``)."""

from pytensor_tpu_torch.tensor.basic import NotScalarConstantError  # noqa: F401


class ShapeError(Exception):
    """A shape-related error during graph construction or inference."""


class AdvancedIndexingError(Exception):
    """Malformed advanced-indexing pattern."""

"""Device transfer (PyTensor's tensor/transfer.py).

Counterpart of ``pytensor_tpu/tensor/transfer.py``: a function is linked
for one explicit device (``function(..., device=)``), so ``transfer`` is
the identity at graph level.
"""

from __future__ import annotations


def transfer(var, target=None):
    """Return ``var`` unchanged at graph level: placement is decided by
    the device the function is linked for, not per-op transfers."""
    from pytensor_tpu_torch.tensor.basic import as_tensor_variable

    return as_tensor_variable(var)

"""Shared variables: graph variables with a persistent torch tensor.

Counterpart of ``pytensor_tpu/compile/sharedvalue.py`` (SharedVariable:20,
shared:75), with its ``default_update``.  A shared variable holds a torch
tensor on one explicit device, in a one-element ``storage`` list that its
clones share.  A function that updates it writes the new value into that
tensor in place (``copy_``), so the tensor object a caller holds sees
every update.
``set_value`` puts a new tensor in the storage, on the variable's device.
A pickle holds the value and its device; loading it where that device is
absent raises.
"""

from __future__ import annotations

import torch

from pytensor_tpu_torch.graph.basic import Variable


class SharedVariable(Variable):
    """A Variable whose value lives in ``storage[0]``, a torch tensor."""

    __slots__ = ("storage", "default_update")

    def __init__(self, type, value: torch.Tensor, name=None, storage=None):
        super().__init__(type, None, None, name)
        self.storage = storage if storage is not None else [value]
        # the value a function writes into it when the caller's updates do
        # not name it (a RandomStream's key: its next key)
        self.default_update = None

    @property
    def device(self) -> torch.device:
        return self.storage[0].device

    def get_value(self, borrow=False) -> torch.Tensor:
        """The value: a copy, or with ``borrow`` the tensor itself."""
        v = self.storage[0]
        return v if borrow else v.clone()

    def set_value(self, new_value):
        """Replace the value with ``new_value``, on this variable's device."""
        from pytensor_tpu_torch.link.torch.convert import as_torch, torch_dtype

        v = as_torch(new_value, self.device)
        if v.dtype != torch_dtype(self.type.dtype) or v.ndim != self.type.ndim or any(
                s is not None and s != d for s, d in zip(self.type.shape, v.shape)):
            raise TypeError(f"value of dtype {v.dtype} and shape {tuple(v.shape)} "
                            f"does not fit {self.type}")
        self.storage[0] = v

    def snapshot(self):
        """A new shared variable of the same type holding a copy of the
        value on the same device, with no default update."""
        return self.__class__(self.type, self.storage[0].clone(), name=self.name)

    def __reduce__(self):
        # the value pickles with its device: loading it where that device
        # is absent raises (resolve_device), it never lands elsewhere
        value = self.storage[0].detach().cpu()
        return (_load_shared, (self.__class__, self.type, value, str(self.device)),
                {"name": self.name, "default_update": self.default_update})

    def __setstate__(self, state):
        self.name = state["name"]
        self.default_update = state["default_update"]

    def clone(self, **kwargs):
        cp = self.__class__(self.type, None, name=self.name, storage=self.storage)
        cp.tag.__update__(self.tag)
        cp.default_update = self.default_update
        return cp

    def __str__(self):
        return self.name or f"shared_{self.auto_name}"


def _load_shared(cls, type, value, device):
    """A pickled shared variable, its value on its recorded device."""
    from pytensor_tpu_torch.link.torch.convert import resolve_device

    return cls(type, value.to(resolve_device(device)))


def shared(value, name=None, *, device, borrow=False, shape=None):
    """A tensor shared variable holding ``value`` on ``device``.

    ``value`` is a numpy array, a Python or numpy scalar, or a torch
    tensor (moved, never cast).  Its static shape is fully unknown, as in
    the JAX package, unless ``shape`` gives it; with ``borrow`` a torch
    tensor already on ``device`` is held without a copy.  A
    ``np.random.Generator`` makes a shared RNG key, as in the JAX package
    (``tensor/random/utils.py rng_shared``).
    """
    import numpy as np

    from pytensor_tpu_torch.tensor.sharedvar import tensor_shared_constructor

    if isinstance(value, np.random.Generator):
        from pytensor_tpu_torch.tensor.random.utils import rng_shared

        return rng_shared(value, name=name, device=device)

    return tensor_shared_constructor(value, name=name, borrow=borrow, shape=shape,
                                     device=device)

"""RNG state as a graph value: a threefry key.

Counterpart of ``pytensor_tpu/tensor/random/type.py``
(``RandomGeneratorType:17``, ``TensorFromKey:57``, ``KeyFromTensor:81``).
The value of an RNG variable is a threefry2x32 key, two uint32 words:
on the host a numpy ``uint32[2]`` array, in a plan and in a shared
variable a tensor of two int64 on the function's device (the port holds a
uint32 in int64: ``link/torch/convert.py UNSIGNED``).  So the type
carries the dtype ``uint32`` and the shape ``(2,)`` of its value, which
the linker's conversions of inputs and outputs read.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.graph.type import Type


def _seed_key(seed: int) -> np.ndarray:
    """jax's ``PRNGKey(seed)``: the two words of the seed's 64 bits."""
    seed = int(seed) % 2 ** 64
    return np.array([seed >> 32, seed & 0xFFFFFFFF], dtype=np.uint32)


class RandomGeneratorType(Type):
    """Type of PRNG-key values (uint32[2] threefry keys)."""

    __props__ = ()
    dtype = "uint32"
    shape = (2,)
    ndim = 1
    numpy_dtype = np.dtype("uint32")

    def filter(self, data, strict=False, allow_downcast=None):
        """An int (jax's ``PRNGKey``), a ``np.random.Generator`` (a key of
        one draw from its bit stream, as in the JAX package), a uint32 pair
        or a tensor of one."""
        import torch

        if isinstance(data, (int, np.integer)):
            return _seed_key(int(data))
        if isinstance(data, np.random.Generator):
            return _seed_key(int(data.integers(0, 2 ** 31 - 1)))
        if isinstance(data, torch.Tensor) and tuple(data.shape) == (2,) and not (
                data.is_floating_point() or data.is_complex()):
            return data.detach().cpu().to(torch.int64).numpy().astype(np.uint32)
        arr = np.asarray(data)
        if arr.dtype == np.uint32 and arr.shape == (2,):
            return arr
        raise TypeError(f"Cannot interpret {type(data)} as a PRNG key")

    def values_eq(self, a, b):
        return bool(np.array_equal(np.asarray(a), np.asarray(b)))

    def make_constant_signature(self, data):
        return np.asarray(data).tobytes()

    def __str__(self):
        return "RandomGeneratorType"


random_generator_type = RandomGeneratorType()
RandomType = RandomGeneratorType


class TensorFromKey(Op):
    """RNG key -> uint32[2] tensor (the identity when linked; lets Scan
    trace each step's key for the gradient's replay)."""

    __props__ = ()

    def make_node(self, rng):
        from pytensor_tpu_torch.tensor.type import TensorType

        if not isinstance(rng.type, RandomGeneratorType):
            raise TypeError("expected an RNG variable")
        return Apply(self, [rng], [TensorType("uint32", (2,))()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(inputs[0], dtype=np.uint32)

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import grad_undefined

        return [grad_undefined(self, 0, inputs[0], "RNG key")]


class KeyFromTensor(Op):
    """uint32[2] tensor -> RNG key (the inverse of TensorFromKey)."""

    __props__ = ()

    def make_node(self, t):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        t = as_tensor_variable(t)
        return Apply(self, [t], [random_generator_type()])

    def perform(self, node, inputs, output_storage):
        output_storage[0][0] = np.asarray(inputs[0], dtype=np.uint32)

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import grad_undefined

        return [grad_undefined(self, 0, inputs[0], "RNG key")]


tensor_from_key = TensorFromKey()
key_from_tensor = KeyFromTensor()

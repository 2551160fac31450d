"""The lowerings of ``tensor/random``: RandomVariable, TensorFromKey and
KeyFromTensor.

Counterpart of the JAX package's lowerings at
``pytensor_tpu/tensor/random/utils.py:97-121`` and ``type.py:106-115``.
A RandomVariable's function splits its key and runs the op's sampler on
the second key (``RandomVariable.draw``), the split deferred to the
sampler's first draw: on the card a uniform or normal is one launch of the
threefry kernel (``link/cuda/threefry_kernel.py``) that also makes the
split; gamma, poisson and binomial are one launch of their kernel
(``link/cuda/{gamma,poisson,binomial}_kernel.py``) that makes it likewise;
a sampler that splits its key again (beta, t, betabinom,
negative_binomial, multinomial) makes the deferred split and its own in
one threefry launch.  The key is never read on the host, so
a plan holding draws may be captured into a CUDA graph.  ``size`` is read
on the host (a constant, as the JAX package's ``_concrete(size, "rv
size")`` requires, or a shape value), and so are the parameters a sampler
reads as Python ints (``RandomVariable.host_params``); hypergeometric's
sampler runs numpy on the host and declares ``reads_back``.  The two key ops are identities:
a key is two int64 on the device either way.
"""

from __future__ import annotations

from pytensor_tpu_torch.link.torch.dispatch import ports, torch_funcify
from pytensor_tpu_torch.tensor.random.op import RandomVariable
from pytensor_tpu_torch.tensor.random.type import KeyFromTensor, TensorFromKey


@torch_funcify.register(RandomVariable)
@ports(host=lambda node: (1, *(2 + k for k in node.op.host_params)),
       reads_back=lambda node: node.op.reads_back)
def _random_variable(op, node=None, **kw):
    out_dtype = node.outputs[1].type.dtype

    def random_variable(rng, size, *params):
        shape = None if size is None else tuple(int(s) for s in size.tolist())
        return op.draw(rng, shape, params, out_dtype)

    return random_variable


@torch_funcify.register(TensorFromKey)
@torch_funcify.register(KeyFromTensor)
def _key_identity(op, node=None, **kw):
    return lambda key: key

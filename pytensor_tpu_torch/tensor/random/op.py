"""RandomVariable: the sampler op.

Counterpart of ``pytensor_tpu/tensor/random/op.py`` (``RandomVariable:88``,
the per-distribution class names of ``:36-85``, ``ScipyRandomVariable:259``
and ``normalize_size_param:264``): a gufunc-signature sampler with inputs
``(rng, size, *dist_params)`` and outputs ``(next_rng, draws)``
(``default_output=1``).  A draw follows the JAX package's order
(``op.py:205``, ``utils.py:112``): ``next_key, sample_key = split(key)``,
then the sampler on ``sample_key``.  The sampler is a function of torch
tensors in place of the JAX package's ``jax_sampler``: it draws through
``tensor/random/threefry.py``, so on the card its bits are the threefry
kernel's.  A distribution whose jax sampler is a loop (gamma, poisson,
binomial and the nine built on them) draws through
``tensor/random/samplers.py``: on the card the gamma, Poisson and binomial
kernels, on the CPU their plain torch loops.  ``perform`` (the oracle)
runs the same sampler on the CPU, on the plain threefry and the plain
loops.  A float draw cast to an integer dtype is cast as XLA casts it
(toward zero, NaN to 0, out of range to the nearest end).
"""

from __future__ import annotations

from typing import Callable, Sequence

import numpy as np

from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.graph.basic import Apply, Variable
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.tensor.basic import (
    NotScalarConstantError,
    as_tensor_variable,
    cast,
    constant,
)
from pytensor_tpu_torch.tensor.elemwise import broadcast_static_shapes
from pytensor_tpu_torch.tensor.random.type import random_generator_type
from pytensor_tpu_torch.tensor.type import TensorType
from pytensor_tpu_torch.tensor.type_other import NoneConst, NoneTypeT

# the JAX package's class names (op.py:36-60): downstream code (PyMC in
# particular) dispatches with ``isinstance(rv.owner.op, NormalRV)``
_RV_CLASS_NAME_OVERRIDES = {
    "multivariate_normal": "MvNormalRV",
    "negative_binomial": "NegBinomialRV",
    "t": "StudentTRV",
    "truncexpon": "TruncExponentialRV",
    "betabinom": "BetaBinomialRV",
    "hypergeometric": "HyperGeometricRV",
    "vonmises": "VonMisesRV",
    "gengamma": "GenGammaRV",
    "invgamma": "InvGammaRV",
    "lognormal": "LogNormalRV",
    "halfnormal": "HalfNormalRV",
    "halfcauchy": "HalfCauchyRV",
    "permutation": "PermutationRV",
}

# the distributions the JAX package derives from ScipyRandomVariable
_SCIPY_RVS = frozenset({
    "halfnormal", "pareto", "gumbel", "cauchy", "halfcauchy",
    "truncexpon", "t", "bernoulli", "negative_binomial", "betabinom",
    "gengamma",
})

_rv_classes: dict = {}
_rv_registry: dict = {}


def _rv_class(name: str) -> type:
    key = _RV_CLASS_NAME_OVERRIDES.get(name)
    if key is None:
        key = "".join(p[0].upper() + p[1:] if p[0].isalpha() else p
                      for p in name.split("_") if p) + "RV"
    cls = _rv_classes.get(key)
    if cls is None:
        base = ScipyRandomVariable if name in _SCIPY_RVS else RandomVariable
        cls = type(key, (base,), {"__module__": __name__})
        _rv_classes[key] = cls
        globals()[key] = cls
    return cls


def _get_rv(name: str):
    """Unpickle hook: distribution singletons by name."""
    if name not in _rv_registry:
        import pytensor_tpu_torch.tensor.random.basic  # noqa: F401
    return _rv_registry[name]


class RandomVariable(Op):
    """A sampler op: ``rv(rng, size, *params) -> (next_rng, draws)``.

    name          distribution name
    ndims_params  core ndim of each parameter
    ndim_supp     core ndim of one draw
    dtype         draw dtype ('floatX' resolves at make_node)
    sampler       fn(key, shape_or_None, *core_params) -> draws, of torch
                  tensors
    reads_back    why the sampler reads the device on the host, or ""
    host_params   the parameters the sampler reads on the host (the length
                  of ``permutation(n)``, the population of ``choice(n)``)
    """

    default_output = 1

    __props__ = ("name", "signature", "dtype")

    def __new__(cls, *args, **kwargs):
        if cls is RandomVariable:
            name = kwargs.get("name", args[0] if args else None)
            if name is not None:
                cls = _rv_class(str(name))
        return object.__new__(cls)

    def __reduce__(self):
        reg = _rv_registry.get(getattr(self, "name", None))
        if reg is not None and reg == self:
            return (_get_rv, (self.name,))
        return super().__reduce__()

    def __init__(self, name: str, ndims_params: Sequence[int], ndim_supp: int,
                 dtype: str, sampler: Callable, param_dtypes=None,
                 defaults: Sequence = (), reads_back: str = "", host_params=()):
        self.name = name
        self.defaults = tuple(defaults)  # trailing-parameter defaults
        self.ndims_params = tuple(ndims_params)
        self.ndim_supp = int(ndim_supp)
        self.signature = (
            ",".join(f"({','.join('d%d_%d' % (i, j) for j in range(n))})"
                     for i, n in enumerate(self.ndims_params))
            + f"->({','.join('s%d' % j for j in range(self.ndim_supp))})"
        )
        self.dtype = dtype
        self.sampler = sampler
        self.param_dtypes = param_dtypes
        self.reads_back = reads_back
        self.host_params = tuple(host_params)
        _rv_registry.setdefault(self.name, self)

    def _resolve_dtype(self):
        return config.floatX if self.dtype == "floatX" else self.dtype

    def make_node(self, rng, size, *dist_params):
        if rng is None:
            from pytensor_tpu_torch.tensor.random.utils import default_rng_variable

            rng = default_rng_variable()
        if not isinstance(rng.type, type(random_generator_type)):
            raise TypeError("rng must be a RandomGeneratorType variable")
        size = normalize_size_param(size)
        dist_params = [as_tensor_variable(p) for p in dist_params]
        if self.param_dtypes is not None:
            dist_params = [
                cast(p, d if d != "floatX" else config.floatX)
                if p.type.dtype != (d if d != "floatX" else config.floatX) else p
                for p, d in zip(dist_params, self.param_dtypes)
            ]
        else:
            dist_params = [cast(p, "float32") if p.type.dtype == "float16" else p
                           for p in dist_params]

        out_dtype = self._resolve_dtype()
        static_shape = self._static_out_shape(size, dist_params)
        draws = TensorType(out_dtype, static_shape)()
        next_rng = random_generator_type()
        return Apply(self, [rng, size, *dist_params], [next_rng, draws])

    def _static_out_shape(self, size, dist_params):
        if not isinstance(size.type, NoneTypeT):
            n = size.type.shape[0]
            if n is None:
                raise TypeError("size must have a static length")
            from pytensor_tpu_torch.tensor.basic import get_scalar_constant_value

            dims = []
            for i in range(n):
                try:
                    dims.append(int(get_scalar_constant_value(size[i])))
                except NotScalarConstantError:
                    dims.append(None)
            batch = tuple(dims)
        else:
            batch_shapes = []
            for p, nd in zip(dist_params, self.ndims_params):
                bs = p.type.shape[: p.type.ndim - nd] if nd else p.type.shape
                batch_shapes.append(bs)
            batch = broadcast_static_shapes(*batch_shapes) if batch_shapes else ()
        return tuple(batch) + self._supp_shape(dist_params)

    def _supp_shape(self, dist_params):
        """Static support shape, from the first parameter with core dims."""
        if self.ndim_supp == 0:
            return ()
        for p, nd in zip(dist_params, self.ndims_params):
            if nd >= self.ndim_supp:
                return p.type.shape[p.type.ndim - self.ndim_supp:]
        return (None,) * self.ndim_supp

    def draw(self, key, shape, params, out_dtype):
        """``(next_key, draws)`` from ``key`` (two int64 on any device) and
        torch parameters: the JAX package's split, then the sampler on the
        second key, the draws cast to ``out_dtype``."""
        from pytensor_tpu_torch.link.torch.convert import torch_dtype
        from pytensor_tpu_torch.tensor.random.samplers import saturating_cast
        from pytensor_tpu_torch.tensor.random.threefry import split

        keys = split(key)
        draws = self.sampler(keys[1], shape, *params)
        return keys[0], saturating_cast(draws, torch_dtype(out_dtype))

    def perform(self, node, inputs, output_storage):
        import torch

        from pytensor_tpu_torch.link.torch.convert import as_torch, to_numpy

        rng, size, *params = inputs
        key = torch.as_tensor(np.asarray(rng, dtype=np.uint32).astype(np.int64))
        shape = None if size is None else tuple(int(s) for s in size)
        next_key, draws = self.draw(key, shape, [as_torch(p, "cpu") for p in params],
                                    node.outputs[1].type.dtype)
        output_storage[0][0] = next_key.numpy().astype(np.uint32)
        output_storage[1][0] = np.asarray(to_numpy(draws),
                                          dtype=node.outputs[1].type.numpy_dtype)

    def infer_shape(self, fgraph, node, input_shapes):
        raise NotImplementedError()

    def connection_pattern(self, node):
        return [[True, True]] + [[False, True] for _ in node.inputs[1:]]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import grad_undefined

        return [grad_undefined(self, i, inp, "random draws are not differentiable")
                for i, inp in enumerate(inputs)]

    def __call__(self, *args, rng=None, size=None, name=None, **kwargs):
        """Distribution-style call: ``rv(param1, param2, size=..., rng=...)``;
        missing trailing parameters take the distribution's defaults."""
        n = len(self.ndims_params)
        if len(args) < n and self.defaults:
            need = n - len(args)
            if need <= len(self.defaults):
                args = tuple(args) + tuple(self.defaults[-need:])
        if len(args) != n:
            raise TypeError(
                f"{self.name} expects {n} distribution parameters "
                f"({n - len(self.defaults)} required), got {len(args)}")
        node = self.make_node(rng, size, *args)
        out = node.outputs[1]
        if name:
            out.name = name
        return out

    def __str__(self):
        return f"{self.name}_rv"


class ScipyRandomVariable(RandomVariable):
    """Marker base of the scipy-distribution samplers of the JAX package's
    reference (``op.py:259``)."""


def normalize_size_param(size):
    from pytensor_tpu_torch.tensor.basic import MakeVector

    if size is None or (isinstance(size, Variable) and isinstance(size.type, NoneTypeT)):
        return NoneConst
    if isinstance(size, (int, np.integer)):
        size = (int(size),)
    if isinstance(size, (list, tuple)):
        if len(size) == 0:
            return constant(np.zeros((0,), dtype="int64"))
        entries = [cast(as_tensor_variable(s), "int64") for s in size]
        return MakeVector("int64")(*entries)
    size = as_tensor_variable(size)
    if size.type.ndim == 0:
        return MakeVector("int64")(cast(size, "int64"))
    return cast(size, "int64") if size.type.dtype != "int64" else size

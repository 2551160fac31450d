"""Typed configuration flags.

The port's copy of the config system (PyTensor's configparser.py:65
``PyTensorConfigParser`` and configdefaults.py), cut to the flags the
port reads: ``floatX``, ``cast_policy``, ``mode``, ``sparse__routed_spmv``,
``scan__pallas``, ``xla__jit``, ``profile``, ``profile_optimizer``,
``matmul_precision`` and ``xla__matmul_precision``.  A flag's value
comes from ``PYTENSOR_TPU_TORCH_FLAGS`` (``name=value,...``) if set there,
else its default, and may be assigned later or set for a block with
``config.change_flags``.  The device is not a flag: it is an argument of
the linker (``link.torch.linker.fgraph_to_torch``) and of ``function``.
``scan__unroll`` is not ported: eager torch has no loop to unroll.

The two precision flags keep the JAX package's names and values and set
what a plan linked for a CUDA device runs its products with
(``matmul_settings``, read by ``link/torch/linker.py Plan.execute``):
``"default"``, ``"highest"`` and ``"float32"`` full float32 (TF32 off)
and bfloat16 products reduced in float32; ``"high"`` and
``"tensorfloat32"`` TF32 on; ``"bfloat16"`` torch's ``"medium"``, TF32
on and bfloat16 reductions allowed.  ``xla__matmul_precision`` wins where
it is not ``"default"``.
"""

from __future__ import annotations

import contextlib
import os
from typing import Any


class EnumStr:
    """A string flag with a fixed set of allowed values, the first the default."""

    def __init__(self, default, options, doc=""):
        self.default = default
        self.options = (default, *options)
        self.doc = doc
        self.name = "<unset>"

    def parse(self, value):
        return value

    def validate(self, value):
        if value not in self.options:
            raise ValueError(
                f"Invalid value {value!r} for flag {self.name}; choices: {self.options}"
            )


class BoolParam:
    """A boolean flag; the environment spells it True/False or 1/0."""

    def __init__(self, default: bool, doc=""):
        self.default = default
        self.doc = doc
        self.name = "<unset>"

    def parse(self, value):
        if isinstance(value, str):
            if value.lower() in ("true", "1"):
                return True
            if value.lower() in ("false", "0"):
                return False
        return value

    def validate(self, value):
        if not isinstance(value, bool):
            raise ValueError(f"Invalid value {value!r} for flag {self.name}; a bool")


def _read_env_flags() -> dict[str, str]:
    flags = {}
    raw = os.environ.get("PYTENSOR_TPU_TORCH_FLAGS", "")
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" not in part:
            raise ValueError(f"Invalid PYTENSOR_TPU_TORCH_FLAGS fragment: {part!r}")
        k, v = part.split("=", 1)
        flags[k.strip()] = v.strip()
    return flags


class Config:
    def __init__(self):
        object.__setattr__(self, "_params", {})
        object.__setattr__(self, "_values", {})

    def add(self, name: str, param):
        param.name = name
        self._params[name] = param
        value = param.parse(_read_env_flags().get(name, param.default))
        param.validate(value)
        self._values[name] = value

    @contextlib.contextmanager
    def change_flags(self, **kwargs):
        """Set flags for the duration of a ``with`` block."""
        old = {name: getattr(self, name) for name in kwargs}
        try:
            for name, value in kwargs.items():
                setattr(self, name, value)
            yield
        finally:
            for name, value in old.items():
                setattr(self, name, value)

    def __getattr__(self, name: str) -> Any:
        try:
            return object.__getattribute__(self, "_values")[name]
        except KeyError:
            raise AttributeError(f"No config flag {name!r}") from None

    def __setattr__(self, name: str, value: Any):
        params = object.__getattribute__(self, "_params")
        if name not in params:
            raise AttributeError(f"No config flag {name!r}")
        params[name].validate(value)
        object.__getattribute__(self, "_values")[name] = value


config = Config()

config.add(
    "floatX",
    EnumStr("float32", ("float64", "bfloat16"), doc="Default float dtype for literals."),
)
config.add(
    "cast_policy",
    EnumStr("custom", ("numpy+floatX", "numpy"),
            doc="How python literals are cast (scalar/compatnames.py NumpyAutocaster): "
                "custom, the smallest dtype that holds the value; the name, options "
                "and default are the JAX package's."),
)
config.add(
    "mode",
    EnumStr("FAST_RUN", ("FAST_COMPILE", "PY", "DebugMode", "NanGuardMode"),
            doc="Default compilation mode (compile.mode.get_mode)."),
)
config.add(
    "sparse__routed_spmv",
    BoolParam(True, doc="Rewrite a constant-pattern float32 CSR matvec into "
                        "RoutedSpMV, which runs as the CSR kernel K4 "
                        "(sparse/spmv.py); the name is the JAX package's."),
)
config.add(
    "scan__pallas",
    BoolParam(False, doc="Run every eligible Scan as one whole-loop kernel (K2, "
                         "link/cuda/scan_kernel.py) on a CUDA device; read when a "
                         "function is linked.  The name is the JAX package's."),
)
config.add(
    "xla__jit",
    BoolParam(True, doc="Capture each linked function on a CUDA device into one CUDA "
                        "graph per input signature (link/torch/linker.py TorchLinker); "
                        "off = eager, for debugging.  Read when a function is linked.  "
                        "The name and default are the JAX package's."),
)
config.add("nan_guard__nan_is_error", BoolParam(True, doc="NanGuardMode raises on a NaN."))
config.add("nan_guard__inf_is_error", BoolParam(True, doc="NanGuardMode raises on an inf."))
config.add("nan_guard__big_is_error", BoolParam(True, doc="NanGuardMode raises on a value "
                                                           "above 1e10 in magnitude."))
config.add("profile", BoolParam(False, doc="Profile every function (compile/debug/profiling.py); "
                                        "the summaries print at exit."))
config.add("profile_optimizer", BoolParam(False, doc="Keep each rewrite pass's seconds in a "
                                                  "function's profile."))
config.add(
    "matmul_precision",
    EnumStr("default", ("high", "highest", "bfloat16", "float32"),
            doc="Precision of the products a plan linked for a CUDA device runs "
                "(matmul_settings); the name and values are the JAX package's."),
)
config.add(
    "xla__matmul_precision",
    EnumStr("default", ("bfloat16", "tensorfloat32", "float32", "highest"),
            doc="As matmul_precision, and read before it; the name and values are "
                "the JAX package's."),
)

# (allow_tf32, allow_bf16_reduced_precision_reduction) of each precision
_MATMUL = {"default": (False, False), "highest": (False, False), "float32": (False, False),
           "high": (True, False), "tensorfloat32": (True, False), "bfloat16": (True, True)}


def matmul_settings() -> tuple[bool, bool]:
    """``(allow_tf32, allow_bf16_reduced_precision_reduction)`` for the
    products of a plan on a CUDA device, from the precision flags."""
    precision = config.xla__matmul_precision
    if precision == "default":
        precision = config.matmul_precision
    return _MATMUL[precision]

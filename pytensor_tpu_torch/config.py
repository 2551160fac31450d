"""Typed configuration flags.

The port's copy of the config system (PyTensor's configparser.py:65
``PyTensorConfigParser`` and configdefaults.py), cut to the five flags the
port reads: ``floatX``, ``mode``, ``sparse__routed_spmv``,
``scan__pallas`` and ``xla__jit``.  A flag's value
comes from ``PYTENSOR_TPU_TORCH_FLAGS`` (``name=value,...``) if set there,
else its default, and may be assigned later or set for a block with
``config.change_flags``.  The device is not a flag: it is an argument of
the linker (``link.torch.linker.fgraph_to_torch``) and of ``function``.
``scan__unroll`` is not ported: eager torch has no loop to unroll.
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
    "mode",
    EnumStr("FAST_RUN", (), doc="Default compilation mode (compile.mode.get_mode)."),
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

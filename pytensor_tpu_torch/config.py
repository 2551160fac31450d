"""Typed configuration flags.

The port's copy of the config system (PyTensor's configparser.py:65
``PyTensorConfigParser`` and configdefaults.py), cut to the two flags the
port reads: ``floatX`` and ``mode``.  A flag's value comes from
``PYTENSOR_TPU_TORCH_FLAGS`` (``name=value,...``) if set there, else its
default, and may be assigned later.  The device is not a flag: it is an
argument of the linker (``link.torch.linker.fgraph_to_torch``).
"""

from __future__ import annotations

import os
from typing import Any


class EnumStr:
    """A string flag with a fixed set of allowed values, the first the default."""

    def __init__(self, default, options, doc=""):
        self.default = default
        self.options = (default, *options)
        self.doc = doc
        self.name = "<unset>"

    def validate(self, value):
        if value not in self.options:
            raise ValueError(
                f"Invalid value {value!r} for flag {self.name}; choices: {self.options}"
            )


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

    def add(self, name: str, param: EnumStr):
        param.name = name
        self._params[name] = param
        value = _read_env_flags().get(name, param.default)
        param.validate(value)
        self._values[name] = value

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
    EnumStr("float32", ("float64",), doc="Default float dtype for literals."),
)
config.add(
    "mode",
    EnumStr("FAST_RUN", (), doc="Default compilation mode (compile.mode.get_mode)."),
)

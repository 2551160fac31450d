"""The Type protocol: value spaces for Variables.

Parallels PyTensor's graph/type.py (Type:12, filter:74,
convert_variable:124): a Type validates/coerces runtime data (``filter``),
adapts Variables of other types (``filter_variable``/``convert_variable``),
and defines a subtyping lattice (``is_super``/``in_same_class``).
"""

from __future__ import annotations

from typing import Any

from pytensor_tpu_torch.utils import MetaObject


class Type(MetaObject):
    """Interface specification for variable types."""

    # subclass of Variable created by make_variable
    variable_type: type = None
    constant_type: type = None

    def filter(self, data: Any, strict: bool = False, allow_downcast: bool | None = None):
        """Coerce/validate ``data`` into this type's value space, or raise TypeError."""
        raise NotImplementedError(f"{type(self).__name__}.filter")

    def filter_variable(self, other, allow_convert: bool = True):
        """Adapt Variable ``other`` to this type, inserting conversions if allowed."""
        from pytensor_tpu_torch.graph.basic import Constant, Variable

        if not isinstance(other, Variable):
            other = self.constant(other)
        if other.type == self:
            return other
        if allow_convert:
            converted = self.convert_variable(other)
            if converted is not None:
                return converted
        raise TypeError(
            f"Cannot convert {other} of type {other.type} to type {self}."
        )

    def convert_variable(self, var):
        """Return an equivalent Variable of this type, or None."""
        if self.is_super(var.type):
            return var
        return None

    def is_super(self, other: "Type") -> bool:
        """True if any value of ``other`` is a valid value of ``self``."""
        return self == other

    def make_variable(self, name: str | None = None):
        from pytensor_tpu_torch.graph.basic import Variable

        cls = self.variable_type or Variable
        return cls(self, None, None, name)

    def make_constant(self, value, name: str | None = None):
        from pytensor_tpu_torch.graph.basic import Constant

        cls = self.constant_type or Constant
        return cls(self, value, name)

    # alias used by Constant.signature
    def make_constant_signature(self, data):
        try:
            return hash(data)
        except TypeError:
            return id(data)

    def constant(self, value, name=None):
        return self.make_constant(value, name)

    def __call__(self, name: str | None = None):
        from pytensor_tpu_torch.utils import add_tag_trace

        return add_tag_trace(self.make_variable(name))

    def values_eq(self, a, b) -> bool:
        return a == b


class HasDataType:
    """Mixin marker: type has a ``dtype`` attribute."""


class HasShape:
    """Mixin marker: type has ``ndim`` and ``shape`` attributes."""

"""Types for undefined / disconnected gradients.

Parallels PyTensor's graph/null_type.py and the
DisconnectedType in gradient.py.
"""

from pytensor_tpu_torch.graph.type import Type


class NullType(Type):
    """Type of gradients that are formally undefined."""

    __props__ = ("why_null",)

    def __init__(self, why_null="(no explanation given)"):
        self.why_null = why_null

    def filter(self, data, strict=False, allow_downcast=None):
        raise ValueError("No values may be assigned to a NullType variable")

    def values_eq(self, a, b):
        raise ValueError("NullType has no values to compare")

    def __str__(self):
        return "NullType"


class DisconnectedType(Type):
    """Type of gradients of variables the cost does not depend on."""

    __props__ = ()

    def filter(self, data, strict=False, allow_downcast=None):
        raise AssertionError(
            "If you're assigning to a DisconnectedType you're doing something wrong."
        )

    def values_eq(self, a, b):
        raise ValueError("DisconnectedType has no values")

    def __str__(self):
        return "DisconnectedType"


null_type = NullType()
disconnected_type = DisconnectedType()

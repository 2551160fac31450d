"""The None type: how SpecifyShape marks a dim it leaves unspecified.

Counterpart of ``pytensor_tpu/tensor/type_other.py`` (PyTensor's
tensor/type_other.py NoneTypeT:120, NoneConst), cut to the None type.
"""

from __future__ import annotations

from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.graph.type import Type


class NoneTypeT(Type):
    __props__ = ()

    def filter(self, data, strict=False, allow_downcast=None):
        if data is None:
            return None
        raise TypeError("expected None")

    def make_constant_signature(self, data):
        return (None,)

    def __str__(self):
        return "None"


none_type_t = NoneTypeT()
NoneConst = Constant(none_type_t, None, name="NoneConst")

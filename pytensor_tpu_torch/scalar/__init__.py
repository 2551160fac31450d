"""Scalar op descriptors, and PyTensor's scalar namespace on them."""

from pytensor_tpu_torch.scalar.basic import *  # noqa: F401,F403
from pytensor_tpu_torch.scalar.math import *  # noqa: F401,F403
import sys as _sys  # noqa: E402

# the module, not the standard library's math that the star import brings
math = _sys.modules["pytensor_tpu_torch.scalar.math"]
from pytensor_tpu_torch.scalar.compatnames import (  # noqa: F401
    BinaryBitOp,
    BinaryScalarOp,
    ComplexError,
    Composite,
    FixedLogicalComparison,
    IntegerDivisionError,
    LogicalComparison,
    NumpyAutocaster,
    ScalarType,
    UnaryBitOp,
    UnaryScalarOp,
    _RefStyleScalarOp as ScalarOp,  # the subclassable PyTensor-style base
    all_types,
    apply_across_args,
    as_scalar,
    autocast_float,
    autocast_float_as,
    autocast_int,
    cast,
    complex_types,
    constant,
    continuous_types,
    convert,
    discrete_dtypes,
    discrete_types,
    float_out,
    float_types,
    floor_div,
    get_scalar_type,
    int_out,
    int_types,
    integer_types,
    mod_check,
    real_out,
    round_half_away_from_zero_,
    round_half_away_from_zero_vec,
    same_out,
    same_out_float_only,
    same_out_min8,
    same_out_nobool,
    same_out_nocomplex,
    scalar_abs,
    scalar_maximum,
    scalar_minimum,
    specific_out,
    uint_types,
    upcast_out,
    upcast_out_min8,
    upcast_out_no_complex,
    upcast_out_nobool,
    upgrade_to_float,
    upgrade_to_float64,
    upgrade_to_float_no_complex,
)


# the loop op (PyTensor's scalar/loop.py ScalarLoop) and the scalar type
# objects, lazily: scalar.loop and the types pull in tensor, which imports
# this package
def __getattr__(name):
    if name == "ScalarLoop":
        from pytensor_tpu_torch.scalar.loop import ScalarLoop

        return ScalarLoop
    from pytensor_tpu_torch.scalar import compatnames

    return getattr(compatnames, name)

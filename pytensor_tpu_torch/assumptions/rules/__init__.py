"""Per-op assumption inference rule modules (counterpart of
``pytensor_tpu/assumptions/rules/``; PyTensor's assumptions/{dot,
elemwise,dimshuffle,alloc,triangular,orthogonal,positive_definite,
permutation,...}.py).

Each module registers rules via ``assumptions.register_assumption``;
importing this package wires the whole rule set.
"""

from pytensor_tpu_torch.assumptions.rules import (  # noqa: F401
    blockwise,
    dimshuffle,
    dot,
    elemwise,
    linalg,
    structural,
)

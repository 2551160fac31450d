"""Sparse matrices: the part of ``pytensor_tpu/sparse/`` the sparse power
iteration needs (see ``basic.py`` and ``spmv.py`` for what each left out).
Importing it registers ``local_structured_dot_to_routed``."""

from pytensor_tpu_torch.sparse.type import SparseTensorType  # noqa: F401
from pytensor_tpu_torch.sparse.basic import (  # noqa: F401
    StructuredDot,
    StructuredDotGrad,
    Transpose,
    as_sparse_variable,
    dot,
    structured_dot,
    transpose,
)
from pytensor_tpu_torch.sparse import spmv  # noqa: F401  (routed SpMV op + rewrite)
from pytensor_tpu_torch.sparse.spmv import RoutedSpMV  # noqa: F401

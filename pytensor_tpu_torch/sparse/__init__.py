"""Sparse matrices: counterpart of ``pytensor_tpu/sparse/``, whole.

Every name the JAX package's ``sparse`` exports is here, from the same
modules; the torch lowerings of its ops are in ``link/torch/sparse.py``.
Importing it registers the sparse rewrites (``basic.py``) and
``local_structured_dot_to_routed`` (``spmv.py``)."""

from pytensor_tpu_torch.sparse.basic import *  # noqa: F401,F403
from pytensor_tpu_torch.sparse.basic import (  # noqa: F401
    add,
    as_sparse_variable,
    csc_from_dense,
    csr_from_dense,
    dense_from_sparse,
    dot,
    mul,
    sampling_dot,
    sp_sum,
    structured_dot,
    transpose,
)
from pytensor_tpu_torch.sparse.basic import (  # noqa: F401
    CSMGrad,
    as_sparse_or_tensor_variable,
    as_symbolic_sparse,
    csm_data,
    csm_grad,
    csm_indices,
    csm_indptr,
    csm_shape,
)
from pytensor_tpu_torch.sparse.type import (  # noqa: F401
    SparseTensorType,
    bsr_dmatrix,
    bsr_fmatrix,
    bsr_matrix,
    csc_dmatrix,
    csc_fmatrix,
    csc_matrix,
    csr_dmatrix,
    csr_fmatrix,
    csr_matrix,
    matrix,
)
from pytensor_tpu_torch.sparse.structured import (  # noqa: F401
    ConstructSparseFromList,
    Diag,
    GetItem2Lists,
    GetItem2ListsGrad,
    GetItemList,
    GetItemListGrad,
    construct_sparse_from_list,
)

get_item_list_grad = GetItemListGrad()
get_item_2lists_grad = GetItem2ListsGrad()
from pytensor_tpu_torch.sparse import linalg  # noqa: F401
from pytensor_tpu_torch.sparse.linalg import SparseBlockDiagonal, block_diag  # noqa: F401
from pytensor_tpu_torch.sparse.compat import *  # noqa: F401,F403,E402
from pytensor_tpu_torch.sparse.compat import (  # noqa: F401,E402
    cast,
    clean,
    col_scale,
    diag,
    ensure_sorted_indices,
    eq,
    ge,
    get_item_2d,
    get_item_2lists,
    get_item_list,
    gt,
    le,
    lt,
    neq,
    remove0,
    row_scale,
    sp_ones_like,
    sp_zeros_like,
    square_diagonal,
    structured_add,
    structured_add_s_v,
    structured_elemwise,
    structured_exp,
    structured_log,
    structured_maximum,
    structured_minimum,
    structured_pow,
    structured_sigmoid,
    sub,
    true_dot,
)

from pytensor_tpu_torch.sparse.compat import (  # noqa: F401,E402
    add_s_s_data,
    sdg_csc,
    sdg_csr,
    structured_dot_grad,
)
from pytensor_tpu_torch.sparse import basic as rewriting  # noqa: F401,E402  (rewrites live in basic)
from pytensor_tpu_torch.sparse import spmv  # noqa: F401,E402  (routed SpMV op + rewrite)

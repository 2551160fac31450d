"""Typed lists (``basic.py``), as the JAX package exports them."""

from pytensor_tpu_torch.typed_list.basic import (
    Append,
    Count,
    Extend,
    GetItem,
    Index,
    Insert,
    Length,
    MakeList,
    Remove,
    Reverse,
    TypedListConstant,
    TypedListType,
    TypedListVariable,
    append,
    count,
    extend,
    getitem,
    insert,
    length,
    make_list,
    remove,
    reverse,
)
from pytensor_tpu_torch.typed_list.basic import index_ as index  # noqa: F401,E402
from pytensor_tpu_torch.typed_list.basic import index_  # noqa: F401,E402

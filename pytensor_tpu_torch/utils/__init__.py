"""Small support utilities shared across the framework.

Role parallels ``pytensor/utils.py`` + ``pytensor/graph/utils.py`` in
PyTensor (graph/utils.py:187 ``MetaType``):
``__props__``-driven equality/hash for Ops and Types, scratchpads for
variable tags, and misc helpers.  Implementation is original.
"""

from __future__ import annotations

import traceback

import numpy as np


def np_dtype(dtype) -> np.dtype:
    """numpy's dtype for a graph dtype name; ``"bfloat16"`` is
    ``ml_dtypes.bfloat16`` (numpy has no bfloat16 of its own)."""
    if str(dtype) == "bfloat16":
        import ml_dtypes

        return np.dtype(ml_dtypes.bfloat16)
    return np.dtype(dtype)


def dtype_kind(dtype) -> str:
    """numpy's kind letter of a graph dtype name, ``"f"`` for bfloat16
    (whose numpy dtype, from ml_dtypes, is of kind ``"V"``)."""
    return "f" if str(dtype) == "bfloat16" else np.dtype(str(dtype)).kind


class MetaObject:
    """Objects whose identity is defined by their ``__props__``.

    Two instances of the same class with equal props compare equal and hash
    equal.  This is what lets the graph-merge (CSE) pass unify structurally
    identical Apply nodes.
    """

    __props__: tuple[str, ...] = ()

    def _props(self) -> tuple:
        return tuple(getattr(self, p) for p in self.__props__)

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and self._props() == other._props()

    def __hash__(self) -> int:
        return hash((type(self), self._props()))

    def __str__(self) -> str:
        if not self.__props__:
            return type(self).__name__
        parts = ", ".join(f"{p}={getattr(self, p)!r}" for p in self.__props__)
        return f"{type(self).__name__}{{{parts}}}"

    def __repr__(self) -> str:
        return str(self)


class Scratchpad:
    """Attribute bag used as ``Variable.tag`` / ``Apply.tag``."""

    def __update__(self, other: "Scratchpad") -> "Scratchpad":
        self.__dict__.update(other.__dict__)
        return self

    def __str__(self) -> str:
        return "scratchpad" + str(self.__dict__)

    def __repr__(self) -> str:
        return str(self)


# frames of user code kept in a variable's creation trace
TRACEBACK_LIMIT = 8


def add_tag_trace(thing):
    """Attach a creation traceback to a Variable/Apply ``tag``.

    Mirrors the provenance mechanism of the reference
    (graph/utils.py:76): runtime and rewrite errors are re-raised with the
    original user stack so graph errors point at model code.
    """
    tr = traceback.extract_stack(limit=TRACEBACK_LIMIT + 4)[:-2]
    # drop frames inside this package
    tr = [t for t in tr if "pytensor_tpu" not in (t.filename or "")]
    thing.tag.trace = [tr]
    return thing

"""Sparse variable operators.

Counterpart of ``pytensor_tpu/sparse/variable.py``, cut to the operators
the sparse power iteration uses: ``@`` (``structured_dot``) and ``.T``
(``transpose``), with ``dtype`` and ``format``.  Left out: ``+``, ``-``,
``*``, indexing, ``sum``, ``toarray``, ``astype``, ``diagonal`` and
``shape``, whose ops are not ported.
"""

from __future__ import annotations

from pytensor_tpu_torch.graph.basic import Constant, Variable


class _SparseOperators:
    def __matmul__(self, other):
        from pytensor_tpu_torch.sparse.basic import structured_dot

        return structured_dot(self, other)

    @property
    def T(self):
        from pytensor_tpu_torch.sparse.basic import transpose

        return transpose(self)

    @property
    def dtype(self):
        return self.type.dtype

    @property
    def format(self):
        return self.type.format


class SparseVariable(_SparseOperators, Variable):
    pass


class SparseConstant(_SparseOperators, Constant):
    pass

"""torch lowerings of the sparse ops.

Counterpart of the JAX package's BCOO lowerings
(``pytensor_tpu/sparse/basic.py:550-757, 879-962``,
``structured.py:207-289``, ``linalg.py:78-101``, ``compat.py:257-270,
553-569``) and of ``sparse/spmv.py:412``.  A sparse value is the logical
matrix's CSR triple (``convert.py CSR``) whatever its graph format: a csc
variable's ``CSMProperties`` gives its csc triple by a stable sort on the
columns (``transpose_csr``), and ``CSM("csc")`` builds the CSR from one.
A triple that ``CSM`` builds is kept as given, so every lowering here
takes the columns of a row in any order and sums duplicates, as scipy
does: lookups go through the sorted keys of the stored entries
(``_lookup``), sums through ``index_add_``.

Where the JAX package's two paths disagree, these lowerings give its
oracle's (the ops' scipy ``perform``) values and structure.  Five ops
store a count of entries that depends on the values or on the indices
(``SparseFromDense``, ``AddSS``, ``MulSS``, ``Remove0``, ``GetItemList``;
sparse ``sub`` is ``AddSS``): they read it back from the device
(``reads_back``), so a plan holding one runs eagerly.  Every other op
keeps a static count (its input's, or the sum of its inputs') and reads
nothing back, so its plan may be captured; where scipy would sum
repeated indices (``GetItemListGrad``, ``GetItem2ListsGrad``,
``ConstructSparseFromList`` with repeats) its entries stay apart, with
the same dense value.  ``CSMProperties``' shape is a host value
(``host_outputs``) and ``CSM``'s shape a host input, so a
``CSM(csm_properties(x))`` chain reads nothing back.
"""

from __future__ import annotations

import torch

from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.link.torch.convert import (
    CSR,
    compress_rows,
    compressed_ids,
    csr_rows,
    torch_dtype,
    transpose_csr,
)
from pytensor_tpu_torch.link.torch.dispatch import ports, torch_funcify
from pytensor_tpu_torch.sparse.basic import (
    CSM,
    AddSD,
    AddSS,
    CSMGrad,
    CSMProperties,
    DenseFromSparse,
    GetItemScalar,
    HStack,
    MulSS,
    MulSV,
    SamplingDot,
    SparseFromDense,
    SpSum,
    StructuredDot,
    StructuredDotGrad,
    Transpose,
    Usmm,
    VStack,
)
from pytensor_tpu_torch.sparse.compat import EnsureSortedIndices, Remove0, _MajorIds
from pytensor_tpu_torch.sparse.linalg import SparseBlockDiagonal
from pytensor_tpu_torch.sparse.spmv import RoutedSpMV
from pytensor_tpu_torch.sparse.structured import (
    ConstructSparseFromList,
    Diag,
    GetItem2Lists,
    GetItem2ListsGrad,
    GetItemList,
    GetItemListGrad,
)

# a key per entry, row * 2**31 + column: the indices are int32
_SHIFT = 31
_LOW = (1 << _SHIFT) - 1


def _keys(rows, cols):
    return (rows.long() << _SHIFT) | cols.long()


def _from_keys(keys, data, shape) -> CSR:
    return compress_rows(keys >> _SHIFT, keys & _LOW, data, shape)


def _entries(a: CSR):
    """``a``'s stored entries' keys."""
    return _keys(csr_rows(a), a.indices)


def _lookup(keys, vals, query):
    """For each key of ``query``, the sum of ``vals`` over the entries of
    that key (0 where there is none): a binary search in the sorted keys,
    duplicates summed first.  Reads nothing back."""
    n = keys.shape[0]
    if n == 0:
        return vals.new_zeros(query.shape)
    sk, order = torch.sort(keys, stable=True)
    first = torch.ones_like(sk, dtype=torch.bool)
    first[1:] = sk[1:] != sk[:-1]
    seg = torch.cumsum(first, 0) - 1
    sums = torch.zeros_like(vals).index_add_(0, seg, vals[order])
    pos = torch.searchsorted(sk, query).clamp_(max=n - 1)
    return torch.where(sk[pos] == query, sums[seg[pos]], vals.new_zeros(()))


def _sum_duplicates(keys, data):
    """The distinct keys, sorted, and each one's sum: the count of keys is
    read back from the device (``unique_consecutive``)."""
    sk, order = torch.sort(keys, stable=True)
    uniq, inverse = torch.unique_consecutive(sk, return_inverse=True)
    return uniq, data.new_zeros(uniq.shape[0]).index_add_(0, inverse, data[order])


def _without_zeros(keys, data, shape) -> CSR:
    """The entries whose value is not 0, as scipy's arithmetic keeps them
    (the mask's count is read back)."""
    keep = data != 0
    return _from_keys(keys[keep], data[keep], shape)


def _out_dtype(node):
    return torch_dtype(node.outputs[0].type.dtype)


def _wrap(i, n):
    """An index with numpy's negative indices counted from ``n``."""
    i = i.long()
    return torch.where(i < 0, i + n, i)


# --- construction (sparse/basic.py:39-250) -------------------------------------------

@torch_funcify.register(CSMProperties)
@ports(host_outputs=(3,))
def _csm_properties(op, node=None, **kw):
    """``(data, indices, indptr, shape)`` in the variable's format: a csc
    variable's are its column-major data, row indices and column
    pointers.  The shape is a host value."""
    csc = node.inputs[0].type.format == "csc"

    def csm_properties(x):
        t = transpose_csr(x) if csc else x
        return t.data, t.indices, t.indptr, torch.tensor(x.shape, dtype=torch.int64)

    return csm_properties


@torch_funcify.register(CSM)
@ports(host=(3,))
def _csm(op, node=None, **kw):
    """The triple kept as given (a csc one through ``transpose_csr``);
    scipy's checks of its sizes, which need no read of the device."""
    csc = op.format == "csc"
    dtype = _out_dtype(node)

    def csm(data, indices, indptr, shape):
        m, n = (int(d) for d in shape.tolist())
        comp = (n, m) if csc else (m, n)
        if indptr.shape[0] != comp[0] + 1:
            raise ValueError(f"index pointer size {indptr.shape[0]} should be {comp[0] + 1}")
        if indices.shape[0] != data.shape[0]:
            raise ValueError("indices and data should have the same size")
        t = CSR(indptr.to(torch.int32), indices.to(torch.int32), data.to(dtype), comp)
        return transpose_csr(t) if csc else t

    return csm


@torch_funcify.register(CSMGrad)
@ports(keeps_host=(3, 7))
def _csm_grad(op, node=None, **kw):
    """The cotangent's values at x's (compressed, index) pairs, its
    duplicates summed and 0 where it stores none (``_lookup``); neither
    pattern needs sorting.  The shapes are not read."""
    dtype = _out_dtype(node)

    def csm_grad(x_data, x_indices, x_indptr, x_shape, g_data, g_indices, g_indptr, g_shape):
        query = _keys(compressed_ids(x_indptr, x_indices.shape[0]), x_indices)
        keys = _keys(compressed_ids(g_indptr, g_indices.shape[0]), g_indices)
        return _lookup(keys, g_data.to(dtype), query)

    return csm_grad


@torch_funcify.register(DenseFromSparse)
def _dense_from_sparse(op, node=None, **kw):
    def dense_from_sparse(x):
        out = x.data.new_zeros(x.shape)
        return out.index_put_((csr_rows(x), x.indices.long()), x.data, accumulate=True)

    return dense_from_sparse


@torch_funcify.register(SparseFromDense)
@ports(reads_back="its count of stored entries, the nonzeros, is read back")
def _sparse_from_dense(op, node=None, **kw):
    """The nonzeros in row-major order, as scipy stores them (whatever the
    format: the device value is the logical CSR)."""
    def sparse_from_dense(x):
        rows, cols = torch.nonzero(x, as_tuple=True)
        return compress_rows(rows, cols, x[rows, cols], tuple(x.shape))

    return sparse_from_dense


# --- products (sparse/basic.py:252-356, 497-520, 847-876) -------------------------------

def _structured_dot_fn(out, prefix):
    def structured_dot(a, b):
        b = b.to(out)
        prod = a.data.to(out)[(slice(None),) + (None,) * (b.ndim - 1)] * b[a.indices.long()]
        if prefix:
            cs = torch.cumsum(prod, dim=0)
            padded = torch.cat([torch.zeros_like(cs[:1]), cs])
            starts = a.indptr.long()
            return padded[starts[1:]] - padded[starts[:-1]]
        y = torch.zeros((a.shape[0], *b.shape[1:]), dtype=out, device=b.device)
        return y.index_add_(0, csr_rows(a), prod)

    return structured_dot


@torch_funcify.register(StructuredDot)
def _structured_dot(op, node=None, **kw):
    """The matvec of a matrix the routed rewrite refused (under 4,096
    nonzeros, float64, a sparse input, a 2-d operand).  As the JAX
    package's ``_sdot``: a float32 CSR constant sums each row as a
    difference of one prefix sum over the products; any other operand
    adds the products into their rows (``index_add_``)."""
    a_var = node.inputs[0]
    out = _out_dtype(node)
    prefix = (out == torch.float32 and isinstance(a_var, Constant)
              and a_var.type.format == "csr")
    return _structured_dot_fn(out, prefix)


@torch_funcify.register(Transpose)
def _transpose(op, node=None, **kw):
    return transpose_csr


@torch_funcify.register(StructuredDotGrad)
def _structured_dot_grad(op, node=None, **kw):
    dtype = _out_dtype(node)

    def structured_dot_grad(a, b, gz):
        b2 = b if b.ndim == 2 else b[:, None]
        gz2 = gz if gz.ndim == 2 else gz[:, None]
        vals = (gz2[csr_rows(a)] * b2[a.indices.long()]).sum(1)
        return CSR(a.indptr, a.indices, vals.to(dtype), a.shape)

    return structured_dot_grad


@torch_funcify.register(SamplingDot)
def _sampling_dot(op, node=None, **kw):
    """``x[row] . y[col]`` at each stored entry of p, p's pattern kept."""
    dtype = _out_dtype(node)

    def sampling_dot(x, y, p):
        vals = (x[csr_rows(p)] * y[p.indices.long()]).sum(-1)
        return CSR(p.indptr, p.indices, vals.to(dtype), p.shape)

    return sampling_dot


@torch_funcify.register(Usmm)
def _usmm(op, node=None, **kw):
    """``alpha * (x @ y) + z`` with the products added into their rows."""
    out = _out_dtype(node)
    sdot = _structured_dot_fn(out, False)

    def usmm(alpha, x, y, z):
        return alpha.to(out) * sdot(x, y) + z.to(out)

    return usmm


@torch_funcify.register(RoutedSpMV)
def _routed_spmv(op, node=None, **kw):
    """K4 on a CUDA device, its plain version on the CPU; a (N, 1)
    operand is viewed flat."""
    from pytensor_tpu_torch.link.cuda.spmv_kernel import spmv

    def routed_spmv(b, indptr, indices, data):
        x = b.reshape(-1) if b.ndim == 2 else b
        return spmv(indptr, indices, data, x.contiguous())

    return routed_spmv


# --- reductions and arithmetic (sparse/basic.py:359-494, 774-795) ------------------------

@torch_funcify.register(SpSum)
def _sp_sum(op, node=None, **kw):
    axis = op.axis
    dtype = _out_dtype(node)

    def sp_sum(x):
        if axis is None:
            return x.data.sum().to(dtype)
        if axis % 2 == 0:
            return x.data.new_zeros(x.shape[1]).index_add_(0, x.indices.long(), x.data).to(dtype)
        return x.data.new_zeros(x.shape[0]).index_add_(0, csr_rows(x), x.data).to(dtype)

    return sp_sum


@torch_funcify.register(AddSD)
def _add_sd(op, node=None, **kw):
    dtype = _out_dtype(node)
    dense = _dense_from_sparse(op)

    def add_sd(s, d):
        return dense(s).to(dtype) + d.to(dtype)

    return add_sd


@torch_funcify.register(AddSS)
@ports(reads_back="its count of stored entries, the union's without the zeros, is read back")
def _add_ss(op, node=None, **kw):
    """scipy's sum: the union of the patterns, each entry summed, the
    zeros dropped, canonical."""
    dtype = _out_dtype(node)

    def add_ss(x, y):
        keys = torch.cat([_entries(x), _entries(y)])
        keys, sums = _sum_duplicates(keys, torch.cat([x.data.to(dtype), y.data.to(dtype)]))
        return _without_zeros(keys, sums, x.shape)

    return add_ss


@torch_funcify.register(MulSS)
@ports(reads_back="its count of stored entries, the intersection's without the zeros, is "
                  "read back")
def _mul_ss(op, node=None, **kw):
    """scipy's elementwise product: x's entries (duplicates summed) times
    y's at the same place, the zeros dropped, canonical."""
    dtype = _out_dtype(node)

    def mul_ss(x, y):
        keys, xs = _sum_duplicates(_entries(x), x.data.to(dtype))
        prod = xs * _lookup(_entries(y), y.data.to(dtype), keys)
        return _without_zeros(keys, prod, x.shape)

    return mul_ss


@torch_funcify.register(MulSV)
def _mul_sv(op, node=None, **kw):
    """s's pattern kept: a 0-d v scales the data, any other is broadcast
    against the matrix and read at each entry (scipy's ``multiply``)."""
    dtype = _out_dtype(node)

    def mul_sv(s, v):
        if v.ndim == 0:
            return CSR(s.indptr, s.indices, (s.data * v).to(dtype), s.shape)
        vb = torch.broadcast_to(v, s.shape)
        vals = s.data * vb[csr_rows(s), s.indices.long()]
        return CSR(s.indptr, s.indices, vals.to(dtype), s.shape)

    return mul_sv


@torch_funcify.register(HStack)
@torch_funcify.register(VStack)
def _stack(op, node=None, **kw):
    """The blocks' entries offset, then compressed by rows, each row's
    entries in block order: a static count, the sum of the blocks'."""
    dtype = _out_dtype(node)
    vertical = isinstance(op, VStack)

    def stack(*mats):
        rows, cols, data = [], [], []
        off = 0
        for m in mats:
            r, c = csr_rows(m), m.indices.long()
            rows.append(r + off if vertical else r)
            cols.append(c if vertical else c + off)
            data.append(m.data.to(dtype))
            off += m.shape[0] if vertical else m.shape[1]
        first = mats[0].shape
        shape = (off, first[1]) if vertical else (first[0], off)
        return compress_rows(torch.cat(rows), torch.cat(cols), torch.cat(data), shape)

    return stack


@torch_funcify.register(GetItemScalar)
def _get_item_scalar(op, node=None, **kw):
    """The sum of the entries at (i, j): duplicates summed, 0 where none."""
    dtype = _out_dtype(node)

    def get_item_scalar(x, i, j):
        m, n = x.shape
        hit = (csr_rows(x) == _wrap(i, m)) & (x.indices.long() == _wrap(j, n))
        return torch.where(hit, x.data, x.data.new_zeros(())).sum().to(dtype)

    return get_item_scalar


# --- structured indexing (sparse/structured.py) -----------------------------------------

@torch_funcify.register(GetItemList)
@ports(reads_back="its count of stored entries, the selected rows' total, is read back")
def _get_item_list(op, node=None, **kw):
    """The selected rows' entries in their stored order, repeats and all."""
    def get_item_list(x, idx):
        idx = _wrap(idx, x.shape[0])
        starts = x.indptr[idx].long()
        counts = x.indptr[idx + 1].long() - starts
        indptr = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)])
        total = int(indptr[-1])
        row = torch.repeat_interleave(torch.arange(idx.shape[0], device=idx.device), counts,
                                      output_size=total)
        pos = starts[row] + torch.arange(total, device=idx.device) - indptr[row]
        return CSR(indptr.to(torch.int32), x.indices[pos], x.data[pos],
                   (idx.shape[0], x.shape[1]))

    return get_item_list


@torch_funcify.register(GetItemListGrad)
def _get_item_list_grad(op, node=None, **kw):
    def get_item_list_grad(x, idx, gz):
        rows = _wrap(idx, x.shape[0])[csr_rows(gz)]
        return compress_rows(rows, gz.indices, gz.data, x.shape)

    return get_item_list_grad


@torch_funcify.register(GetItem2Lists)
def _get_item_2lists(op, node=None, **kw):
    dtype = _out_dtype(node)

    def get_item_2lists(x, rows, cols):
        query = _keys(_wrap(rows, x.shape[0]), _wrap(cols, x.shape[1]))
        return _lookup(_entries(x), x.data, query).to(dtype)

    return get_item_2lists


@torch_funcify.register(GetItem2ListsGrad)
def _get_item_2lists_grad(op, node=None, **kw):
    dtype = _out_dtype(node)

    def get_item_2lists_grad(x, rows, cols, gz):
        return compress_rows(_wrap(rows, x.shape[0]), _wrap(cols, x.shape[1]), gz.to(dtype),
                             x.shape)

    return get_item_2lists_grad


@torch_funcify.register(Diag)
def _diag(op, node=None, **kw):
    dtype = _out_dtype(node)

    def diag(x):
        rows = csr_rows(x)
        on = rows == x.indices.long()
        out = x.data.new_zeros(min(x.shape))
        return out.index_add_(0, torch.where(on, rows, 0),
                              torch.where(on, x.data, x.data.new_zeros(()))).to(dtype)

    return diag


@torch_funcify.register(ConstructSparseFromList)
def _construct_sparse_from_list(op, node=None, **kw):
    dtype = _out_dtype(node)

    def construct_sparse_from_list(x, values, ilist):
        m, c = values.shape
        rows = _wrap(ilist, x.shape[0]).repeat_interleave(c)
        cols = torch.arange(c, device=values.device).repeat(m)
        return compress_rows(rows, cols, values.reshape(-1).to(dtype), tuple(x.shape))

    return construct_sparse_from_list


# --- block diagonal (sparse/linalg.py) ----------------------------------------------------

@torch_funcify.register(SparseBlockDiagonal)
def _block_diag(op, node=None, **kw):
    """Every entry of each dense block, as scipy's ``block_diag`` stores
    them, offset along the diagonal."""
    dtype = _out_dtype(node)

    def block_diag(*blocks):
        rows, cols = [], []
        r0 = c0 = 0
        for b in blocks:
            r, c = b.shape
            rows.append(torch.arange(r, device=b.device).repeat_interleave(c) + r0)
            cols.append(torch.arange(c, device=b.device).repeat(r) + c0)
            r0, c0 = r0 + r, c0 + c
        data = torch.cat([b.reshape(-1).to(dtype) for b in blocks])
        return compress_rows(torch.cat(rows), torch.cat(cols), data, (r0, c0))

    return block_diag


# --- cleanups (sparse/compat.py) ----------------------------------------------------------

@torch_funcify.register(Remove0)
@ports(reads_back="its count of stored entries, the nonzero ones, is read back")
def _remove0(op, node=None, **kw):
    """scipy's ``eliminate_zeros``: the other entries in their order."""
    def remove0(x):
        keep = x.data != 0
        return compress_rows(csr_rows(x)[keep], x.indices[keep], x.data[keep], x.shape)

    return remove0


@torch_funcify.register(EnsureSortedIndices)
def _ensure_sorted_indices(op, node=None, **kw):
    """Each row's columns sorted (a stable sort of the keys); duplicates
    stay, as scipy's ``sort_indices`` keeps them."""
    def ensure_sorted_indices(x):
        order = torch.sort(_entries(x), stable=True).indices
        return CSR(x.indptr, x.indices[order], x.data[order], x.shape)

    return ensure_sorted_indices


@torch_funcify.register(_MajorIds.MajorIds)
@ports(bounded=(0,))
def _major_ids(op, node=None, bounds=None, **kw):
    """``compat.py _MajorIds``' row ids, int32, by ``compressed_ids``; their
    bounds, ``[0, len(indptr) - 2]``, go to the plan's ``bounds`` (the
    ``bounded`` port), so a bounds check of an index by them reads
    nothing back."""
    out = node.outputs[0]

    def major_ids(indptr, data):
        if bounds is not None:
            bounds[out] = (0, indptr.shape[0] - 2)
        return compressed_ids(indptr, data.shape[0]).to(torch.int32)

    return major_ids

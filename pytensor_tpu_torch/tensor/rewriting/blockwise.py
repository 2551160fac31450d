"""Blockwise rewrites.

Counterpart of ``pytensor_tpu/tensor/rewriting/blockwise.py``, ported
whole: ``local_useless_blockwise`` (canonicalize and specialize) and
``local_batched_matmul_to_core_matmul`` (specialize), registered in the
JAX package's order.
"""

from __future__ import annotations

from pytensor_tpu_torch.compile.mode import register_canonicalize, register_specialize
from pytensor_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from pytensor_tpu_torch.tensor.blockwise import Blockwise


@node_rewriter([Blockwise])
def local_useless_blockwise(fgraph, node):
    """Blockwise(core_op) with zero batch dims -> the core op itself
    (reference local_useless_blockwise): removes the batching wrapper so the
    core op's own lowering/rewrites apply."""
    op = node.op
    in_core, _ = op._core_ndims()
    if any(i.type.ndim != c for i, c in zip(node.inputs, in_core)):
        return False
    core_node = op.core_op.make_node(*node.inputs)
    if len(core_node.outputs) != len(node.outputs):
        return False
    for new, old in zip(core_node.outputs, node.outputs):
        if new.type.dtype != old.type.dtype or not old.type.is_super(new.type):
            return False
        copy_stack_trace(old, new)
    return core_node.outputs


register_specialize(local_useless_blockwise, name="local_useless_blockwise")
register_canonicalize(local_useless_blockwise, name="local_useless_blockwise")


@node_rewriter([Blockwise])
def local_batched_matmul_to_core_matmul(fgraph, node):
    """Blockwise matmul where only ONE operand is batched -> one core
    dot over a flattened batch (reference rewriting/math.py:305
    _batched_matmul_to_core_matmul, reshape variant).

    One (b*m, k) @ (k, n) product is one large matrix product, where a
    batch of small ones is many.  Cases: x batched / y core(-broadcastable), the transpose-dual, and
    both-all-1 batch dims; both-genuinely-batched is left alone.
    """
    from pytensor_tpu_torch.tensor.math import Dot, _dot

    op = node.op
    if not isinstance(op.core_op, Dot) \
            or op.signature != "(m,k),(k,n)->(m,n)":
        return False
    x, y = node.inputs
    out = node.outputs[0]
    if x.type.ndim < 2 or y.type.ndim < 2:
        return False
    bx = x.type.ndim - 2
    by = y.type.ndim - 2

    def _core_like(v):
        return all(s == 1 for s in v.type.shape[:-2])

    x_core = _core_like(x)
    y_core = _core_like(y)

    def _to_2d(v):
        if v.type.ndim == 2:
            return v
        return v.reshape((v.shape[-2], v.shape[-1]))

    if x_core and y_core:
        if bx == 0 and by == 0:
            return False  # local_useless_blockwise handles this
        res = _dot(_to_2d(x), _to_2d(y))
    elif y_core:
        # (bdims, m, k) @ (k, n): flatten batch into rows
        x2 = x.reshape((-1, x.shape[-1]))
        z = _dot(x2, _to_2d(y))
        res = z.reshape(tuple(x.shape[i] for i in range(x.type.ndim - 1))
                        + (y.shape[-1],))
    elif x_core:
        # (m, k) @ (bdims, k, n): transpose dual of the case above
        from pytensor_tpu_torch.tensor.basic import swapaxes

        xT = _to_2d(swapaxes(x, -2, -1))         # (k, m)
        yT = swapaxes(y, -2, -1)                 # (bdims, n, k)
        yT2 = yT.reshape((-1, yT.shape[-1]))     # (b*n, k)
        z = _dot(yT2, xT)                        # (b*n, m)
        z = z.reshape(tuple(yT.shape[i] for i in range(yT.type.ndim - 1))
                      + (x.shape[-2],))          # (bdims, n, m)
        res = swapaxes(z, -2, -1)
    else:
        return False

    # restore any leading broadcast dims the flattening dropped
    if res.type.ndim < out.type.ndim:
        from pytensor_tpu_torch.tensor.elemwise import DimShuffle

        pad = out.type.ndim - res.type.ndim
        res = DimShuffle(res.type.ndim,
                         ("x",) * pad + tuple(range(res.type.ndim)))(res)
    if res.type.dtype != out.type.dtype or not out.type.is_super(res.type):
        return False
    copy_stack_trace(out, res)
    return [res]


register_specialize(local_batched_matmul_to_core_matmul,
                    name="local_batched_matmul_to_core_matmul")

"""RandomVariable lift rewrites.

Counterpart of ``pytensor_tpu/tensor/random/rewriting.py``
(``local_rv_size_lift:95``, ``local_dimshuffle_rv_lift:115``,
``local_subtensor_rv_lift:216``), registered as there (``:309-328``): in
``canonicalize`` under the tag ``random_lift`` alone, not in ``fast_run``
and not picked by a query of ``canonicalize``'s name.

They move ``size``, a ``DimShuffle`` or a ``*Subtensor`` through a
RandomVariable onto its parameters (``normal(mu, 1)[idx] ->
normal(mu[idx], 1)``).  A lifted graph is the hand-lifted construction
op for op, and draws what that construction draws from the same key; it
does not keep the draws of the unlifted graph, whose output shape keys
each element's bits differently.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.graph.basic import Variable
from pytensor_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter
from pytensor_tpu_torch.tensor.elemwise import DimShuffle
from pytensor_tpu_torch.tensor.random.op import RandomVariable
from pytensor_tpu_torch.tensor.subtensor import DYN, AdvancedSubtensor, Subtensor
from pytensor_tpu_torch.tensor.type_other import NoneTypeT

__all__ = [
    "local_rv_size_lift",
    "local_dimshuffle_rv_lift",
    "local_subtensor_rv_lift",
]


def is_rv_used_in_graph(base_rv, node, fgraph):
    """True when ``base_rv`` has a consumer other than ``node`` that
    depends on its *values* (``Shape``/``Shape_i`` readers don't)."""
    from pytensor_tpu_torch.tensor.shape import Shape, Shape_i

    for client, _ in fgraph.clients.get(base_rv, ()):
        if client == "output":
            return True
        if client is node:
            continue
        if isinstance(client.op, (Shape, Shape_i)):
            continue
        return True
    return False


def _size_lifted_params(op, size, dist_params):
    """Broadcast each param so its batch part equals ``size`` (and the
    explicit size can be dropped).  None when the size length is not
    statically known."""
    from pytensor_tpu_torch.tensor.extra_ops import broadcast_to

    n = size.type.shape[0]
    if n is None:
        return None
    size_dims = tuple(size[i] for i in range(n))
    new_params = []
    for p, nd in zip(dist_params, op.ndims_params):
        core = tuple(p.shape[p.type.ndim - nd + j] for j in range(nd))
        new_params.append(broadcast_to(p, size_dims + core))
    return new_params


def _match_draws(new_draws, old_draws):
    """Adapt ``new_draws`` so the replacement type-checks against the
    variable it replaces (recover static dims via specify_shape)."""
    if old_draws.type.is_super(new_draws.type):
        copy_stack_trace(old_draws, new_draws)
        return new_draws
    if new_draws.type.dtype != old_draws.type.dtype or \
            new_draws.type.ndim != old_draws.type.ndim:
        return None
    from pytensor_tpu_torch.tensor.shape import specify_shape

    out = specify_shape(new_draws, old_draws.type.shape)
    if not old_draws.type.is_super(out.type):
        return None
    copy_stack_trace(old_draws, out)
    return out


@node_rewriter(None)
def local_rv_size_lift(fgraph, node):
    """Fold an explicit ``size`` into broadcasted parameters:
    ``normal(0, 1, size=(1, 2))`` becomes ``normal(zeros((1, 2)), ones((1,
    2)))`` with no size (reference rewriting/basic.py:73)."""
    if not isinstance(node.op, RandomVariable):
        return False
    rng, size, *dist_params = node.inputs
    if isinstance(size.type, NoneTypeT):
        return False
    new_params = _size_lifted_params(node.op, size, dist_params)
    if new_params is None:
        return False
    new_node = node.op.make_node(rng, None, *new_params)
    draws = _match_draws(new_node.outputs[1], node.outputs[1])
    if draws is None:
        return False
    return {node.outputs[0]: new_node.outputs[0], node.outputs[1]: draws}


@node_rewriter([DimShuffle])
def local_dimshuffle_rv_lift(fgraph, node):
    """``normal(mu, std).T -> normal(mu.T, std.T)``: push a DimShuffle of
    batch dims through the RV onto its parameters (reference
    rewriting/basic.py:118).  Support dims must stay trailing and
    untouched; dims may not be dropped."""
    ds_op = node.op
    if ds_op.drop:
        return False
    rv_node = node.inputs[0].owner
    if not (rv_node and isinstance(rv_node.op, RandomVariable)):
        return False
    if node.inputs[0] is not rv_node.outputs[1]:
        return False
    rv_op = rv_node.op
    rng, size, *dist_params = rv_node.inputs
    next_rng, rv = rv_node.outputs
    if is_rv_used_in_graph(rv, node, fgraph):
        return False

    ndim_supp = rv_op.ndim_supp
    batch_ndim = rv.type.ndim - ndim_supp
    if ndim_supp > 0:
        # support dims must remain the trailing dims, in order
        if tuple(ds_op.new_order[-ndim_supp:]) != tuple(
                range(batch_ndim, rv.type.ndim)):
            return False
        batch_order = ds_op.new_order[:-ndim_supp]
    else:
        batch_order = ds_op.new_order
    if any(o != "x" and o >= batch_ndim for o in batch_order):
        return False

    if isinstance(size.type, NoneTypeT):
        new_size = None
    else:
        if size.type.shape[0] is None:
            return False
        new_size = [1 if o == "x" else size[o] for o in batch_order]

    new_params = []
    for p, nd in zip(dist_params, rv_op.ndims_params):
        bp = p.type.ndim - nd
        pad = batch_ndim - bp  # implicit leading broadcast dims
        order = []
        for o in batch_order:
            if o == "x":
                order.append("x")
            else:
                ax = o - pad
                order.append("x" if ax < 0 else ax)
        order += list(range(bp, bp + nd))
        new_params.append(p.dimshuffle(order))

    new_node = rv_op.make_node(rng, new_size, *new_params)
    draws = _match_draws(new_node.outputs[1], node.outputs[0])
    if draws is None:
        return False
    if rv.name:
        draws.name = f"{rv.name}_lifted"
    return {node.outputs[0]: draws, next_rng: new_node.outputs[0]}


def _symbolic_indices(node):
    """Rebuild the python-level index tuple (ints, slices with possibly
    symbolic bounds, symbolic scalars/masks) of a *Subtensor node; None
    when the structure isn't liftable (newaxis entries)."""
    op = node.op
    it = iter(node.inputs[1:])
    out = []
    if isinstance(op, Subtensor):
        for e in op.idx_list:
            if e == DYN:
                out.append(next(it))
            elif isinstance(e, (int, np.integer)):
                out.append(int(e))
            else:
                _, a, b, c = e
                s = next(it) if a == DYN else a
                o = next(it) if b == DYN else b
                p = next(it) if c == DYN else c
                out.append(slice(s, o, p))
        return tuple(out)
    for e in op.idx_list:
        if e == "none":
            return None
        if e == DYN:
            out.append(next(it))
        elif isinstance(e, (int, np.integer)):
            out.append(int(e))
        else:
            _, a, b, c = e
            out.append(slice(a, b, c))
    return tuple(out)


def _is_trivial_slice(ix):
    return isinstance(ix, slice) and ix.start is None and ix.stop is None \
        and ix.step is None


@node_rewriter([Subtensor, AdvancedSubtensor])
def local_subtensor_rv_lift(fgraph, node):
    """``normal(mu, std)[0] -> normal(mu[0], std[0])``: push batch-dim
    indexing through the RV onto its parameters (reference
    rewriting/basic.py:199).

    Applies to ints, slices, symbolic scalars and a sole boolean mask.
    Integer-ARRAY indices are rejected: they can select the same batch
    entry twice, and the lifted graph would draw two independent samples
    where the original had one value duplicated."""
    rv_node = node.inputs[0].owner
    if not (rv_node and isinstance(rv_node.op, RandomVariable)):
        return False
    if node.inputs[0] is not rv_node.outputs[1]:
        return False
    rv_op = rv_node.op
    rng, size, *dist_params = rv_node.inputs
    next_rng, rv = rv_node.outputs
    if is_rv_used_in_graph(rv, node, fgraph):
        return False

    indices = _symbolic_indices(node)
    if indices is None or not indices:
        return False
    batch_ndim = rv.type.ndim - rv_op.ndim_supp

    mask = None
    if len(indices) == 1 and isinstance(indices[0], Variable) and \
            getattr(indices[0].type, "dtype", None) == "bool" and \
            indices[0].type.ndim >= 1:
        mask = indices[0]
        if mask.type.ndim > batch_ndim:
            return False
    else:
        for ix in indices:
            if isinstance(ix, Variable) and ix.type.ndim >= 1:
                return False  # integer-array index: duplicate-unsafe
        # indices beyond the batch dims must be trivial full slices
        if len(indices) > batch_ndim:
            for ix in indices[batch_ndim:]:
                if not _is_trivial_slice(ix):
                    return False
            indices = indices[:batch_ndim]
            if not indices:
                return False

    # fold an explicit size into the params first, so indexing the
    # params is indexing the full batch shape
    if not isinstance(size.type, NoneTypeT):
        dist_params = _size_lifted_params(rv_op, size, dist_params)
        if dist_params is None:
            return False

    new_params = []
    for p, nd in zip(dist_params, rv_op.ndims_params):
        bp = p.type.ndim - nd
        pad = batch_ndim - bp
        if pad:
            p = p.dimshuffle(["x"] * pad + list(range(p.type.ndim)))
        if mask is not None:
            k = mask.type.ndim
            degen = [p.type.shape[d] == 1 for d in range(k)]
            if all(degen):
                # constant over the masked dims: keep one entry, leave a
                # broadcastable dim in place of the mask's nnz dim
                q = p[(0,) * k] if k else p
                q = q.dimshuffle(["x"] + list(range(q.type.ndim)))
                new_params.append(q)
                continue
            if any(degen):
                return False  # mask straddles broadcast + real dims
            new_params.append(p[mask])
            continue
        adj = []
        for d, ix in enumerate(indices):
            if p.type.shape[d] == 1 and rv.type.shape[d] != 1:
                # degenerate param dim: index 0 / keep the whole dim
                adj.append(slice(None) if isinstance(ix, slice) else 0)
            else:
                adj.append(ix)
        if all(_is_trivial_slice(a) for a in adj):
            new_params.append(p)
        else:
            new_params.append(p[tuple(adj)])

    new_node = rv_op.make_node(rng, None, *new_params)
    draws = _match_draws(new_node.outputs[1], node.outputs[0])
    if draws is None:
        return False
    if rv.name:
        draws.name = f"{rv.name}_lifted"
    return {node.outputs[0]: draws, next_rng: new_node.outputs[0]}


def _register():
    # opt-in (mode.including("random_lift")) — the reference leaves these
    # unregistered for PyMC to drive; a tag-gated registration is the
    # ergonomic equivalent here
    from pytensor_tpu_torch.compile.mode import canonicalize

    # use_db_name_as_tag=False: a bare include=("canonicalize",) query
    # (rewrite_graph's default) must NOT pick these up — only the
    # explicit "random_lift" tag (or the rewrite's own name) selects them
    canonicalize.register("local_rv_size_lift", local_rv_size_lift,
                          "random_lift", use_db_name_as_tag=False)
    canonicalize.register("local_dimshuffle_rv_lift",
                          local_dimshuffle_rv_lift, "random_lift",
                          use_db_name_as_tag=False)
    canonicalize.register("local_subtensor_rv_lift",
                          local_subtensor_rv_lift, "random_lift",
                          use_db_name_as_tag=False)


_register()

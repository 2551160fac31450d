"""Graph substitution and vectorization utilities.

Counterpart of ``pytensor_tpu/graph/replace.py`` (clone_replace,
graph_replace, and ``_vectorize_node``/``vectorize_node``/
``vectorize_graph`` at ``:88-118``).  ``vectorize_graph`` with the
``_vectorize_node`` singledispatch is the basis of Blockwise batching;
the batching rules of the structural ops register in
``tensor/blockwise.py``.
"""

from __future__ import annotations

from functools import singledispatch
from typing import Sequence

from pytensor_tpu_torch.graph.basic import Apply, Variable, clone_get_equiv
from pytensor_tpu_torch.graph.traversal import graph_inputs, io_toposort, truncated_graph_inputs


def clone_replace(
    output,
    replace: dict | Sequence[tuple] | None = None,
    **kwargs,
):
    """Clone the graph(s) in ``output`` substituting ``replace`` pairs."""
    if isinstance(replace, dict):
        items = list(replace.items())
    elif replace is None:
        items = []
    else:
        items = list(replace)

    one = isinstance(output, Variable)
    outputs = [output] if one else list(output)

    memo = {}
    for old, new in items:
        if not isinstance(new, Variable):
            new = old.type.filter_variable(new)
        if old.type != new.type:
            converted = old.type.convert_variable(new)
            if converted is None:
                raise TypeError(f"replacement {new} has incompatible type for {old}")
            new = converted
        memo[old] = new
    inputs = [i for i in graph_inputs(outputs) if i not in memo]
    memo = clone_get_equiv(inputs, outputs, copy_inputs=False, copy_orphans=False, memo=memo)
    res = [memo[o] for o in outputs]
    return res[0] if one else res


def graph_replace(
    outputs,
    replace: dict | Sequence[tuple] | None = None,
    *,
    strict: bool = True,
):
    """Replace variables *inside* a graph even when they are intermediate
    (non-root) — the reference's graph_replace:93 semantics."""
    one = isinstance(outputs, Variable)
    outs = [outputs] if one else list(outputs)
    if isinstance(replace, dict):
        items = list(replace.items())
    else:
        items = list(replace or [])

    replace_map = {}
    for old, new in items:
        if not isinstance(new, Variable):
            new = old.type.filter_variable(new)
        replace_map[old] = new

    # cut the graph at the replaced vars: treat them as inputs, clone, then
    # substitute the replacement graphs.
    cut_points = list(replace_map)
    needed_inputs = truncated_graph_inputs(outs, cut_points)
    not_found = [v for v in cut_points if v not in needed_inputs]
    if strict and not_found:
        raise ValueError(f"{not_found} not found in the graph of {outs}")
    memo = {v: replace_map.get(v, v) for v in needed_inputs}
    equiv = clone_get_equiv(
        needed_inputs, outs, copy_inputs=False, copy_orphans=False, memo=dict(memo)
    )
    res = [equiv[o] for o in outs]
    return res[0] if one else res


@singledispatch
def _vectorize_node(op, node: Apply, *batched_inputs) -> Apply:
    """Fallback batching rule: wrap the core op in Blockwise."""
    from pytensor_tpu_torch.tensor.blockwise import vectorize_node_fallback

    return vectorize_node_fallback(op, node, *batched_inputs)


def vectorize_node(node: Apply, *batched_inputs) -> Apply:
    return _vectorize_node(node.op, node, *batched_inputs)


def vectorize_graph(outputs, replace: dict):
    """Vectorize ``outputs`` given batched replacements for some inputs.

    Each key in ``replace`` maps a variable to a batched version with
    extra leading dims; the ops along the way are batched by
    ``_vectorize_node`` (the Blockwise fallback)."""
    one = isinstance(outputs, Variable)
    outs = [outputs] if one else list(outputs)
    inputs = truncated_graph_inputs(outs, list(replace))
    vect: dict = {i: replace.get(i, i) for i in inputs}
    for node in io_toposort(inputs, outs):
        vect_inputs = [vect.get(i, i) for i in node.inputs]
        if all(vi is i for vi, i in zip(vect_inputs, node.inputs)):
            vect_node = node
        else:
            vect_node = vectorize_node(node, *vect_inputs)
        for out, vout in zip(node.outputs, vect_node.outputs):
            vect.setdefault(out, vout)
    res = [vect.get(o, o) for o in outs]
    return res[0] if one else res

"""Graph substitution utilities.

Parallels PyTensor's graph/replace.py (clone_replace:41,
graph_replace:93).
"""

from __future__ import annotations

from typing import Sequence

from pytensor_tpu_torch.graph.basic import Variable, clone_get_equiv
from pytensor_tpu_torch.graph.traversal import graph_inputs, truncated_graph_inputs


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

"""Ancestor bitsets for fast independence checks.

Counterpart of ``pytensor_tpu/graph/rewriting/reachability.py``
(PyTensor's graph/rewriting/reachability.py ancestor_bitsets:21,
greedy_independent_subset:70), whole: for fusion-style
passes to pick maximal sets of mutually independent nodes.
"""

from __future__ import annotations

from pytensor_tpu_torch.graph.fg import FunctionGraph


def ancestor_bitsets(fgraph: FunctionGraph) -> dict:
    """{node: int bitmask of ancestor node ids} over the fgraph toposort."""
    order = fgraph.toposort()
    index = {n: i for i, n in enumerate(order)}
    bits: dict = {}
    for n in order:
        mask = 0
        for i in n.inputs:
            p = i.owner
            if p is not None and p in index:
                mask |= bits.get(p, 0) | (1 << index[p])
        bits[n] = mask
    return bits


def independent(a, b, bits, index) -> bool:
    """True if neither node is an ancestor of the other."""
    return not (bits[a] >> index[b]) & 1 and not (bits[b] >> index[a]) & 1


def greedy_independent_subset(nodes, fgraph: FunctionGraph) -> list:
    """Greedy maximal subset of pairwise-independent nodes."""
    order = fgraph.toposort()
    index = {n: i for i, n in enumerate(order)}
    bits = ancestor_bitsets(fgraph)
    chosen: list = []
    for n in nodes:
        if n not in index:
            continue
        if all(independent(n, c, bits, index) for c in chosen):
            chosen.append(n)
    return chosen

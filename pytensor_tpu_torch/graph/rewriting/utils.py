"""Apply a rewrite query to loose variables (counterpart of
``pytensor_tpu/graph/rewriting/utils.py rewrite_graph``)."""

from __future__ import annotations

from pytensor_tpu_torch.graph.basic import Variable
from pytensor_tpu_torch.graph.fg import FunctionGraph


def rewrite_graph(graph, include=("canonicalize",), custom_rewrite=None, clone=False,
                  **kwargs):
    """Apply the ``optdb`` query selected by the ``include`` tags (or
    ``custom_rewrite``) to a Variable, a list of them or a FunctionGraph;
    returns the same kind."""
    from pytensor_tpu_torch.compile.mode import optdb
    from pytensor_tpu_torch.graph.rewriting.db import RewriteDatabaseQuery

    if isinstance(graph, FunctionGraph):
        fgraph, one = graph, False
    else:
        one = isinstance(graph, Variable)
        fgraph = FunctionGraph(outputs=[graph] if one else list(graph), clone=clone)
    if custom_rewrite is not None:
        custom_rewrite.rewrite(fgraph)
    else:
        optdb.query(RewriteDatabaseQuery(include=include, **kwargs)).rewrite(fgraph)
    if isinstance(graph, FunctionGraph):
        return fgraph
    return fgraph.outputs[0] if one else fgraph.outputs

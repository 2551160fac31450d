"""Inner-graph rewriting bridge.

Counterpart of ``pytensor_tpu/compile/rewriting.py:18 RewriteInnerGraphs``:
run the active mode's rewrite query inside the inner graph of every Scan,
so that the tags a mode adds (``mode.including("onehot_gather")``) reach
loop bodies.  Left out: OpFromGraph bodies, which in the port only come
from the fusion pass, and fusion is excluded here.
"""

from __future__ import annotations

from pytensor_tpu_torch.compile.mode import optdb
from pytensor_tpu_torch.graph.rewriting.basic import GraphRewriter
from pytensor_tpu_torch.graph.rewriting.db import RewriteDatabaseQuery


class RewriteInnerGraphs(GraphRewriter):
    """Apply the active mode's rewrite query to every Scan's inner graph.

    ``wants_query``: when selected from ``optdb``, ``bind_query`` hands
    this rewriter the query it was selected under.
    """

    name = "rewrite_inner_graphs"
    wants_query = True

    # fusion and in-place passes belong to the outer graph; the scan
    # rewrites and this bridge do not recurse
    BASE_EXCLUDE = ("fusion", "inplace", "scan", "inner_unsafe",
                    "rewrite_inner_graphs")

    def __init__(self, include=("fast_run",), exclude=BASE_EXCLUDE):
        self.include = tuple(include)
        self.exclude = tuple(exclude)

    def bind_query(self, query):
        return RewriteInnerGraphs(
            include=tuple(query.include),
            exclude=tuple(set(self.BASE_EXCLUDE) | set(query.exclude)),
        )

    def apply(self, fgraph):
        """Each Scan is replaced by one whose inner graph is a rewritten
        copy: the inner graph of a Scan the caller still holds is never
        changed in place (the JAX package rewrites it in place)."""
        from pytensor_tpu_torch.scan.op import Scan

        rewriter = optdb.query(RewriteDatabaseQuery(include=self.include,
                                                    exclude=self.exclude))
        count = 0
        for node in fgraph.toposort():
            if not isinstance(node.op, Scan):
                continue
            new_op = node.op.rebuilt(node.op.fgraph.clone(), node.op.info)
            rewriter.rewrite(new_op.fgraph)
            fgraph.replace_all_validate(
                list(zip(node.outputs, new_op(*node.inputs, return_list=True))),
                reason=self.name)
            count += 1
        return count


optdb.register(
    "rewrite_inner_graphs",
    RewriteInnerGraphs(),
    "fast_run",
    position=49.6,  # the JAX package's position
)

"""Inner-graph rewriting bridge.

Counterpart of ``pytensor_tpu/compile/rewriting.py:18 RewriteInnerGraphs``:
run the active mode's rewrite query inside the inner graph of every Scan
and every OpFromGraph (the fused elementwise nodes, which the bridge
follows in the pipeline), so that stabilisations reach loop bodies and
fused bodies, and the tags a mode adds (``mode.including("onehot_gather")``)
reach loop bodies.
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
        """Each Scan and OpFromGraph is replaced by one whose inner graph is
        a rewritten copy: the inner graph of an op the caller still holds is
        never changed in place (the JAX package rewrites it in place).  A
        fused body whose rewritten copy K1 could not emit (an op the fusion
        pass would not admit, a constant output) keeps its body."""
        from pytensor_tpu_torch.compile.builders import OpFromGraph
        from pytensor_tpu_torch.graph.basic import Constant
        from pytensor_tpu_torch.scan.op import Scan
        from pytensor_tpu_torch.tensor.fused import FusedElemwise, fusable

        rewriter = optdb.query(RewriteDatabaseQuery(include=self.include,
                                                    exclude=self.exclude))
        count = 0
        for node in fgraph.toposort():
            op = node.op
            if isinstance(op, Scan):
                new_op = op.rebuilt(op.fgraph.clone(), op.info)
                rewriter.rewrite(new_op.fgraph)
            elif isinstance(op, OpFromGraph):
                inner = op.fgraph.clone()
                rewriter.rewrite(inner)
                if isinstance(op, FusedElemwise) and (
                        not all(fusable(n) for n in inner.apply_nodes)
                        or any(isinstance(o, Constant) for o in inner.outputs)):
                    continue
                new_op = op.with_fgraph(inner)
            else:
                continue
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

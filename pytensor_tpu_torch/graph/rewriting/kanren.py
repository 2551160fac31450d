"""Relational graph rewriting over the vendored microKanren core.

Counterpart of ``pytensor_tpu/graph/rewriting/kanren.py`` (PyTensor's
graph/rewriting/kanren.py KanrenRelationSub:243), whole.  PyTensor
depends on the external miniKanren package; the port, as the JAX
package, vendors a minimal core
(graph/rewriting/microkanren.py) so relational rewrites are always
available — no optional dependency, no dead code path.

Relations are goals over TERMS: a graph ``Apply`` becomes the tuple
``(op, *input_terms)``; leaf Variables/Constants are ground atoms; use
``microkanren.var()`` for holes.  ``KanrenRelationSub(relation)`` is a
NodeRewriter that queries ``relation(in_term, out_lvar)`` and rebuilds
the graph from the first answer.
"""

from __future__ import annotations

from pytensor_tpu_torch.graph.basic import Variable
from pytensor_tpu_torch.graph.rewriting.basic import NodeRewriter, copy_stack_trace
from pytensor_tpu_torch.graph.rewriting.microkanren import (  # noqa: F401
    LVar,
    conde,
    eq,
    lall,
    run,
    unify,
    var,
)

HAS_KANREN = True  # always: the core is vendored


def graph_to_term(v: Variable):
    """Variable -> nested (op, *args) tuple (leaves stay as atoms)."""
    if v.owner is None:
        return v
    node = v.owner
    if len(node.outputs) != 1:
        return v  # multi-output applies stay opaque atoms
    return (node.op,) + tuple(graph_to_term(i) for i in node.inputs)


def term_to_graph(t):
    """Nested (op, *args) tuple -> Variable (rebuilds applies)."""
    if not isinstance(t, tuple):
        if isinstance(t, LVar):
            raise ValueError(f"unbound logic variable {t} in result term")
        return t
    op = t[0]
    args = [term_to_graph(a) for a in t[1:]]
    out = op(*args)
    if isinstance(out, (list, tuple)):
        out = out[0]
    return out


class KanrenRelationSub(NodeRewriter):
    """Node rewriter driven by a relation over (in_term, out_term).

    ``relation(in_term, out_lvar)`` must be a microkanren goal; the
    first answer (reified out term) replaces the node's output when its
    type is compatible.
    """

    def __init__(self, relation, node_filter=None, name=None):
        self.relation = relation
        self.node_filter = node_filter
        self.name = name or "KanrenRelationSub"

    def tracks(self):
        return None

    def transform(self, fgraph, node):
        if self.node_filter is not None and not self.node_filter(node):
            return False
        if len(node.outputs) != 1:
            return False
        out = node.outputs[0]
        in_term = graph_to_term(out)
        q = var()
        try:
            results = run(1, q, self.relation(in_term, q))
        except Exception:
            return False
        if not results:
            return False
        try:
            new_out = term_to_graph(results[0])
        except Exception:
            return False
        if not isinstance(new_out, Variable):
            return False
        if not out.type.is_super(new_out.type):
            return False
        copy_stack_trace(out, new_out)
        return [new_out]

    def __str__(self):
        return self.name

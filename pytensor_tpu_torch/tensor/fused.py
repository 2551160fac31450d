"""FusedElemwise: one kernel per fused elementwise subgraph.

Counterpart of ``pytensor_tpu/tensor/fused.py`` (PyTensor's
tensor/rewriting/fused_elemwise.py FusedElemwise:107).  The JAX package
either inlines the subgraph for XLA's fuser or, behind a flag and above
1,024 elements, emits a Pallas kernel.  Eager PyTorch has no fuser, so
here the kernel is the fusion: on a CUDA tensor every FusedElemwise runs
as one generated CUDA kernel (``tensor/fused_kernel.py``, K1), at every
size.  The fusion pass admits only the scalar ops that kernel can emit;
that is a rewrite-time choice, never a runtime fallback.
"""

from __future__ import annotations

from pytensor_tpu_torch.compile.builders import OpFromGraph
from pytensor_tpu_torch.tensor.fused_kernel import emittable


class FusedElemwise(OpFromGraph):
    """Container for a fused elementwise subgraph (possibly multi-output)."""

    def __str__(self):
        inner_ops = sorted({str(n.op) for n in self.fgraph.apply_nodes})
        return f"FusedElemwise{{{'|'.join(inner_ops)[:60]}}}"


def fusable(node) -> bool:
    """An Elemwise node whose scalar op and dtypes the K1 emitter covers."""
    from pytensor_tpu_torch.tensor.elemwise import Elemwise

    return isinstance(node.op, Elemwise) and emittable(node)


def _register_fusion_pass():
    """composite_elemwise_fusion: greedily merge connected Elemwise chains
    into FusedElemwise containers (PyTensor's FusionOptimizer:570)."""
    from pytensor_tpu_torch.compile.mode import fusedb
    from pytensor_tpu_torch.graph.basic import Constant
    from pytensor_tpu_torch.graph.rewriting.basic import GraphRewriter

    class FusionOptimizer(GraphRewriter):
        name = "composite_elemwise_fusion"

        def apply(self, fgraph):
            changed = 0
            grouped: set = set()
            # deterministic member order for input/output collection:
            # iterating the `group` set directly would order by id()
            topo_pos = {n: i for i, n in enumerate(fgraph.toposort())}
            for root in reversed(fgraph.toposort()):
                if root in grouped or root not in fgraph.apply_nodes:
                    continue
                if not fusable(root):
                    continue
                group = {root}
                frontier = list(root.inputs)
                while frontier:
                    v = frontier.pop()
                    n = v.owner
                    if n is None or n in group or not fusable(n):
                        continue
                    clients = [
                        c for c, _ in fgraph.clients.get(v, ())
                        if c != "output"
                    ]
                    if not all(c in group for c in clients):
                        continue
                    if any(c == "output" for c, _ in fgraph.clients.get(v, ())):
                        continue
                    group.add(n)
                    frontier.extend(n.inputs)
                if len(group) < 2:
                    continue
                # group inputs/outputs (in topological member order)
                members = sorted(group, key=lambda n: topo_pos.get(n, -1))
                g_inputs = []
                for n in members:
                    for i in n.inputs:
                        if (i.owner not in group) and i not in g_inputs \
                                and not isinstance(i, Constant):
                            g_inputs.append(i)
                g_outputs = []
                for n in members:
                    for o in n.outputs:
                        cl = fgraph.clients.get(o, ())
                        if any(c == "output" or c not in group
                               for c, _ in cl) and o not in g_outputs:
                            g_outputs.append(o)
                if not g_outputs or len(g_inputs) > 16:
                    continue
                fused_op = FusedElemwise(g_inputs, g_outputs)
                new_outs = fused_op(*g_inputs)
                if not isinstance(new_outs, list):
                    new_outs = [new_outs]
                try:
                    fgraph.replace_all_validate(
                        list(zip(g_outputs, new_outs)), reason="elemwise_fusion"
                    )
                    changed += 1
                    grouped.update(group)
                except Exception:
                    continue
            return changed

    fusedb.register("composite_elemwise_fusion", FusionOptimizer(),
                    "fast_run", "fusion", position=1)


_register_fusion_pass()

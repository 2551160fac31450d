"""AssumptionFeature: a FunctionGraph feature caching fact inference.

Counterpart of ``pytensor_tpu/assumptions/feature.py`` (PyTensor's
assumptions/core.py:178, AssumptionFeature).  PyTensor propagates facts eagerly on import;
here queries are lazy with whole-cache invalidation on graph mutation —
same results, and the cache makes repeated ``holds`` queries from the
specialize pass O(1) per (variable, fact) instead of re-walking the
ancestry each time.  Attached by ``AssumeOptimizer`` at optdb position
0.11 (right after the ShapeFeature).
"""

from __future__ import annotations

from pytensor_tpu_torch.graph.features import Feature
from pytensor_tpu_torch.graph.rewriting.basic import GraphRewriter


class AssumptionFeature(Feature):
    def on_attach(self, fgraph):
        if hasattr(fgraph, "assumption_feature"):
            raise RuntimeError("AssumptionFeature already attached")
        fgraph.assumption_feature = self
        self._cache = {}

    def on_detach(self, fgraph):
        if getattr(fgraph, "assumption_feature", None) is self:
            del fgraph.assumption_feature
        self._cache = {}

    def on_import(self, fgraph, node, reason):
        self._cache.clear()

    def on_prune(self, fgraph, node, reason):
        self._cache.clear()

    def on_change_input(self, fgraph, node, i, old_var, new_var,
                        reason=None):
        self._cache.clear()

    def holds(self, var, fact):
        from pytensor_tpu_torch.assumptions import holds as _holds

        key = (var, fact)
        hit = self._cache.get(key)
        if hit is not None:
            return hit
        res = _holds(var, fact)
        self._cache[key] = res
        return res


class AssumeOptimizer(GraphRewriter):
    """Attach the AssumptionFeature (reference AssumptionFeature:178)."""

    def add_requirements(self, fgraph):
        if not hasattr(fgraph, "assumption_feature"):
            fgraph.attach_feature(AssumptionFeature())

    def apply(self, fgraph):
        pass


def _register():
    from pytensor_tpu_torch.compile.mode import optdb

    optdb.register("AssumeOpt", AssumeOptimizer(), "fast_run",
                   "fast_compile", position=0.11)


_register()

"""The rewrite engine.

Parallels PyTensor's graph/rewriting/basic.py
(GraphRewriter:89, NodeRewriter:157, node_rewriter:1035,
PatternNodeRewriter:1425, WalkingGraphRewriter:2028,
EquilibriumGraphRewriter:2219, MergeOptimizer + MergeFeature:530,
copy_stack_trace:2865) with an original implementation.
"""

from __future__ import annotations

import functools
import time
import warnings
from collections import defaultdict, deque
from typing import Iterable, Sequence

from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable
from pytensor_tpu_torch.graph.fg import FunctionGraph


class MetaRewriter:
    name: str | None = None

    def add_requirements(self, fgraph: FunctionGraph):
        """Attach any Features this rewriter needs."""

    def __str__(self):
        return self.name or type(self).__name__


class GraphRewriter(MetaRewriter):
    """Rewriter applied to a whole FunctionGraph."""

    def apply(self, fgraph: FunctionGraph):
        raise NotImplementedError

    def rewrite(self, fgraph: FunctionGraph, *args, **kwargs):
        self.add_requirements(fgraph)
        return self.apply(fgraph, *args, **kwargs)

    def __call__(self, fgraph):
        return self.rewrite(fgraph)


class NodeRewriter(MetaRewriter):
    """Rewriter operating on a single Apply node.

    ``transform`` returns False/None (no match), a list of replacement
    output variables, or a dict {old_var: new_var}.
    """

    def tracks(self) -> Sequence | None:
        """Op (classes or instances) this rewriter may fire on, or None for all."""
        return None

    def transform(self, fgraph: FunctionGraph, node: Apply):
        raise NotImplementedError

    def __call__(self, fgraph, node):
        return self.transform(fgraph, node)


class FromFunctionNodeRewriter(NodeRewriter):
    def __init__(self, fn, tracks=None, inplace=False):
        self.fn = fn
        self._tracks = tracks
        self.inplace = inplace
        self.name = getattr(fn, "__name__", None)
        self.__doc__ = getattr(fn, "__doc__", None)

    def tracks(self):
        return self._tracks

    def transform(self, fgraph, node):
        if self._tracks is not None:
            op = node.op
            if not any(
                (isinstance(t, type) and isinstance(op, t)) or op == t
                for t in self._tracks
            ):
                return False
        return self.fn(fgraph, node)

    def __str__(self):
        return self.name or "FromFunctionNodeRewriter"


def node_rewriter(tracks: Sequence | None, inplace: bool = False):
    """Decorator: ``@node_rewriter([SomeOp])`` over ``fn(fgraph, node)``."""

    def decorator(fn):
        rewriter = FromFunctionNodeRewriter(fn, tracks, inplace)
        functools.update_wrapper(rewriter, fn, updated=[])
        return rewriter

    return decorator


def copy_stack_trace(from_var, to_var):
    """Propagate creation traces through rewrites (provenance)."""
    tr = []
    if isinstance(from_var, Iterable) and not isinstance(from_var, Variable):
        for v in from_var:
            tr += getattr(v.tag, "trace", [])
    else:
        tr = getattr(from_var.tag, "trace", [])
    if isinstance(to_var, Iterable) and not isinstance(to_var, Variable):
        for v in to_var:
            v.tag.trace = list(tr)
    else:
        to_var.tag.trace = list(tr)
    return to_var


def _warn_failure(where, e):
    """A rewrite that raises is skipped with a warning and the rewriting
    goes on (PyTensor's default ``on_opt_error='warn'``)."""
    warnings.warn(f"Rewrite failure in {where}: {e}")


class SequentialGraphRewriter(GraphRewriter):
    """Apply sub-rewriters in order."""

    def __init__(self, *rewriters, name=None):
        if len(rewriters) == 1 and isinstance(rewriters[0], (list, tuple)):
            rewriters = rewriters[0]
        self.rewriters = list(rewriters)
        self.name = name

    def apply(self, fgraph):
        profs = []
        for rewriter in self.rewriters:
            try:
                t0 = time.perf_counter()
                profs.append((str(rewriter), rewriter.rewrite(fgraph), time.perf_counter() - t0))
            except Exception as e:
                _warn_failure(rewriter, e)
        return profs

    def add_requirements(self, fgraph):
        for r in self.rewriters:
            r.add_requirements(fgraph)


def _apply_node_rewriter(fgraph, rewriter, node):
    """Run one node rewriter on one node and apply its replacements.
    Returns True if the graph changed."""
    repl = rewriter.transform(fgraph, node)
    if not repl:
        return False
    if isinstance(repl, dict):
        pairs = [(k, v) for k, v in repl.items() if k != "remove"]
    else:
        if len(repl) != len(node.outputs):
            raise ValueError(
                f"Node rewriter {rewriter} replaced {len(node.outputs)} outputs "
                f"with {len(repl)} values on {node}"
            )
        pairs = [
            (o, n) for o, n in zip(node.outputs, repl) if n is not None and o is not n
        ]
    if not pairs:
        return False
    fgraph.replace_all_validate(pairs, reason=str(rewriter))
    return True


class WalkingGraphRewriter(GraphRewriter):
    """One pass over the graph in topological order, applying a node rewriter."""

    def __init__(self, node_rewriter, name=None):
        self.node_rewriter = node_rewriter
        self.name = name or f"Walking({node_rewriter})"

    def add_requirements(self, fgraph):
        self.node_rewriter.add_requirements(fgraph)

    def apply(self, fgraph):
        nb = 0
        for node in fgraph.toposort():
            if node not in fgraph.apply_nodes:
                continue
            try:
                if _apply_node_rewriter(fgraph, self.node_rewriter, node):
                    nb += 1
            except Exception as e:
                _warn_failure(f"{self.node_rewriter} on {node}", e)
        return nb


class SequentialNodeRewriter(NodeRewriter):
    """Try several node rewriters on a node; first match wins per pass."""

    def __init__(self, *rewriters, name=None):
        self.rewriters = list(rewriters)
        self.name = name

    def tracks(self):
        t = []
        for r in self.rewriters:
            rt = r.tracks()
            if rt is None:
                return None
            t.extend(rt)
        return t

    def transform(self, fgraph, node):
        for r in self.rewriters:
            res = r.transform(fgraph, node)
            if res:
                return res
        return False

    def add_requirements(self, fgraph):
        for r in self.rewriters:
            r.add_requirements(fgraph)


class OpToRewriterTracker:
    """Index node rewriters by the Ops they track (reference :1089)."""

    def __init__(self):
        self.tracked_instances: dict = defaultdict(list)
        self.tracked_types: dict = defaultdict(list)
        self.untracked: list = []

    def add_tracker(self, rewriter: NodeRewriter):
        tracks = rewriter.tracks()
        if tracks is None:
            self.untracked.append(rewriter)
        else:
            for t in tracks:
                if isinstance(t, type):
                    self.tracked_types[t].append(rewriter)
                else:
                    self.tracked_instances[t].append(rewriter)

    def get_trackers(self, op) -> list:
        res = list(self.tracked_instances.get(op, ()))
        for typ, rs in self.tracked_types.items():
            if isinstance(op, typ):
                res.extend(rs)
        res.extend(self.untracked)
        return res


class EquilibriumGraphRewriter(GraphRewriter):
    """Apply node rewriters repeatedly until fixpoint (or max passes)."""

    # rewrites applied per node (plus slack) before the pass gives up
    max_use_ratio = 8.0

    def __init__(self, rewriters, name=None):
        self.rewriters = list(rewriters)
        self.name = name
        self.tracker = OpToRewriterTracker()
        self.global_rewriters = []
        for r in self.rewriters:
            if isinstance(r, GraphRewriter):
                self.global_rewriters.append(r)
            else:
                self.tracker.add_tracker(r)

    def add_requirements(self, fgraph):
        for r in self.rewriters:
            r.add_requirements(fgraph)

    def apply(self, fgraph):
        max_uses = self.max_use_ratio * (len(fgraph.apply_nodes) + len(self.rewriters) + 10)
        uses = 0
        changed = True
        passes = 0
        while changed and uses < max_uses:
            changed = False
            passes += 1
            for grew in self.global_rewriters:
                try:
                    grew.apply(fgraph)
                except Exception as e:
                    _warn_failure(grew, e)
            q = deque(fgraph.toposort())
            while q:
                node = q.popleft()
                if node not in fgraph.apply_nodes:
                    continue
                for r in self.tracker.get_trackers(node.op):
                    if node not in fgraph.apply_nodes:
                        break
                    try:
                        if _apply_node_rewriter(fgraph, r, node):
                            uses += 1
                            changed = True
                            break
                    except Exception as e:
                        _warn_failure(f"{r} on {node}", e)
            if uses >= max_uses:
                warnings.warn(
                    f"EquilibriumGraphRewriter {self.name}: max use ratio reached"
                )
        return passes


class MergeOptimizer(GraphRewriter):
    """Common-subexpression elimination: merge Apply nodes with the same op
    and same inputs, and duplicate constants (reference MergeOptimizer)."""

    name = "MergeOptimizer"

    def apply(self, fgraph):
        nb_merged = 0
        # 1. merge equal constants
        sig_to_const: dict = {}
        for var in list(fgraph.variables):
            if isinstance(var, Constant):
                try:
                    sig = var.signature()
                except Exception:
                    continue
                first = sig_to_const.get(sig)
                if first is None:
                    sig_to_const[sig] = var
                elif first is not var and first.type == var.type:
                    for client in list(fgraph.clients.get(var, [])):
                        node, idx = client
                        fgraph.change_node_input(node, idx, first, reason="MergeOptimizer",
                                                 check=False)
                    nb_merged += 1
        # 2. merge identical applies, iterating to fixpoint
        changed = True
        while changed:
            changed = False
            seen: dict = {}
            for node in fgraph.toposort():
                if node not in fgraph.apply_nodes:
                    continue
                if node.op.destroy_map:
                    continue  # never merge destructive ops
                try:
                    key = (node.op, tuple(node.inputs))
                except TypeError:
                    continue
                prev = seen.get(key)
                if prev is None:
                    seen[key] = node
                elif prev is not node:
                    pairs = list(zip(node.outputs, prev.outputs))
                    try:
                        fgraph.replace_all_validate(pairs, reason="MergeOptimizer")
                        nb_merged += 1
                        changed = True
                    except Exception:
                        pass
        return nb_merged

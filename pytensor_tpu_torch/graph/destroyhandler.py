"""Destroy/view alias tracking.

Counterpart of ``pytensor_tpu/graph/destroyhandler.py`` (PyTensor's
graph/destroyhandler.py:281), whole.  PyTensor's DestroyHandler makes
destructive C ops safe: it orders each destructive node after every
other reader and detects aliasing cycles.  The port's lowerings write in
place only where the linker plans it (a shared tensor's ``copy_`` update,
after every reader of the old value), so, as in the JAX package, what is
kept here is the analysis: which inputs each op views or destroys
(``view_map`` / ``destroy_map``), the orderings a destroyer needs, the
refusal of protected, doubly destroyed or cyclic destruction
(``validate``), and the donation report: which inputs a call could hand
over.
"""

from __future__ import annotations

from pytensor_tpu_torch.graph.basic import Apply, Variable
from pytensor_tpu_torch.graph.features import AlreadyThere, Feature


def inplace_candidates(fgraph, node) -> list[int]:
    """Input indices of ``node`` that could be safely overwritten: the
    value is not an fgraph input/constant and has no other consumers."""
    res = []
    for idx, i in enumerate(node.inputs):
        if i.owner is None:
            continue
        clients = fgraph.clients.get(i, ())
        if len(clients) == 1:
            res.append(idx)
    return res


def _contains_cycle(fgraph, orderings) -> bool:
    """Would the extra orderings create a cycle? (Kahn count check.)"""
    from pytensor_tpu_torch.graph.traversal import general_toposort

    def deps(obj):
        rval = []
        if isinstance(obj, Variable):
            if obj.owner is not None:
                rval.append(obj.owner)
        elif isinstance(obj, Apply):
            rval.extend(obj.inputs)
            rval.extend(orderings.get(obj, ()))
        return rval

    try:
        general_toposort(fgraph.outputs, deps)
        return False
    except ValueError:
        return True


def view_root(var):
    """Follow ``view_map`` chains to the storage root of ``var``
    (PyTensor's destroyhandler.py get_var_root)."""
    while var.owner is not None:
        vmap = getattr(var.owner.op, "view_map", None)
        if not vmap:
            return var
        out_idx = var.owner.outputs.index(var)
        if out_idx not in vmap:
            return var
        (in_idx,) = vmap[out_idx]
        var = var.owner.inputs[in_idx]
    return var


def _aliases_of(fgraph, root):
    """Every live variable whose storage is (a view of) ``root``."""
    out = {root}
    frontier = [root]
    while frontier:
        v = frontier.pop()
        for client, idx in fgraph.clients.get(v, ()):
            if client == "output":
                continue
            vmap = getattr(client.op, "view_map", None)
            if not vmap:
                continue
            for out_idx, in_idxs in vmap.items():
                if idx in in_idxs:
                    o = client.outputs[out_idx]
                    if o not in out:
                        out.add(o)
                        frontier.append(o)
    return out


class InconsistencyError(Exception):
    """DestroyHandler validation failure (PyTensor's graph/fg.py name)."""


class DestroyHandler(Feature):
    """Safety analysis for destructive and viewing ops (PyTensor's
    destroyhandler.py:281).

    Tracks view chains to storage roots, orders each destroyer after
    every reader of any alias of the destroyed root, and refuses the
    destruction of a protected variable, two destroyers of one root and
    ordering cycles."""

    def __init__(self, do_imports_on_attach=True):
        self.protected: set = set()

    def on_attach(self, fgraph):
        if hasattr(fgraph, "destroy_handler"):
            raise AlreadyThere()
        fgraph.destroy_handler = self
        fgraph.protect = self.protect
        fgraph.has_destroyers = self.has_destroyers_fn(fgraph)

    def on_detach(self, fgraph):
        del fgraph.destroy_handler
        del fgraph.protect
        del fgraph.has_destroyers

    def protect(self, var):
        self.protected.add(var)

    def _destroyed_roots(self, fgraph):
        """{root: [destroyer nodes]} over the current graph."""
        roots = {}
        for node in fgraph.apply_nodes:
            dmap = getattr(node.op, "destroy_map", None)
            if not dmap:
                continue
            for out_idx, in_idxs in dmap.items():
                for in_idx in in_idxs:
                    r = view_root(node.inputs[in_idx])
                    roots.setdefault(r, []).append(node)
        return roots

    def has_destroyers_fn(self, fgraph):
        def has_destroyers(protected_list):
            roots = self._destroyed_roots(fgraph)
            destroyed = set(roots)
            return [view_root(v) in destroyed for v in protected_list]

        return has_destroyers

    def orderings(self, fgraph):
        """Each destroyer runs after every reader of every alias of the
        destroyed storage root (not just direct readers of the input)."""
        ords = {}
        for root, destroyers in self._destroyed_roots(fgraph).items():
            for node in destroyers:
                readers = []
                for alias in _aliases_of(fgraph, root):
                    for c, _ in fgraph.clients.get(alias, ()):
                        if c != "output" and c is not node:
                            readers.append(c)
                if readers:
                    ords.setdefault(node, []).extend(readers)
        return ords

    def validate(self, fgraph):
        roots = self._destroyed_roots(fgraph)
        for root, destroyers in roots.items():
            if len(destroyers) > 1:
                raise InconsistencyError(f"multiple destroyers of {root}: {destroyers}")
            if root in self.protected or any(
                    a in self.protected for a in _aliases_of(fgraph, root)):
                raise InconsistencyError(
                    f"{destroyers[0]} would destroy protected variable {root}")
            if root.owner is None and root in fgraph.inputs:
                # fgraph inputs are only destroyable when explicitly
                # unprotected (PyTensor's Supervisor contract)
                if getattr(root.tag, "destroyable", False) is not True:
                    raise InconsistencyError(
                        f"{destroyers[0]} would destroy fgraph input {root} "
                        f"(mark tag.destroyable to allow)")
        if _contains_cycle(fgraph, self.orderings(fgraph)):
            raise InconsistencyError("destroy orderings introduce a cycle")


def donation_report(fgraph) -> dict:
    """Which fgraph inputs a call could donate: {input index: whether every
    client of the input is a node, none an output}."""
    report = {}
    for idx, inp in enumerate(fgraph.inputs):
        clients = fgraph.clients.get(inp, ())
        report[idx] = len(clients) > 0 and all(c != "output" for c, _ in clients)
    return report

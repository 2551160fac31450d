"""Memory aliasing contracts.

Counterpart of ``pytensor_tpu/compile/aliasing.py`` (PyTensor's
compile/aliasing.py Supervisor:75, infer_reuse_pattern:55,
insert_deepcopy:165).  ``Supervisor`` refuses a node that destroys a
protected (not mutable) input; ``infer_reuse_pattern`` follows the view
chains of outputs.  ``insert_deepcopy`` changes nothing: the executor
copies an output that shares storage with a shared tensor
(``compile/executor.py``).  ``alias_root`` and ``view_tree_set`` are
``graph/destroyhandler.py``'s view analysis.
"""

from __future__ import annotations

from pytensor_tpu_torch.graph.features import AlreadyThere, Feature


class Supervisor(Feature):
    """Forbid the destruction of the protected variables."""

    def __init__(self, protected):
        self.protected = list(protected)

    def on_attach(self, fgraph):
        if hasattr(fgraph, "_supervisor"):
            raise AlreadyThere()
        fgraph._supervisor = self

    def validate(self, fgraph):
        for node in fgraph.apply_nodes:
            for in_idxs in (getattr(node.op, "destroy_map", None) or {}).values():
                for idx in in_idxs:
                    if node.inputs[idx] in self.protected:
                        raise Exception(f"Supervisor: {node} destroys protected input "
                                        f"{node.inputs[idx]}")


def add_supervisor_to_fgraph(fgraph, input_specs, accept_inplace=False):
    """Protect every input of ``input_specs`` (``In``s or variables) that
    is not ``mutable``."""
    protected = [spec.variable if hasattr(spec, "variable") else spec
                 for spec in input_specs if not getattr(spec, "mutable", False)]
    fgraph.attach_feature(Supervisor(protected))
    return fgraph


def infer_reuse_pattern(fgraph, outputs_to_disown):
    """The variables whose storage an output may share: its view chains."""
    seen = set()
    frontier = list(outputs_to_disown)
    while frontier:
        v = frontier.pop()
        if v in seen or v.owner is None:
            continue
        seen.add(v)
        vmap = getattr(v.owner.op, "view_map", None) or {}
        idx = v.owner.outputs.index(v)
        for in_idx in vmap.get(idx, ()):
            frontier.append(v.owner.inputs[in_idx])
    return seen


def insert_deepcopy(fgraph, wrapped_inputs, wrapped_outputs):
    """Nothing to insert: ``Function`` copies the outputs that share
    storage with a shared tensor when it returns them."""
    return fgraph


def alias_root(var):
    """Storage root of a view chain (``graph.destroyhandler.view_root``)."""
    from pytensor_tpu_torch.graph.destroyhandler import view_root

    return view_root(var)


def view_tree_set(fgraph, var):
    """Every live alias of ``var``'s storage root."""
    from pytensor_tpu_torch.graph.destroyhandler import _aliases_of, view_root

    return _aliases_of(fgraph, view_root(var))

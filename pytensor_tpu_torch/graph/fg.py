"""FunctionGraph: a mutable container for a subgraph under rewriting.

Parallels PyTensor's graph/fg.py (FunctionGraph:69,
replace:477, attach_feature:666, toposort:752): maintains a clients index
(var -> [(apply|'output', input_index)]), imports/prunes nodes, notifies
Features, and validates integrity.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from pytensor_tpu_torch.graph.basic import Apply, AtomicVariable, Constant, Variable, clone_get_equiv
from pytensor_tpu_torch.graph.features import AlreadyThere, Feature, ReplaceValidate
from pytensor_tpu_torch.graph.traversal import graph_inputs, io_toposort


class MissingInputError(Exception):
    """A variable needed to compute outputs is not in fgraph inputs."""


class FunctionGraph:
    """Holds ``inputs`` -> ``outputs`` with a clients index and features."""

    def __init__(
        self,
        inputs: Sequence[Variable] | None = None,
        outputs: Sequence[Variable] | None = None,
        features: Iterable[Feature] | None = None,
        clone: bool = True,
        update_mapping: dict | None = None,
        copy_inputs: bool = True,
        copy_orphans: bool | None = None,
    ):
        if outputs is None:
            raise ValueError("outputs must be provided")
        if inputs is None:
            inputs = [i for i in graph_inputs(outputs) if not isinstance(i, Constant)]
        if clone:
            if copy_orphans is None:
                copy_orphans = copy_inputs
            memo = clone_get_equiv(inputs, outputs, copy_inputs, copy_orphans)
            inputs = [memo[i] for i in inputs]
            outputs = [memo[o] for o in outputs]

        self.inputs: list[Variable] = []
        self.outputs: list[Variable] = list(outputs)
        self.clients: dict[Variable, list] = {}
        self.apply_nodes: set[Apply] = set()
        self.variables: set[Variable] = set()
        self._features: list[Feature] = []
        self.update_mapping = update_mapping or {}
        self.execute_callbacks_time: float = 0.0

        for f in features or ():
            self.attach_feature(f)
        self.attach_feature(ReplaceValidate())

        for inp in inputs:
            self.add_input(inp, check=False)
        for i, out in enumerate(self.outputs):
            self.import_var(out, reason="init")
            self.clients[out].append(("output", i))

    # --- structure ---
    def add_input(self, var: Variable, check: bool = True):
        if check and var in self.inputs:
            return
        if var.owner is not None:
            raise ValueError(f"{var} has an owner and cannot be a graph input")
        self.inputs.append(var)
        self.variables.add(var)
        self.clients.setdefault(var, [])

    def import_var(self, var: Variable, reason=None, import_missing: bool = False):
        if var in self.variables:
            return
        if var.owner is not None:
            self.import_node(var.owner, reason=reason, import_missing=import_missing)
        elif isinstance(var, AtomicVariable):
            self.variables.add(var)
            self.clients.setdefault(var, [])
        elif import_missing:
            self.add_input(var)
        else:
            raise MissingInputError(
                f"Input {var} of the graph could not be imported; it was not "
                f"provided as an fgraph input and has no owner. "
                + getattr(getattr(var, "tag", None), "trace_string", "")
            )

    def import_node(self, node: Apply, check: bool = True, reason=None, import_missing=False):
        if node in self.apply_nodes:
            return
        # local postorder over the NEW nodes only (walk stops at variables
        # already in the graph) — keeps replace() linear in the new subgraph
        # rather than in the whole graph
        order: list[Apply] = []
        visited: set = set()
        stack: list[tuple[str, Apply]] = [("pre", node)]
        while stack:
            phase, n = stack.pop()
            if phase == "pre":
                if n in self.apply_nodes or id(n) in visited:
                    continue
                visited.add(id(n))
                stack.append(("post", n))
                for i in reversed(n.inputs):
                    if i in self.variables:
                        continue
                    if i.owner is not None:
                        stack.append(("pre", i.owner))
                    elif isinstance(i, AtomicVariable) or import_missing:
                        pass
                    elif check:
                        raise MissingInputError(
                            f"Cannot import {n}: input {i} is not in the graph "
                            f"and has no owner."
                        )
            else:
                order.append(n)
        for n in order:
            if n in self.apply_nodes:
                continue
            self.apply_nodes.add(n)
            if not hasattr(n.tag, "imported_by"):
                n.tag.imported_by = []
            n.tag.imported_by.append(str(reason))
            for o in n.outputs:
                self.variables.add(o)
                self.clients.setdefault(o, [])
            for idx, i in enumerate(n.inputs):
                if i not in self.variables:
                    if i.owner is None and not isinstance(i, AtomicVariable):
                        if import_missing:
                            self.add_input(i)
                        else:
                            raise MissingInputError(f"Undeclared input {i}")
                    else:
                        self.variables.add(i)
                        self.clients.setdefault(i, [])
                self.clients.setdefault(i, []).append((n, idx))
            self.execute_callbacks("on_import", n, reason)

    def remove_client(self, var: Variable, client, reason=None):
        try:
            self.clients[var].remove(client)
        except (KeyError, ValueError):
            return
        # prune chain if no clients remain
        if not self.clients.get(var) and var.owner is not None:
            node = var.owner
            if not any(self.clients.get(o) for o in node.outputs):
                self._prune_node(node, reason)

    def _prune_node(self, node: Apply, reason=None):
        if node not in self.apply_nodes:
            return
        self.apply_nodes.discard(node)
        for o in node.outputs:
            self.variables.discard(o)
            self.clients.pop(o, None)
        self.execute_callbacks("on_prune", node, reason)
        for idx, i in enumerate(node.inputs):
            self.remove_client(i, (node, idx), reason)

    def change_node_input(self, node, i: int, new_var: Variable, reason=None,
                          import_missing=False, check=True):
        """Set node.inputs[i] = new_var (node may be the string 'output')."""
        if node == "output":
            old_var = self.outputs[i]
            if check and not old_var.type.is_super(new_var.type):
                raise TypeError(
                    f"Cannot change output {i} from {old_var.type} to {new_var.type}"
                )
            self.import_var(new_var, reason=reason, import_missing=import_missing)
            self.outputs[i] = new_var
            client = ("output", i)
        else:
            old_var = node.inputs[i]
            if check and not old_var.type.is_super(new_var.type):
                new_var2 = old_var.type.convert_variable(new_var)
                if new_var2 is None:
                    raise TypeError(
                        f"Cannot change input {i} of {node} from {old_var.type} "
                        f"to {new_var.type}"
                    )
                new_var = new_var2
            self.import_var(new_var, reason=reason, import_missing=import_missing)
            node.inputs[i] = new_var
            client = (node, i)
        if old_var is new_var:
            return
        self.clients.setdefault(new_var, []).append(client)
        self.remove_client(old_var, client, reason=reason)
        self.execute_callbacks(
            "on_change_input", node, i, old_var, new_var, reason=reason
        )

    def replace(self, var: Variable, new_var: Variable, reason=None, import_missing=False):
        """Replace every use of ``var`` by ``new_var``."""
        if var not in self.variables:
            return
        if new_var.type != var.type:
            converted = var.type.convert_variable(new_var)
            if converted is None:
                raise TypeError(
                    f"Replacement {new_var} of type {new_var.type} is incompatible "
                    f"with {var} of type {var.type} (reason: {reason})"
                )
            new_var = converted
        for client in list(self.clients.get(var, [])):
            node, idx = client
            if client not in self.clients.get(var, []):
                continue
            self.change_node_input(node, idx, new_var, reason=reason,
                                   import_missing=import_missing, check=False)


    # --- features ---
    def attach_feature(self, feature: Feature):
        if feature in self._features:
            return
        attach = getattr(feature, "on_attach", None)
        if attach is not None:
            try:
                attach(self)
            except AlreadyThere:
                return
        self._features.append(feature)

    def remove_feature(self, feature: Feature):
        try:
            self._features.remove(feature)
        except ValueError:
            return
        detach = getattr(feature, "on_detach", None)
        if detach is not None:
            detach(self)

    def execute_callbacks(self, name: str, *args, **kwargs):
        for feature in self._features:
            fn = getattr(feature, name, None)
            if fn is not None:
                fn(self, *args, **kwargs)

    def orderings(self) -> dict:
        """Merge extra execution-order constraints from features."""
        ords: dict[Apply, list] = {}
        for feature in self._features:
            if hasattr(feature, "orderings"):
                for node, prereqs in feature.orderings(self).items():
                    ords.setdefault(node, []).extend(prereqs)
        return ords

    # --- queries ---

    def toposort(self) -> list[Apply]:
        ords = self.orderings()
        return io_toposort(self.inputs, self.outputs, ords or None)

    def check_integrity(self):
        nodes = set(io_toposort(self.inputs, self.outputs))
        if self.apply_nodes != nodes:
            extra = self.apply_nodes - nodes
            missing = nodes - self.apply_nodes
            raise Exception(f"apply_nodes inconsistent: extra={extra}, missing={missing}")
        for node in nodes:
            for idx, i in enumerate(node.inputs):
                if (node, idx) not in self.clients.get(i, []):
                    raise Exception(f"missing client entry for input {idx} of {node}")
        for i, out in enumerate(self.outputs):
            if ("output", i) not in self.clients.get(out, []):
                raise Exception(f"missing client entry for output {i}")

    def clone(self, check_integrity: bool = True):
        return self.clone_get_equiv(check_integrity)[0]

    def clone_get_equiv(self, check_integrity: bool = True, attach_feature: bool = True):
        memo = clone_get_equiv(self.inputs, self.outputs, copy_inputs=True, copy_orphans=True)
        fg = FunctionGraph(
            [memo[i] for i in self.inputs],
            [memo[o] for o in self.outputs],
            clone=False,
            update_mapping=dict(self.update_mapping),
        )
        if attach_feature:
            for f in self._features:
                if not isinstance(f, ReplaceValidate):
                    try:
                        fg.attach_feature(f.clone())
                    except AlreadyThere:
                        pass
        if check_integrity:
            fg.check_integrity()
        return fg, memo

    def __getstate__(self):
        """The features' closures bound onto the graph (``pickle_rm_attr``)
        are left out; each feature binds them again on load."""
        d = self.__dict__.copy()
        for feature in self._features:
            for attr in getattr(feature, "pickle_rm_attr", ()):
                d.pop(attr, None)
        return d

    def __setstate__(self, state):
        self.__dict__.update(state)
        for feature in self._features:
            unpickle = getattr(feature, "unpickle", None)
            if unpickle is not None:
                unpickle(self)

    def __contains__(self, thing):
        if isinstance(thing, Variable):
            return thing in self.variables
        return thing in self.apply_nodes

    def __str__(self):
        return f"FunctionGraph({', '.join(map(str, self.outputs))})"

    def __repr__(self):
        return str(self)

    def dprint(self, **kwargs):
        from pytensor_tpu_torch.printing import debugprint

        return debugprint(self, **kwargs)


def equal_computations(xs, ys, in_xs=None, in_ys=None):
    """Structural graph equality (PyTensor's graph/basic.py
    equal_computations): True iff xs and ys compute the same outputs given
    in_xs == in_ys."""
    in_xs = list(in_xs or [])
    in_ys = list(in_ys or [])
    if len(xs) != len(ys) or len(in_xs) != len(in_ys):
        return False
    equiv: dict = dict(zip(in_xs, in_ys))

    def eq(a, b):
        if a in equiv:
            return equiv[a] is b
        if isinstance(a, Constant) and isinstance(b, Constant):
            return a.type == b.type and a.type.values_eq(a.data, b.data)
        if (a.owner is None) != (b.owner is None):
            return False
        if a.owner is None:
            # free variables must be the same variable
            return a is b
        na, nb = a.owner, b.owner
        if na.op != nb.op or len(na.inputs) != len(nb.inputs):
            return False
        if na.outputs.index(a) != nb.outputs.index(b):
            return False
        if not all(eq(ia, ib) for ia, ib in zip(na.inputs, nb.inputs)):
            return False
        equiv[a] = b
        return True

    return all(eq(x, y) for x, y in zip(xs, ys))

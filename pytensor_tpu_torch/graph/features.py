"""Observer plugins for FunctionGraph.

Parallels PyTensor's graph/features.py (Feature:297,
History:439, FullHistory:502, ReplaceValidate:710): features get callbacks on graph
mutation and can validate or veto replacements.  A feature that binds
closures onto its graph names them in ``pickle_rm_attr``; a pickle of the
graph leaves them out and ``unpickle`` binds them again on load.
"""

from __future__ import annotations


class AlreadyThere(Exception):
    """Raised by on_attach when an equivalent feature is already attached."""


class Feature:
    def on_attach(self, fgraph):
        """Called by FunctionGraph.attach_feature."""

    def on_detach(self, fgraph):
        """Called by FunctionGraph.remove_feature."""

    def on_import(self, fgraph, node, reason):
        """Called when a node is added to the graph."""

    def on_prune(self, fgraph, node, reason):
        """Called when a node is removed from the graph."""

    def on_change_input(self, fgraph, node, i, old_var, new_var, reason=None):
        """Called when node.inputs[i] changes from old_var to new_var."""

    def orderings(self, fgraph):
        """Extra {node: set(nodes-that-must-run-first)} constraints."""
        return {}

    def clone(self):
        return self


class History(Feature):
    """Records reversible changes; ``revert`` restores a checkpoint."""

    pickle_rm_attr = ["checkpoint", "revert"]

    def __init__(self):
        self.history = {}

    def on_attach(self, fgraph):
        if hasattr(fgraph, "checkpoint") or hasattr(fgraph, "revert"):
            raise AlreadyThere("History feature already present")
        self.history[fgraph] = []
        fgraph.checkpoint = lambda: len(self.history[fgraph])
        fgraph.revert = lambda checkpoint: self.revert(fgraph, checkpoint)

    def on_detach(self, fgraph):
        del fgraph.checkpoint
        del fgraph.revert
        del self.history[fgraph]

    def on_change_input(self, fgraph, node, i, old_var, new_var, reason=None):
        if self.history[fgraph] is None:
            return
        self.history[fgraph].append(
            lambda: fgraph.change_node_input(node, i, old_var, reason="Revert")
        )

    def __getstate__(self):
        # the recorded edits are closures over live graphs: a loaded
        # graph starts with an empty history
        d = self.__dict__.copy()
        d["history"] = {}
        return d

    def unpickle(self, fgraph):
        self.history.setdefault(fgraph, [])
        fgraph.checkpoint = lambda: len(self.history[fgraph])
        fgraph.revert = lambda checkpoint: self.revert(fgraph, checkpoint)

    def revert(self, fgraph, checkpoint):
        h = self.history[fgraph]
        self.history[fgraph] = None
        while len(h) > checkpoint:
            f = h.pop()
            f()
        self.history[fgraph] = h


class Validator(Feature):
    pickle_rm_attr = ["validate", "consistent"]

    def on_attach(self, fgraph):
        if hasattr(fgraph, "validate"):
            raise AlreadyThere("Validator feature already present")
        fgraph.validate = lambda: self.validate_(fgraph)
        fgraph.consistent = lambda: self.consistent_(fgraph)

    def on_detach(self, fgraph):
        del fgraph.validate
        del fgraph.consistent

    def unpickle(self, fgraph):
        fgraph.validate = lambda: self.validate_(fgraph)
        fgraph.consistent = lambda: self.consistent_(fgraph)

    def validate_(self, fgraph):
        return fgraph.execute_callbacks("validate")

    def consistent_(self, fgraph):
        try:
            fgraph.validate()
            return True
        except Exception:
            return False


class ReplaceValidate(History, Validator):
    """Transactional replace: validate after replacement, revert on failure."""

    pickle_rm_attr = History.pickle_rm_attr + Validator.pickle_rm_attr + [
        "replace_validate",
        "replace_all_validate",
    ]

    def on_attach(self, fgraph):
        for attr in ("replace_validate", "replace_all_validate"):
            if hasattr(fgraph, attr):
                raise AlreadyThere("ReplaceValidate feature already present")
        History.on_attach(self, fgraph)
        Validator.on_attach(self, fgraph)
        fgraph.replace_validate = lambda r, new_r, reason=None, **kw: self.replace_validate(
            fgraph, r, new_r, reason=reason, **kw
        )
        fgraph.replace_all_validate = lambda repl, reason=None, **kw: self.replace_all_validate(
            fgraph, repl, reason=reason, **kw
        )

    def on_detach(self, fgraph):
        History.on_detach(self, fgraph)
        Validator.on_detach(self, fgraph)
        del fgraph.replace_validate
        del fgraph.replace_all_validate

    def unpickle(self, fgraph):
        History.unpickle(self, fgraph)
        Validator.unpickle(self, fgraph)
        fgraph.replace_validate = lambda r, new_r, reason=None, **kw: self.replace_validate(
            fgraph, r, new_r, reason=reason, **kw
        )
        fgraph.replace_all_validate = lambda repl, reason=None, **kw: self.replace_all_validate(
            fgraph, repl, reason=reason, **kw
        )

    def replace_validate(self, fgraph, r, new_r, reason=None, **kwargs):
        self.replace_all_validate(fgraph, [(r, new_r)], reason=reason, **kwargs)

    def replace_all_validate(self, fgraph, replacements, reason=None, **kwargs):
        chk = fgraph.checkpoint()
        for r, new_r in replacements:
            try:
                fgraph.replace(r, new_r, reason=reason, **kwargs)
            except Exception as e:
                fgraph.revert(chk)
                raise
        try:
            fgraph.validate()
        except Exception:
            fgraph.revert(chk)
            raise
        return chk


class FullHistory(Feature):
    """Complete undo/redo history of graph changes (PyTensor's
    graph/features.py FullHistory:502), with each change's reason: step
    backward and forward through the rewrites (``DebugMode``'s rewrite
    blame, ``compile/debug/debugmode.py``)."""

    def __init__(self, callback=None):
        self.fw: list = []
        self.bw: list = []
        self.reasons: list = []  # rewrite reason per recorded change
        self.pointer = -1
        self.fg = None
        self.callback = callback

    def on_attach(self, fgraph):
        if self.fg is not None:
            raise AlreadyThere("FullHistory already attached")
        self.fg = fgraph

    def on_change_input(self, fgraph, node, i, old_var, new_var, reason=None):
        if self.pointer != len(self.fw) - 1 and self.pointer != -1:
            # drop the redo tail after a new change
            del self.fw[self.pointer + 1:]
            del self.bw[self.pointer + 1:]
            del self.reasons[self.pointer + 1:]
        self.bw.append(lambda: fgraph.change_node_input(node, i, old_var,
                                                        reason="undo"))
        self.fw.append(lambda: fgraph.change_node_input(node, i, new_var,
                                                        reason="redo"))
        self.reasons.append(reason)
        self.pointer = len(self.fw) - 1
        if self.callback:
            self.callback()

    def prev(self):
        if self.pointer >= 0:
            f = self.bw[self.pointer]
            # temporarily detach to avoid recording the undo itself
            ptr = self.pointer
            fw, bw = self.fw, self.bw
            self.fw, self.bw = [], []
            f()
            self.fw, self.bw = fw, bw
            self.pointer = ptr - 1
        return self.fg

    def next(self):
        if self.pointer < len(self.fw) - 1:
            ptr = self.pointer
            fw, bw = self.fw, self.bw
            self.fw, self.bw = [], []
            fw[ptr + 1]()
            self.fw, self.bw = fw, bw
            self.pointer = ptr + 1
        return self.fg

    def start(self):
        while self.pointer >= 0:
            self.prev()
        return self.fg

    def end(self):
        while self.pointer < len(self.fw) - 1:
            self.next()
        return self.fg

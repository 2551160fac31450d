"""Modes: linker + rewrite query; the global pass pipeline (optdb).

Counterpart of ``pytensor_tpu/compile/mode.py`` (PyTensor's
compile/mode.py Mode:332, optdb:190).  The pass schedule keeps the JAX
package's optdb positions: merge1(0) -> useless(0.6) -> merge1.1(0.65)
-> canonicalize(1) -> merge1.2(1.2) -> stabilize(1.5) -> specialize(2)
-> uncanonicalize(3) -> merge2(49) -> fusion(49.05) -> merge3(100), with
the scan rewrites at 1.601-1.62 (``scan/rewriting.py``) and the
inner-graph bridge at 49.6 (``compile/rewriting.py``).
``FAST_RUN`` links with ``"torch"``, whose ``required_rewrites`` tag is
``"torch"``: passes tagged for the XLA linker have no place here.

The modes are the JAX package's (``pytensor_tpu/compile/mode.py:191-244``):
``FAST_COMPILE`` is the ``"fast_compile"`` query linked with ``"py"``,
``PY`` the ``"fast_run"`` query linked with ``"py"``, ``FAST_RUN`` the
``"fast_run"`` query linked with ``"torch"``.  The JAX package's ``"py"``
linker runs each node's numpy ``perform`` on the host; the port's ops have
no numpy ``perform``, so its ``"py"`` is the linker's plan run eagerly,
node by node, on the device the caller names, never captured
(``link/torch/linker.py PyLinker``).  The other backends' mode names map
as in the JAX package: ``C`` and ``CVM`` to ``"py"`` with ``"fast_run"``,
``NUMBA``, ``JAX``, ``PYTORCH`` and ``MLX`` to ``FAST_RUN``.
``AddDestroyHandler``, ``AddFeatureOptimizer`` and
``PrintCurrentFunctionGraph`` are passes a mode runs after its own
(``Mode.register``).  ``get_mode`` also takes the names ``DebugMode`` and
``NanGuardMode`` (``compile/debug/``), a new mode each time, as in the
JAX package.  Left out: the ``check_stack_trace`` audit pass.
"""

from __future__ import annotations

from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.graph.rewriting.basic import GraphRewriter, MergeOptimizer
from pytensor_tpu_torch.graph.rewriting.db import (
    EquilibriumDB,
    RewriteDatabaseQuery,
    SequenceDB,
    TopoDB,
)

# --- the global rewrite database -------------------------------------------

optdb = SequenceDB(name="optdb")

optdb.register("merge1", MergeOptimizer(), "fast_run", "fast_compile", "merge",
               position=0)

# removal-only cheap rewrites
useless = TopoDB(name="useless")
optdb.register("useless", useless, "fast_run", "fast_compile", position=0.6)

optdb.register("merge1.1", MergeOptimizer(), "fast_run", "fast_compile", "merge",
               position=0.65)

canonicalize = EquilibriumDB(name="canonicalize")
optdb.register("canonicalize", canonicalize, "fast_run", "fast_compile", position=1)

optdb.register("merge1.2", MergeOptimizer(), "fast_run", "fast_compile", "merge",
               position=1.2)

stabilize = EquilibriumDB(name="stabilize")
optdb.register("stabilize", stabilize, "fast_run", position=1.5)

specialize = EquilibriumDB(name="specialize")
optdb.register("specialize", specialize, "fast_run", position=2)

uncanonicalize = EquilibriumDB(name="uncanonicalize")
optdb.register("uncanonicalize", uncanonicalize, "fast_run", position=3)

optdb.register("merge2", MergeOptimizer(), "fast_run", "merge", position=49)

# elemwise fusion region (PyTensor's tensor/rewriting/elemwise.py:1291)
fusedb = SequenceDB(name="elemwise_fusion")
optdb.register("elemwise_fusion", fusedb, "fast_run", "fusion", position=49.05)

optdb.register("merge3", MergeOptimizer(), "fast_run", "merge", position=100)


# registration helpers (PyTensor's tensor/rewriting/basic.py:261)
def _name(rewrite, name):
    return name or getattr(rewrite, "name", None) or getattr(rewrite, "__name__", str(rewrite))


def register_canonicalize(rewrite, *tags, name=None, **kwargs):
    canonicalize.register(_name(rewrite, name), rewrite, "fast_run", "fast_compile",
                          *tags, **kwargs)
    return rewrite


def register_specialize(rewrite, *tags, name=None, **kwargs):
    specialize.register(_name(rewrite, name), rewrite, "fast_run", *tags, **kwargs)
    return rewrite


def register_stabilize(rewrite, *tags, name=None, **kwargs):
    stabilize.register(_name(rewrite, name), rewrite, "fast_run", *tags, **kwargs)
    return rewrite


def register_useless(rewrite, *tags, name=None, **kwargs):
    useless.register(_name(rewrite, name), rewrite, "fast_run", "fast_compile",
                     *tags, **kwargs)
    return rewrite


# --- Mode -------------------------------------------------------------------

# the linkers by name; the classes are imported at first use (the linker's
# dispatch table imports every op module)
predefined_linkers: dict = {}


def _linker_class(linker):
    if not isinstance(linker, str):
        return linker if isinstance(linker, type) else type(linker)
    if not predefined_linkers:
        from pytensor_tpu_torch.link.torch.linker import PyLinker, TorchLinker

        predefined_linkers.setdefault("torch", TorchLinker)
        predefined_linkers.setdefault("py", PyLinker)
    if linker not in predefined_linkers:
        raise ValueError(f"Unknown linker {linker!r}; the port has {sorted(predefined_linkers)}")
    return predefined_linkers[linker]


class Mode:
    """A linker (a name, a class or an instance) plus a query of ``db``
    (``optdb`` unless given).  ``optimizer`` is a query or the name of a
    tag (``"None"`` selects nothing)."""

    def __init__(self, linker=None, optimizer="fast_run", db=None):
        self.linker = "torch" if linker is None else linker
        if isinstance(optimizer, str):
            optimizer = RewriteDatabaseQuery(include=[optimizer] if optimizer != "None" else [])
        self._optimizer = optimizer
        self.db = optdb if db is None else db

    def make_linker(self):
        """The linker: its ``make_torch_fn(fgraph, device, trust_input)``
        links a rewritten graph."""
        linker = self.linker
        if isinstance(linker, str):
            return _linker_class(linker)()
        return linker() if isinstance(linker, type) else linker

    @property
    def optimizer(self):
        """The pass pipeline: the query plus the linker's required tags."""
        req = getattr(_linker_class(self.linker), "required_rewrites", ())
        return self.db.query(self._optimizer.including(*req))

    def including(self, *tags):
        return Mode(self.linker, self._optimizer.including(*tags), self.db)

    def excluding(self, *tags):
        return Mode(self.linker, self._optimizer.excluding(*tags), self.db)

    def requiring(self, *tags):
        return Mode(self.linker, self._optimizer.requiring(*tags), self.db)

    def register(self, *rewrites):
        """A mode that also runs ``rewrites`` after the selected passes."""
        return Mode(self.linker, self._optimizer.register(*rewrites), self.db)

    def __reduce__(self):
        # a pickle names optdb rather than holding it
        return (Mode, (self.linker, self._optimizer, None if self.db is optdb else self.db))

    def __str__(self):
        return f"Mode(linker={self.linker}, optimizer={self._optimizer})"


FAST_COMPILE = Mode("py", RewriteDatabaseQuery(include=["fast_compile"]))
FAST_RUN = Mode("torch", RewriteDatabaseQuery(include=["fast_run"]))
PY = Mode("py", RewriteDatabaseQuery(include=["fast_run"]))

predefined_modes = {
    "FAST_COMPILE": FAST_COMPILE,
    "FAST_RUN": FAST_RUN,
    "PY": PY,
}


def get_mode(mode):
    """The Mode named by ``mode``; None means ``config.mode``."""
    if mode is None:
        mode = config.mode
    if isinstance(mode, str):
        if mode == "DebugMode":
            from pytensor_tpu_torch.compile.debug.debugmode import DebugMode

            return DebugMode()
        if mode == "NanGuardMode":
            from pytensor_tpu_torch.compile.debug.nanguardmode import NanGuardMode

            return NanGuardMode()
        if mode not in predefined_modes:
            raise ValueError(f"Unknown mode {mode!r}")
        return predefined_modes[mode]
    return mode


def get_default_mode():
    return get_mode(None)


# --- the registries and the named queries of the JAX package ----------------

predefined_optimizers = {
    "fast_run": RewriteDatabaseQuery(include=["fast_run"]),
    "fast_compile": RewriteDatabaseQuery(include=["fast_compile"]),
    "None": RewriteDatabaseQuery(include=[]),
    "merge": RewriteDatabaseQuery(include=["merge"]),
}
OPT_NONE = predefined_optimizers["None"]
OPT_MERGE = predefined_optimizers["merge"]
OPT_FAST_COMPILE = predefined_optimizers["fast_compile"]
OPT_FAST_RUN = predefined_optimizers["fast_run"]
OPT_FAST_RUN_STABLE = OPT_FAST_RUN
OPT_O2 = OPT_FAST_RUN
OPT_O3 = OPT_FAST_RUN
OPT_STABILIZE = RewriteDatabaseQuery(include=["fast_run", "stabilize"])
OPT_UNSAFE = OPT_FAST_RUN


def register_linker(name, linker_cls):
    _linker_class("torch")  # the built-in linkers first
    predefined_linkers[name] = linker_cls


def register_optimizer(name, query):
    predefined_optimizers[name] = query


def register_mode(name, mode):
    predefined_modes[name] = mode


class AddDestroyHandler(GraphRewriter):
    """A pass that attaches the DestroyHandler (PyTensor's
    compile/mode.py:118): its orderings then order the graph's toposort,
    and its ``validate`` refuses unsafe destruction."""

    def apply(self, fgraph):
        pass

    def add_requirements(self, fgraph):
        from pytensor_tpu_torch.graph.destroyhandler import DestroyHandler
        from pytensor_tpu_torch.graph.features import AlreadyThere

        try:
            fgraph.attach_feature(DestroyHandler())
        except AlreadyThere:
            pass


class AddFeatureOptimizer(GraphRewriter):
    """A pass that attaches ``feature`` to the graph (PyTensor's
    compile/mode.py:155)."""

    def __init__(self, feature):
        self.feature = feature

    def apply(self, fgraph):
        pass

    def add_requirements(self, fgraph):
        from pytensor_tpu_torch.graph.features import AlreadyThere

        try:
            fgraph.attach_feature(self.feature)
        except AlreadyThere:
            pass


class PrintCurrentFunctionGraph(GraphRewriter):
    """A pass that prints the graph when it is reached (PyTensor's
    compile/mode.py:171)."""

    def __init__(self, header=""):
        self.header = header

    def apply(self, fgraph):
        from pytensor_tpu_torch.printing import debugprint

        if self.header:
            print(self.header)
        debugprint(fgraph)


# the other backends' mode names, as the JAX package maps them
C = Mode(linker="py", optimizer="fast_run")
CVM = C
NUMBA = FAST_RUN
JAX = FAST_RUN
PYTORCH = FAST_RUN
MLX = FAST_RUN

local_useless = useless  # PyTensor's compile/mode.py:201 name

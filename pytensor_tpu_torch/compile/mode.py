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
"""

from __future__ import annotations

from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.graph.rewriting.basic import MergeOptimizer
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

def _linker_class(name: str):
    if name != "torch":
        raise ValueError(f"Unknown linker {name!r}; the port has 'torch'")
    # imported late: the linker's dispatch table imports every op module
    from pytensor_tpu_torch.link.torch.linker import TorchLinker

    return TorchLinker


class Mode:
    """A linker (by name) plus a query of ``optdb``."""

    def __init__(self, linker: str, optimizer: RewriteDatabaseQuery):
        self.linker = linker
        self._optimizer = optimizer

    @property
    def optimizer(self):
        """The pass pipeline: the query plus the linker's required tags."""
        req = _linker_class(self.linker).required_rewrites
        return optdb.query(self._optimizer.including(*req))

    def including(self, *tags):
        return Mode(self.linker, self._optimizer.including(*tags))

    def excluding(self, *tags):
        return Mode(self.linker, self._optimizer.excluding(*tags))

    def __str__(self):
        return f"Mode(linker={self.linker}, optimizer={self._optimizer})"


FAST_RUN = Mode("torch", RewriteDatabaseQuery(include=["fast_run"]))

predefined_modes = {"FAST_RUN": FAST_RUN}


def get_mode(mode):
    """The Mode named by ``mode``; None means ``config.mode``."""
    if mode is None:
        mode = config.mode
    if isinstance(mode, str):
        if mode not in predefined_modes:
            raise ValueError(f"Unknown mode {mode!r}")
        return predefined_modes[mode]
    return mode

"""Tag-based rewrite registry and query.

Parallels PyTensor's graph/rewriting/db.py
(RewriteDatabase:18, RewriteDatabaseQuery:186, EquilibriumDB:297,
SequenceDB:378).  Modes query the global ``optdb`` with a set of tags to
assemble their pass pipeline.
"""

from __future__ import annotations

from typing import Iterable

from pytensor_tpu_torch.graph.rewriting.basic import (
    EquilibriumGraphRewriter,
    SequentialGraphRewriter,
    SequentialNodeRewriter,
    WalkingGraphRewriter,
)


class RewriteDatabase:
    def __init__(self):
        self._names: dict[str, object] = {}
        self._tags: dict[str, set[str]] = {}

    def register(self, name: str, rewriter, *tags, use_db_name_as_tag: bool = True):
        """Register ``rewriter`` under ``name``, selected by its name, its
        ``tags`` and, unless ``use_db_name_as_tag`` is False, the name of
        this database."""
        if name in self._names:
            raise ValueError(f"Rewrite name collision: {name}")
        self._names[name] = rewriter
        tagset = {name, *tags}
        if use_db_name_as_tag and getattr(self, "name", None):
            tagset.add(self.name)
        self._tags[name] = tagset
        return rewriter

    def __contains__(self, name):
        return name in self._names

    def __getitem__(self, name):
        return self._names[name]

    def _selected(self, name, query: "RewriteDatabaseQuery") -> bool:
        if self._tags[name] & query.exclude:
            return False
        if isinstance(self._names[name], RewriteDatabase):
            # a sub-db descends unless excluded: its members filter themselves
            return True
        return bool(self._tags[name] & query.include)

    def query(self, query: "RewriteDatabaseQuery"):
        raise NotImplementedError


class RewriteDatabaseQuery:
    """The tags that select rewrites from a database: a rewrite is selected
    when it carries any of ``include`` and none of ``exclude``.
    ``require`` is recorded, as the JAX package records it, and selects
    nothing; ``extra_rewrites`` run after the selected passes of a
    ``SequenceDB`` (``Mode.register``)."""

    def __init__(self, include: Iterable[str], exclude: Iterable[str] = (),
                 require: Iterable[str] = (), extra_rewrites=()):
        self.include = frozenset(include)
        self.exclude = frozenset(exclude)
        self.require = frozenset(require)
        self.extra_rewrites = tuple(extra_rewrites)

    def _with(self, include, exclude, require=None, extra=()):
        return RewriteDatabaseQuery(include, exclude,
                                    self.require if require is None else require,
                                    self.extra_rewrites + tuple(extra))

    def including(self, *tags) -> "RewriteDatabaseQuery":
        return self._with(self.include | set(tags), self.exclude - set(tags))

    def excluding(self, *tags) -> "RewriteDatabaseQuery":
        return self._with(self.include - set(tags), self.exclude | set(tags))

    def requiring(self, *tags) -> "RewriteDatabaseQuery":
        return self._with(self.include, self.exclude, self.require | set(tags))

    def register(self, *rewrites) -> "RewriteDatabaseQuery":
        return self._with(self.include, self.exclude, extra=rewrites)

    def __str__(self):
        return (f"RewriteDatabaseQuery(inc={sorted(self.include)}, "
                f"ex={sorted(self.exclude)}, req={sorted(self.require)})")


class SequenceDB(RewriteDatabase):
    """Position-ordered database; query returns a SequentialGraphRewriter."""

    seq_rewriter = SequentialGraphRewriter

    def __init__(self, name=None):
        super().__init__()
        self.positions: dict[str, float] = {}
        self.name = name

    def register(self, name, rewriter, *tags, position: float = 50.0):
        super().register(name, rewriter, *tags)
        self.positions[name] = float(position)
        return rewriter

    def query(self, query: RewriteDatabaseQuery):
        selected = []
        # the extra rewrites run once, after this database's passes
        inner = RewriteDatabaseQuery(query.include, query.exclude, query.require)
        for name, rewriter in self._names.items():
            if not self._selected(name, query):
                continue
            if isinstance(rewriter, RewriteDatabase):
                rewriter = rewriter.query(inner)
            elif getattr(rewriter, "wants_query", False):
                # the inner-graph bridge re-runs the active mode's pipeline
                # inside Scan bodies: hand it the query it was selected under
                rewriter = rewriter.bind_query(query)
            selected.append((self.positions[name], rewriter))
        selected.sort(key=lambda t: t[0])
        return self.seq_rewriter([r for _, r in selected] + list(query.extra_rewrites),
                                 name=self.name)


class EquilibriumDB(RewriteDatabase):
    """Database whose query returns an EquilibriumGraphRewriter over the
    selected node rewriters."""

    def __init__(self, name=None):
        super().__init__()
        self.name = name

    def query(self, query: RewriteDatabaseQuery):
        selected = []
        for name, rewriter in self._names.items():
            if not self._selected(name, query):
                continue
            if isinstance(rewriter, RewriteDatabase):
                rewriter = rewriter.query(query)
            selected.append(rewriter)
        return EquilibriumGraphRewriter(selected, name=self.name)


class TopoDB(RewriteDatabase):
    """Database of node rewriters applied in a single topological pass."""

    def __init__(self, name=None):
        super().__init__()
        self.name = name

    def query(self, query):
        selected = [
            r for name, r in self._names.items() if self._selected(name, query)
        ]
        return WalkingGraphRewriter(SequentialNodeRewriter(*selected, name=self.name),
                                    name=self.name)

"""Generic graph walks and topological sorts.

Parallels PyTensor's graph/traversal.py (walk:40,
ancestors:97, toposort:621, io_toposort:713) with an original
implementation (iterative, no recursion limits).
"""

from __future__ import annotations

from collections import deque
from typing import Callable, Iterable, Iterator, Sequence

from pytensor_tpu_torch.graph.basic import Apply, Variable


def walk(nodes: Iterable, expand: Callable, bfs: bool = True) -> Iterator:
    """Walk through nodes, expanding neighbors with ``expand``; yields each
    reachable node exactly once."""
    frontier = deque(nodes)
    seen: set = set()
    pop = frontier.popleft if bfs else frontier.pop
    while frontier:
        node = pop()
        if id(node) in seen:
            continue
        seen.add(id(node))
        yield node
        new = expand(node)
        if new:
            frontier.extend(new)


def ancestors(graphs: Iterable[Variable], blockers: Iterable[Variable] | None = None) -> Iterator[Variable]:
    """All Variables that ``graphs`` depend on (including themselves)."""
    blockers = set(blockers) if blockers else set()

    def expand(v):
        if v.owner is not None and v not in blockers:
            return reversed(v.owner.inputs)
        return None

    yield from walk(graphs, expand, bfs=False)


def graph_inputs(graphs: Iterable[Variable], blockers=None) -> Iterator[Variable]:
    """Ownerless ancestors (inputs + constants)."""
    for v in ancestors(graphs, blockers):
        if v.owner is None:
            yield v


def vars_between(ins: Iterable[Variable], outs: Iterable[Variable]) -> Iterator[Variable]:
    """All Variables on paths from ins to outs (inclusive)."""
    ins = set(ins)

    def expand(v):
        if v.owner is not None and v not in ins:
            return reversed(v.owner.inputs + v.owner.outputs)
        return None

    yield from walk(outs, expand)


def applys_between(ins: Iterable[Variable], outs: Iterable[Variable]) -> Iterator[Apply]:
    """All Apply nodes on paths from ins to outs."""
    seen = set()
    for v in vars_between(ins, outs):
        if v.owner is not None and id(v.owner) not in seen:
            seen.add(id(v.owner))
            yield v.owner


def general_toposort(
    outputs: Iterable,
    deps: Callable,
    compute_deps_cache: Callable | None = None,
) -> list:
    """Kahn-style topological sort over arbitrary nodes.

    ``deps(node)`` returns the node's dependencies.  Raises ValueError on
    cycles.
    """
    deps_cache: dict = {}

    def get_deps(n):
        if id(n) not in deps_cache:
            d = deps(n)
            deps_cache[id(n)] = list(d) if d else []
        return deps_cache[id(n)]

    # gather all nodes
    all_nodes = list(walk(outputs, get_deps, bfs=False))
    # count in-edges (number of deps)
    nparents: dict[int, int] = {}
    children: dict[int, list] = {}
    node_by_id = {}
    for n in all_nodes:
        node_by_id[id(n)] = n
        d = get_deps(n)
        nparents[id(n)] = len(d)
        for dep in d:
            children.setdefault(id(dep), []).append(n)
    ready = deque(n for n in all_nodes if nparents[id(n)] == 0)
    order = []
    while ready:
        n = ready.popleft()
        order.append(n)
        for child in children.get(id(n), ()):
            nparents[id(child)] -= 1
            if nparents[id(child)] == 0:
                ready.append(child)
    if len(order) != len(all_nodes):
        raise ValueError("graph contains cycles")
    return order


def io_toposort(
    inputs: Iterable[Variable],
    outputs: Sequence[Variable],
    orderings: dict | None = None,
) -> list[Apply]:
    """Topologically sorted Apply nodes between inputs and outputs.

    ``orderings``: {node: [nodes that must run first]}, from features.
    """
    computed = set(inputs)
    if not orderings:
        # fast path: iterative DFS postorder over Apply nodes
        seen_v: set = set(id(i) for i in inputs)
        order: list[Apply] = []
        visited_nodes: set = set()
        work: list[tuple] = [("var", o) for o in reversed(list(outputs))]
        while work:
            kind, obj = work.pop()
            if kind == "var":
                if id(obj) in seen_v:
                    continue
                seen_v.add(id(obj))
                if obj.owner is not None:
                    work.append(("node_pre", obj.owner))
            elif kind == "node_pre":
                if id(obj) in visited_nodes:
                    continue
                visited_nodes.add(id(obj))
                work.append(("node_post", obj))
                for i in reversed(obj.inputs):
                    work.append(("var", i))
            else:  # node_post
                order.append(obj)
        return order

    def deps(obj):
        rval = []
        if isinstance(obj, Variable):
            if obj.owner is not None and obj not in computed:
                rval.append(obj.owner)
        elif isinstance(obj, Apply):
            rval.extend(i for i in obj.inputs if i not in computed)
            rval.extend(orderings.get(obj, ()))
        return rval

    order = general_toposort(outputs, deps)
    return [o for o in order if isinstance(o, Apply)]


def truncated_graph_inputs(
    outputs: Sequence[Variable], ancestors_to_include: Sequence[Variable] | None = None
) -> list[Variable]:
    """Variables that cut the graph between outputs and the rest, keeping
    ``ancestors_to_include`` inside (reference graph/traversal.py)."""
    if ancestors_to_include is None:
        return list(graph_inputs(outputs))
    include = set(ancestors_to_include)
    truncated: list[Variable] = []
    seen: set = set()

    # a var is "blocked" (becomes an input) if it does not depend on any
    # include var, or is itself an include var's consumer boundary
    depends: dict[Variable, bool] = {}

    def depends_on_include(v):
        if v in depends:
            return depends[v]
        stack = [v]
        path = []
        while stack:
            cur = stack.pop()
            if cur in depends:
                continue
            if cur in include:
                depends[cur] = True
                continue
            if cur.owner is None:
                depends[cur] = False
                continue
            unresolved = [i for i in cur.owner.inputs if i not in depends]
            if unresolved:
                stack.append(cur)
                stack.extend(unresolved)
            else:
                depends[cur] = any(depends[i] for i in cur.owner.inputs)
        return depends[v]

    frontier = list(outputs)
    while frontier:
        v = frontier.pop()
        if v in seen:
            continue
        seen.add(v)
        if v in include:
            if v not in truncated:
                truncated.append(v)
            continue
        if not depends_on_include(v) or v.owner is None:
            if v not in truncated:
                truncated.append(v)
            continue
        frontier.extend(v.owner.inputs)
    return truncated

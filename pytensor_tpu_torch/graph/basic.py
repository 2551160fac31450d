"""IR datatypes: Variable, Apply, Constant.

Semantics follow the reference IR (PyTensor's graph/basic.py:
Variable:359, Apply:192, Constant:744, clone_get_equiv:990) — a Variable is
a typed edge, an Apply is an op application connecting input Variables to
output Variables — with an original implementation.
"""

from __future__ import annotations

from typing import TYPE_CHECKING, Any, Sequence

from pytensor_tpu_torch.utils import Scratchpad, add_tag_trace

if TYPE_CHECKING:
    from pytensor_tpu_torch.graph.op import Op
    from pytensor_tpu_torch.graph.type import Type


def _picklable_tag(tag: Scratchpad) -> Scratchpad:
    """A copy of ``tag`` without its creation trace."""
    out = Scratchpad().__update__(tag)
    out.__dict__.pop("trace", None)
    return out


class Node:
    """Base for Apply and Variable: anything in a graph."""

    __slots__ = ()


class Apply(Node):
    """An application of an Op to input Variables, producing output Variables."""

    __slots__ = ("op", "inputs", "outputs", "tag", "__weakref__")

    def __init__(self, op: "Op", inputs: Sequence["Variable"], outputs: Sequence["Variable"]):
        self.op = op
        self.inputs = list(inputs)
        self.outputs = list(outputs)
        self.tag = Scratchpad()
        for v in inputs:
            if not isinstance(v, Variable):
                raise TypeError(f"Apply inputs must be Variables, got {type(v)}")
        for i, v in enumerate(outputs):
            if not isinstance(v, Variable):
                raise TypeError(f"Apply outputs must be Variables, got {type(v)}")
            if v.owner is not None and v.owner is not self:
                raise ValueError("Variable already owned by another Apply")
            v.owner = self
            v.index = i

    @property
    def nin(self) -> int:
        return len(self.inputs)

    @property
    def nout(self) -> int:
        return len(self.outputs)

    def default_output(self) -> "Variable":
        idx = getattr(self.op, "default_output", None)
        if idx is None:
            if len(self.outputs) == 1:
                return self.outputs[0]
            raise ValueError(f"Multi-output op {self.op} has no default output")
        return self.outputs[idx]

    @property
    def out(self) -> "Variable":
        return self.default_output()

    def clone(self, clone_inner_graph: bool = False) -> "Apply":
        op = self.op
        if clone_inner_graph and hasattr(op, "fgraph"):
            op = op.clone()
        new = Apply(op, self.inputs, [v.clone() for v in self.outputs])
        new.tag.__update__(self.tag)
        return new

    def clone_with_new_inputs(
        self, inputs: Sequence["Variable"], strict: bool = True, clone_inner_graph: bool = False
    ) -> "Apply":
        inputs = list(inputs)
        remake = False
        for cur, new in zip(self.inputs, inputs):
            if cur.type != new.type:
                if strict:
                    raise TypeError(
                        f"Cannot change input type in clone_with_new_inputs: {cur.type} vs {new.type}"
                    )
                remake = True
        op = self.op
        if clone_inner_graph and hasattr(op, "fgraph"):
            op = op.clone()
        if remake:
            node = op.make_node(*inputs)
        else:
            node = Apply(op, inputs, [v.clone() for v in self.outputs])
            node.tag.__update__(self.tag)
        return node

    def __getstate__(self):
        return (self.op, self.inputs, self.outputs, _picklable_tag(self.tag))

    def __setstate__(self, state):
        self.op, self.inputs, self.outputs, self.tag = state

    def __str__(self) -> str:
        return f"{self.op}({', '.join(map(str, self.inputs))})"

    def __repr__(self) -> str:
        return str(self)


class Variable(Node):
    """A typed symbolic value: an edge in the graph.

    ``owner`` is the Apply producing it (None for graph inputs), ``index``
    its position in ``owner.outputs``.
    """

    __slots__ = ("type", "owner", "index", "name", "tag", "auto_name", "__weakref__")
    _count = 0

    def __init__(self, type: "Type", owner: Apply | None = None,
                 index: int | None = None, name: str | None = None):
        self.type = type
        self.owner = owner
        self.index = index
        self.name = name
        self.tag = Scratchpad()
        Variable._count += 1
        self.auto_name = f"auto_{Variable._count}"
        add_tag_trace(self)

    def clone(self, **kwargs) -> "Variable":
        cp = self.__class__(self.type, None, None, kwargs.get("name", self.name))
        cp.tag.__update__(self.tag)
        return cp

    def __getstate__(self):
        # every slot of the class and its bases, the tag without its
        # creation trace (frames of another process say nothing)
        d = {}
        for klass in type(self).__mro__:
            for slot in getattr(klass, "__slots__", ()):
                if slot != "__weakref__" and hasattr(self, slot):
                    d[slot] = getattr(self, slot)
        d["tag"] = _picklable_tag(d["tag"])
        return d

    def __setstate__(self, d):
        for k, v in d.items():
            setattr(self, k, v)

    def __str__(self) -> str:
        if self.name is not None:
            return self.name
        if self.owner is not None:
            op = self.owner.op
            if len(self.owner.outputs) == 1:
                return f"{op}.out"
            return f"{op}.{self.index}"
        return f"<{self.type}>"

    def __repr__(self) -> str:
        return str(self)

    # containers may not be hashed by value
    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)


class AtomicVariable(Variable):
    """A Variable with no owner by definition (Constant)."""

    __slots__ = ()

    def __init__(self, type, name=None, **kwargs):
        super().__init__(type, None, None, name)

    @property
    def owner(self):
        return None

    @owner.setter
    def owner(self, value):
        if value is not None:
            raise ValueError("AtomicVariable cannot have an owner")

    @property
    def index(self):
        return None

    @index.setter
    def index(self, value):
        if value is not None:
            raise ValueError("AtomicVariable cannot have an index")


class Constant(AtomicVariable):
    """A Variable with a fixed value; owner is always None."""

    __slots__ = ("data",)

    def __init__(self, type: "Type", data: Any, name: str | None = None):
        super().__init__(type, name)
        self.data = type.filter(data)

    def signature(self):
        return (self.type, self.type.make_constant_signature(self.data))

    @property
    def value(self):
        return self.data

    def clone(self, **kwargs):
        return self

    def __str__(self) -> str:
        if self.name is not None:
            return self.name
        s = str(self.data)
        if len(s) > 20:
            s = s[:10] + "..." + s[-10:]
        return s


def clone_get_equiv(
    inputs: Sequence[Variable],
    outputs: Sequence[Variable],
    copy_inputs: bool = True,
    copy_orphans: bool = True,
    memo: dict | None = None,
    clone_inner_graphs: bool = False,
) -> dict:
    """Copy the subgraph between ``inputs`` and ``outputs``, returning a
    memo dict mapping originals to clones (reference graph/basic.py:990)."""
    from pytensor_tpu_torch.graph.traversal import io_toposort, vars_between

    if memo is None:
        memo = {}
    for inp in inputs:
        if inp not in memo:
            memo[inp] = inp.clone() if copy_inputs else inp
    for v in vars_between(inputs, outputs):
        if v.owner is None and v not in memo:
            if isinstance(v, Constant):
                memo[v] = v.clone() if copy_orphans else v
            else:
                memo[v] = v.clone() if copy_orphans else v
    for node in io_toposort(inputs, outputs):
        if node not in memo:
            new_inputs = [memo.get(i, i) for i in node.inputs]
            new_node = node.clone_with_new_inputs(
                new_inputs, strict=False, clone_inner_graph=clone_inner_graphs
            )
            memo[node] = new_node
            for old_o, new_o in zip(node.outputs, new_node.outputs):
                memo.setdefault(old_o, new_o)
    for o in outputs:
        memo.setdefault(o, o)
    return memo


def clone(
    inputs: Sequence[Variable],
    outputs: Sequence[Variable],
    copy_inputs: bool = True,
    copy_orphans: bool | None = None,
    clone_inner_graphs: bool = False,
) -> tuple[list[Variable], list[Variable]]:
    if copy_orphans is None:
        copy_orphans = copy_inputs
    memo = clone_get_equiv(inputs, outputs, copy_inputs, copy_orphans,
                           clone_inner_graphs=clone_inner_graphs)
    return [memo[i] for i in inputs], [memo[o] for o in outputs]

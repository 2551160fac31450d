"""debugprint and friends.

Counterpart of ``pytensor_tpu/printing.py`` (PyTensor's printing.py
debugprint:532, Print op:1494, pydotprint:1948, the Printer family
:1573-1791), whole: ``debugprint``/``dprint``, the ``Print`` op,
``pydotprint`` (which needs pydot and raises ImportError without it, as
the JAX package's does) and ``pprint``.  ``Print``'s lowering
(``link/torch/dispatch.py``) reads its value back to the host and prints
it there, so a plan that holds one declares ``reads_back`` and runs
eagerly: the print happens once a call, never dropped by a capture.
"""

from __future__ import annotations

import sys
from io import StringIO
from typing import Any

from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.graph.op import HasInnerGraph, Op


def debugprint(
    graph_like,
    depth: int = -1,
    print_type: bool = False,
    file=None,
    id_type: str = "CHAR",
    stop_on_name: bool = False,
    done=None,
    print_storage: bool = False,
    used_ids=None,
    print_op_info: bool = False,
    print_destroy_map: bool = False,
    print_view_map: bool = False,
    print_fgraph_inputs: bool = False,
):
    """Print a graph as an indented tree; returns the stream."""
    _file = StringIO() if file == "str" else (file or sys.stdout)
    if done is None:
        done = set()
    if used_ids is None:
        used_ids = {}

    results = []
    if isinstance(graph_like, FunctionGraph):
        if print_fgraph_inputs:
            for i in graph_like.inputs:
                _print_var(i, "→ ", 0, depth, print_type, _file, done, used_ids)
        results = graph_like.outputs
    elif isinstance(graph_like, Variable):
        results = [graph_like]
    elif isinstance(graph_like, Apply):
        results = graph_like.outputs
    elif hasattr(graph_like, "fgraph"):
        results = graph_like.fgraph.outputs
    elif isinstance(graph_like, (list, tuple)):
        for g in graph_like:
            debugprint(g, depth=depth, print_type=print_type, file=_file,
                       done=done, used_ids=used_ids)
        if file == "str":
            return _file.getvalue()
        return _file
    else:
        raise TypeError(f"debugprint cannot handle {type(graph_like)}")

    for r in results:
        _print_var(r, "", 0, depth, print_type, _file, done, used_ids)
    # inner graphs
    inner_seen = set()
    for r in results:
        _print_inner_graphs(r, depth, print_type, _file, done, used_ids, inner_seen)
    if file == "str":
        return _file.getvalue()
    return _file


def _id_of(obj, used_ids):
    if obj not in used_ids:
        used_ids[obj] = f"id {len(used_ids)}"
    return used_ids[obj]


def _print_var(var, prefix, level, depth, print_type, file, done, used_ids):
    indent = " " * (2 * level)
    type_str = f" <{var.type}>" if print_type else ""
    if var.owner is None:
        print(f"{indent}{prefix}{var}{type_str}", file=file)
        return
    node = var.owner
    op_str = str(node.op)
    out_idx = f".{var.index}" if len(node.outputs) > 1 else ""
    node_id = _id_of(node, used_ids)
    name_str = f" '{var.name}'" if var.name else ""
    print(f"{indent}{prefix}{op_str}{out_idx} [{node_id}]{name_str}{type_str}",
          file=file)
    if node in done:
        return
    done.add(node)
    if depth == 0:
        return
    for i in node.inputs:
        _print_var(i, "├─ " if i is not node.inputs[-1] else "└─ ",
                   level + 1, depth - 1, print_type, file, done, used_ids)


def _print_inner_graphs(var, depth, print_type, file, done, used_ids, seen):
    from pytensor_tpu_torch.graph.traversal import applys_between

    for node in applys_between([], [var]):
        op = node.op
        if isinstance(op, HasInnerGraph) and id(op) not in seen:
            seen.add(id(op))
            print(f"\nInner graphs of {op}:", file=file)
            for out in op.inner_outputs:
                _print_var(out, " ", 1, depth, print_type, file, set(), used_ids)


dprint = debugprint


class Print(Op):
    """Eager-print op: prints its input value at run time and passes it
    through.  Its lowering reads the value back to the host."""

    view_map = {0: [0]}
    __props__ = ("message", "attrs")

    def __init__(self, message="", attrs=("__str__",), global_fn=None):
        self.message = message
        self.attrs = tuple(attrs)

    def make_node(self, x):
        from pytensor_tpu_torch.tensor.basic import as_tensor_variable

        x = as_tensor_variable(x)
        return Apply(self, [x], [x.type()])

    def show(self, x):
        """Print the numpy value ``x`` as PyTensor's ``Print.perform``
        does: the message with each of ``attrs``."""
        for attr in self.attrs:
            if attr == "__str__":
                print(f"{self.message} {x}")
            else:
                print(f"{self.message} {attr} = {getattr(x, attr)()}")

    def infer_shape(self, fgraph, node, input_shapes):
        return input_shapes

    def L_op(self, inputs, outputs, output_grads):
        return output_grads


def pydotprint(graph_like, outfile=None, format="png", **kwargs):
    """Graphviz export of a graph (requires pydot)."""
    try:
        import pydot
    except ImportError as e:
        raise ImportError("pydotprint requires pydot") from e
    g = pydot.Dot(graph_type="digraph")
    if isinstance(graph_like, FunctionGraph):
        outputs = graph_like.outputs
    elif isinstance(graph_like, Variable):
        outputs = [graph_like]
    else:
        outputs = list(graph_like)
    from pytensor_tpu_torch.graph.traversal import applys_between

    nodes = list(applys_between([], outputs))
    names = {}

    def nm(obj, label):
        if id(obj) not in names:
            names[id(obj)] = f"n{len(names)}"
            g.add_node(pydot.Node(names[id(obj)], label=label))
        return names[id(obj)]

    for node in nodes:
        an = nm(node, str(node.op))
        for i in node.inputs:
            vn = nm(i, str(i))
            g.add_edge(pydot.Edge(vn, an))
        for o in node.outputs:
            vn = nm(o, str(o))
            g.add_edge(pydot.Edge(an, vn))
    if outfile:
        g.write(outfile, format=format)
    return g


def char_from_number(n):
    chars = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    res = ""
    while True:
        res = chars[n % 26] + res
        n //= 26
        if n == 0:
            return res


# ---------------------------------------------------------------------------
# Composable expression pretty-printer
# ---------------------------------------------------------------------------
# PyTensor's printing.py Printer:1573,
# OperatorPrinter:1590, PatternPrinter:1643, FunctionPrinter:1682,
# LeafPrinter:1745, DefaultPrinter:1772, PPrinter:1791 — a pluggable
# pipeline turning graphs into readable math expressions (`pprint`).

from abc import ABC, abstractmethod
from contextlib import contextmanager


class PrinterState:
    def __init__(self, pprinter, **kwargs):
        self.pprinter = pprinter
        self.memo: dict = {}
        self.precedence = -1000
        self.__dict__.update(kwargs)


@contextmanager
def set_precedence(pstate, precedence=-1000):
    old = pstate.precedence
    pstate.precedence = precedence
    try:
        yield
    finally:
        pstate.precedence = old


class Printer(ABC):
    @abstractmethod
    def process(self, var, pstate) -> str:
        """Return a string for ``var``."""


class LeafPrinter(Printer):
    def process(self, var, pstate):
        if var.name is not None:
            return var.name
        if isinstance(var, Constant):
            data = var.data
            try:
                import numpy as _np

                if _np.ndim(data) == 0:
                    return repr(data.item() if hasattr(data, "item") else data)
            except Exception:
                pass
            return str(data).replace("\n", " ")
        return f"<{var.type}>"


leaf_printer = LeafPrinter()


class OperatorPrinter(Printer):
    """Infix/prefix operator with precedence-driven parenthesization."""

    def __init__(self, operator, precedence, assoc="left"):
        self.operator = operator
        self.precedence = precedence
        self.assoc = assoc

    def process(self, var, pstate):
        if var in pstate.memo:
            return pstate.memo[var]
        node = var.owner
        if node is None:
            raise TypeError(f"operator {self.operator} needs an Apply node")
        outer = pstate.precedence
        parts = []
        last = len(node.inputs) - 1
        for i, inp in enumerate(node.inputs):
            prec = self.precedence
            if (self.assoc == "left" and i != 0) or \
                    (self.assoc == "right" and i != last):
                prec += 1e-6
            with set_precedence(pstate, prec):
                parts.append(pstate.pprinter.process(inp, pstate))
        if len(parts) == 1:
            s = self.operator + parts[0]
        else:
            s = f" {self.operator} ".join(parts)
        r = f"({s})" if outer > self.precedence else s
        pstate.memo[var] = r
        return r


class PatternPrinter(Printer):
    """Format-string printer: '{0} ** {1}' with processed inputs."""

    def __init__(self, pattern, precedences=()):
        self.pattern = pattern
        self.precedences = precedences

    def process(self, var, pstate):
        if var in pstate.memo:
            return pstate.memo[var]
        node = var.owner
        parts = []
        for i, inp in enumerate(node.inputs):
            prec = self.precedences[i] if i < len(self.precedences) else -1000
            with set_precedence(pstate, prec):
                parts.append(pstate.pprinter.process(inp, pstate))
        r = self.pattern.format(*parts)
        pstate.memo[var] = r
        return r


class FunctionPrinter(Printer):
    """fn(in0, in1, ...) style."""

    def __init__(self, name):
        self.name = name

    def process(self, var, pstate):
        if var in pstate.memo:
            return pstate.memo[var]
        node = var.owner
        with set_precedence(pstate):
            parts = [pstate.pprinter.process(i, pstate) for i in node.inputs]
        r = f"{self.name}({', '.join(parts)})"
        pstate.memo[var] = r
        return r


class IgnorePrinter(Printer):
    """Print straight through to the first input (view-like ops)."""

    def process(self, var, pstate):
        return pstate.pprinter.process(var.owner.inputs[0], pstate)


class DefaultPrinter(Printer):
    def process(self, var, pstate):
        if var in pstate.memo:
            return pstate.memo[var]
        node = var.owner
        if node is None:
            return leaf_printer.process(var, pstate)
        with set_precedence(pstate):
            parts = [pstate.pprinter.process(i, pstate) for i in node.inputs]
        r = f"{node.op}({', '.join(parts)})"
        pstate.memo[var] = r
        return r


class PPrinter(Printer):
    """Pluggable pretty-printer: (condition, printer) pairs, last
    assignment wins (PyTensor's PPrinter:1791)."""

    def __init__(self):
        self.printers: list = []

    def assign(self, condition, printer):
        """condition: Op instance (==), Op class, or callable(var)->bool."""
        self.printers.insert(0, (condition, printer))

    def clone(self):
        cp = PPrinter()
        cp.printers = list(self.printers)
        return cp

    def clone_assign(self, condition, printer):
        cp = self.clone()
        cp.assign(condition, printer)
        return cp

    def _match(self, condition, var):
        node = var.owner
        if isinstance(condition, type) and issubclass(condition, Op):
            return node is not None and isinstance(node.op, condition)
        if isinstance(condition, Op):
            return node is not None and node.op == condition
        return bool(condition(var))

    def process(self, var, pstate=None):
        if pstate is None:
            pstate = PrinterState(pprinter=self)
        if var in pstate.memo:
            return pstate.memo[var]
        for condition, printer in self.printers:
            try:
                if self._match(condition, var):
                    return printer.process(var, pstate)
            except Exception:
                continue
        return DefaultPrinter().process(var, pstate)

    def process_graph(self, inputs, outputs, updates=None):
        lines = []
        pstate = PrinterState(pprinter=self)
        for o in outputs:
            name = o.name or "out"
            lines.append(f"{name} = {self.process(o, pstate)}")
        for k, v in (updates or {}).items():
            lines.append(f"{k} <- {self.process(v, pstate)}")
        return "\n".join(lines)

    def __call__(self, var, **kwargs):
        from pytensor_tpu_torch.graph.fg import FunctionGraph

        if isinstance(var, FunctionGraph):
            return self.process_graph(var.inputs, var.outputs)
        if isinstance(var, (list, tuple)):
            return self.process_graph([], var)
        return self.process(var)


def _scalar_name_is(name):
    def cond(var):
        node = var.owner
        if node is None:
            return False
        sop = getattr(node.op, "scalar_op", None)
        return sop is not None and getattr(sop, "name", None) == name

    return cond


def _op_class_named(*names):
    def cond(var):
        node = var.owner
        return node is not None and type(node.op).__name__ in names

    return cond


def _build_default_pprinter() -> PPrinter:
    p = PPrinter()
    p.assign(lambda var: var.owner is None, leaf_printer)
    # elemwise arithmetic as operators
    for nm, op_str, prec in [
        ("add", "+", -2), ("sub", "-", -2),
        ("mul", "*", -1), ("true_div", "/", -1),
        ("int_div", "//", -1), ("mod", "%", -1),
        ("and_", "and", -4), ("or_", "or", -4),
        ("lt", "<", -3), ("gt", ">", -3),
        ("le", "<=", -3), ("ge", ">=", -3),
        ("eq", "==", -3), ("neq", "!=", -3),
    ]:
        p.assign(_scalar_name_is(nm), OperatorPrinter(op_str, prec))
    p.assign(_scalar_name_is("neg"), OperatorPrinter("-", 0))
    p.assign(_scalar_name_is("pow"), PatternPrinter("{0} ** {1}", (1, 1)))
    p.assign(_scalar_name_is("sqr"), PatternPrinter("{0} ** 2", (1,)))
    # common functions
    for fname in ("exp", "log", "log1p", "sqrt", "sigmoid", "tanh", "sin",
                  "cos", "tan", "abs", "erf", "erfc", "softplus", "floor",
                  "ceil", "switch", "isnan", "isinf"):
        p.assign(_scalar_name_is(fname), FunctionPrinter(fname))
    p.assign(_op_class_named("Dot", "Dot22", "BatchedDot"),
             OperatorPrinter("@", 1))
    p.assign(_op_class_named("Sum"), FunctionPrinter("sum"))
    p.assign(_op_class_named("CAReduce"), FunctionPrinter("reduce"))
    p.assign(lambda var: (var.owner is not None
                          and type(var.owner.op).__name__ == "CAReduce"
                          and str(var.owner.op) == "Sum"),
             FunctionPrinter("sum"))
    p.assign(lambda var: (var.owner is not None
                          and type(var.owner.op).__name__ == "CAReduce"
                          and "Max" in str(var.owner.op)),
             FunctionPrinter("max"))
    p.assign(_op_class_named("DeepCopyOp", "ViewOp", "SpecifyShape"),
             IgnorePrinter())

    class _SubtensorPrinter(Printer):
        def process(self, var, pstate):
            if var in pstate.memo:
                return pstate.memo[var]
            node = var.owner
            from pytensor_tpu_torch.tensor.subtensor import DYN

            with set_precedence(pstate):
                base = pstate.pprinter.process(node.inputs[0], pstate)
                dyn = iter(node.inputs[1:])

                def fmt(e):
                    if e == DYN:
                        return pstate.pprinter.process(next(dyn), pstate)
                    if isinstance(e, tuple) and e and e[0] == "slice":
                        _, a, b, c = e
                        sa = "" if a is None else fmt(a)
                        sb = "" if b is None else fmt(b)
                        s = f"{sa}:{sb}"
                        if c is not None:
                            s += f":{fmt(c)}"
                        return s
                    return str(e)

                idx = ", ".join(fmt(e) for e in node.op.idx_list)
            r = f"{base}[{idx}]"
            pstate.memo[var] = r
            return r

    p.assign(_op_class_named("Subtensor"), _SubtensorPrinter())
    p.assign(_op_class_named("DimShuffle"), IgnorePrinter())
    return p


pprint = _build_default_pprinter()
pp = pprint

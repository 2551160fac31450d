"""DebugMode: every node checked against its oracle, with rewrite blame.

Counterpart of ``pytensor_tpu/compile/debug/debugmode.py`` (PyTensor's
compile/debug/debugmode.py:2166).  The JAX package runs each node's numpy
``perform`` (its oracle) and its XLA lowering, and raises
``BadThunkOutput`` where they disagree.  The port runs the ``"py"`` plan
on the function's device (``link/torch/linker.py Plan.hook``), and after
each node computes the node's oracle from the same inputs: the op's numpy
``perform`` on host copies where the op has one of its own, else the
node's lowering on the CPU, which for the kernels' nodes is their plain
version (a fused node, K1, is held against its plain version although
its ``OpFromGraph`` has a ``perform``).  On a card it so holds every K1 node of a
graph against its plain version, node by node; on the CPU it still
catches a lowering that disagrees with a ``perform``.  Outputs agree
under ``values_eq_approx`` (the JAX package's tolerances by dtype);
``DebugFunction.holds`` keeps each node's oracle and largest absolute
difference of the last call.

Rewrite blame (PyTensor's debugmode.py:694 ``_find_bad_optimizations``):
the mode's rewrites run with a ``FullHistory`` that keeps each change's
reason.  After a call the outputs are computed again from the graph
before its rewrites, on the CPU; where they differ, the history is
replayed change by change, each step evaluated on the CPU, and the first
change whose graph stops matching is named in ``BadOptimization``.
``StochasticOrder``: the rewrites run twice, on the graph and on a clone
of it, and must give the same graph.
"""

from __future__ import annotations

import numpy as np
import torch

from pytensor_tpu_torch.compile.inner_function import HasInnerFunction
from pytensor_tpu_torch.compile.mode import Mode
from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.graph.op import HasInnerGraph, Op
from pytensor_tpu_torch.graph.rewriting.basic import GraphRewriter
from pytensor_tpu_torch.link.basic import raise_with_op
from pytensor_tpu_torch.link.torch.convert import CSR, to_numpy
from pytensor_tpu_torch.tensor.fused import FusedElemwise
from pytensor_tpu_torch.tensor.type import TensorType


class BadThunkOutput(Exception):
    """A node's lowering and its oracle disagree on an output."""


class BadOptimization(Exception):
    """A graph rewrite changed the computed result."""


class StochasticOrder(Exception):
    """Rewriting the same graph twice gave different results: some rewrite
    iterates in a memory-address-dependent order (PyTensor's
    debugmode.py:287)."""


def values_eq_approx(a, b, rtol=None, atol=None) -> bool:
    """The JAX package's ``tensor/type.py values_eq_approx``: integers and
    bools equal, floats within ``rtol`` and ``atol`` (by default 1e-5 and
    1e-8 up to 4 bytes an element, 1e-8 and 1e-10 above), NaN equal to
    NaN."""
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or str(a.dtype) != str(b.dtype):
        return False
    if a.dtype.kind in "biu":
        return bool(np.array_equal(a, b))
    if rtol is None:
        rtol = 1e-5 if a.dtype.itemsize <= 4 else 1e-8
    if atol is None:
        atol = 1e-8 if a.dtype.itemsize <= 4 else 1e-10
    if a.dtype.kind != "c":
        a, b = a.astype("float64"), b.astype("float64")
    return bool(np.all(np.isclose(a, b, rtol=rtol, atol=atol, equal_nan=True)))


def _host(value):
    """A value of a plan moved to the CPU (tensors, sparse triples, typed
    lists); anything else as it is."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    if isinstance(value, CSR):
        return CSR(*(_host(t) for t in (value.indptr, value.indices, value.data)), value.shape)
    if isinstance(value, list):
        return [_host(v) for v in value]
    return value


def _numpy(value):
    if isinstance(value, torch.Tensor):
        return to_numpy(value)
    if isinstance(value, list):
        return [_numpy(v) for v in value]
    if isinstance(value, CSR):
        raise NotImplementedError("a sparse value has no numpy perform here")
    return value


def _has_perform(op) -> bool:
    """Whether ``op``'s oracle is its numpy ``perform``: not where it has
    none of its own, nor for an inner-function op (whose ``perform`` runs
    the port's lowerings on the CPU), nor for a fused node, which is held
    against K1's plain version."""
    return (type(op).perform is not Op.perform
            and not isinstance(op, (HasInnerFunction, FusedElemwise)))


def _eval_fgraph(fgraph, in_vals):
    """The graph's outputs on the CPU, each node's lowering in turn."""
    from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch

    return [_host(v) for v in fgraph_to_torch(fgraph, "cpu", trust_input=True)(*in_vals)]


def _outputs_match(fgraph, a_vals, b_vals, rtol, atol):
    for o, a, b in zip(fgraph.outputs, a_vals, b_vals):
        if not isinstance(o.type, TensorType):
            continue
        if a is None or b is None:
            return a is b
        if not values_eq_approx(_numpy(a), _numpy(b), rtol=rtol, atol=atol):
            return False
    return True


def _canon_signature(fgraph) -> str:
    """Structural graph signature, independent of object identity:
    recurses into inner-graph ops (whose ``__eq__`` is identity, so
    ``equal_computations`` cannot compare across independent rewrites)."""
    in_pos = {v: i for i, v in enumerate(fgraph.inputs)}
    memo = {}

    def sig(v):
        if v in memo:
            return memo[v]
        if v in in_pos:
            s = f"in{in_pos[v]}"
        elif isinstance(v, Constant):
            data = v.data
            try:
                body = np.asarray(data).tobytes().hex()[:32]
            except Exception:
                body = repr(data)
            s = f"const[{v.type}]{body}"
        elif v.owner is None:
            s = f"free[{v.type}]"
        else:
            node = v.owner
            op = node.op
            if isinstance(op, HasInnerGraph):
                op_s = f"{type(op).__name__}<{_canon_signature(op.fgraph)}>"
            else:
                op_s = str(op)
            args = ",".join(sig(i) for i in node.inputs)
            s = f"{op_s}({args})#{node.outputs.index(v)}"
        memo[v] = s
        return s

    return ";".join(sig(o) for o in fgraph.outputs)


class _RecordingRewriter(GraphRewriter):
    """Run the mode's pipeline with a reason-recording ``FullHistory``
    attached, and leave the history on the graph for the blame.  Also
    rewrite a clone of the graph as it was and compare: a graph that
    differs means the pipeline is nondeterministic."""

    def __init__(self, inner, check_stochastic_order=True):
        self.inner = inner
        self.check_stochastic_order = check_stochastic_order

    def apply(self, fgraph):
        from pytensor_tpu_torch.graph.features import AlreadyThere, FullHistory

        twin = fgraph.clone(check_integrity=False) if self.check_stochastic_order else None
        hist = FullHistory()
        try:
            fgraph.attach_feature(hist)
        except AlreadyThere:
            hist = None
        res = self.inner.apply(fgraph)
        if hist is not None:
            fgraph._debug_full_history = hist
        if twin is not None:
            self.inner.apply(twin)
            if _canon_signature(fgraph) != _canon_signature(twin):
                raise StochasticOrder(
                    "rewriting the same graph twice produced different results; a rewrite "
                    "likely iterates in id()-order")
        return res

    def add_requirements(self, fgraph):
        add = getattr(self.inner, "add_requirements", None)
        if add is not None:
            add(fgraph)


class _DualRun:
    """The ``Plan.hook`` that holds each node's outputs against its oracle."""

    def __init__(self, fn):
        self.fn = fn
        self.cpu_lowerings: dict = {}

    def before(self, node, inputs):
        return None

    def oracle(self, node, inputs):
        """The node's outputs by its oracle, and which oracle it was."""
        if _has_perform(node.op):
            try:
                storage = [[None] for _ in node.outputs]
                node.op.perform(node, [_numpy(v) for v in inputs], storage)
                return [s[0] for s in storage], "perform"
            except NotImplementedError:
                pass
        from pytensor_tpu_torch.link.torch.dispatch import torch_funcify

        fn = self.cpu_lowerings.get(node)
        if fn is None:
            fn = self.cpu_lowerings[node] = torch_funcify(node.op, node=node, device=torch.device(
                "cpu"), host=frozenset())
        from pytensor_tpu_torch.link.torch.linker import node_outputs

        return node_outputs(node, fn(*[_host(v) for v in inputs])), "the CPU lowering"

    def after(self, node, mark, inputs, outputs):
        fn = self.fn
        if not any(isinstance(o.type, TensorType) for o in node.outputs):
            return
        try:
            want, how = self.oracle(node, inputs)
        except Exception:
            raise_with_op(fn.plan.fgraph, node)
        worst = 0.0
        for o, got, w in zip(node.outputs, outputs, want):
            if not isinstance(o.type, TensorType):
                continue
            g = _numpy(got) if isinstance(got, torch.Tensor) else np.asarray(got)
            w = _numpy(w) if isinstance(w, torch.Tensor) else np.asarray(w)
            dt = g.dtype
            if not values_eq_approx(w.astype(dt), g, rtol=fn.rtol, atol=fn.atol):
                raise BadThunkOutput(
                    f"DebugMode: the oracle ({how}) and the lowering disagree on {node} "
                    f"output {o}:\n oracle={w}\n lowering={g}")
            if fn.check_isfinite and dt.kind in "fc" and not np.all(np.isfinite(w)):
                raise BadThunkOutput(f"DebugMode: non-finite output of {node}")
            if g.size and dt.kind in "fc":
                diff = np.abs(w.astype(dt).astype("complex128" if dt.kind == "c" else "float64")
                              - g.astype("complex128" if dt.kind == "c" else "float64"))
                worst = max(worst, float(np.nanmax(diff, initial=0.0)))
        fn.holds.append((node, how, worst))


class DebugFunction:
    """``DebugLinker``'s callable: the plan run with each node held
    against its oracle, then the outputs against the graph before its
    rewrites.  ``holds`` keeps ``(node, oracle, largest absolute
    difference)`` for each node of the last call."""

    def __init__(self, plan, check_isfinite, rtol, atol):
        self.plan = plan
        self.check_isfinite = check_isfinite
        self.rtol = rtol
        self.atol = atol
        self.holds: list = []
        plan.hook = _DualRun(self)

    def __call__(self, *args):
        plan = self.plan
        if len(args) != len(plan.inputs):
            raise TypeError(f"expected {len(plan.inputs)} inputs, got {len(args)}")
        if not plan.trust_input:
            args = plan.convert(args)
        self.holds = []
        outputs = plan.execute(args)
        plan.raise_failed()
        reason = self.find_bad_rewrite([_host(a) for a in args], [_host(o) for o in outputs])
        if reason is not None:
            raise BadOptimization(
                f"DebugMode: a rewrite changed the computed outputs; the first diverging "
                f"change was made by: {reason}")
        return outputs

    def find_bad_rewrite(self, in_vals, opt_outs):
        """Replay the rewrite history; the reason of the first change that
        makes the outputs differ from the graph before its rewrites, or
        None where they agree (PyTensor's debugmode.py:694)."""
        fgraph = self.plan.fgraph
        hist = getattr(fgraph, "_debug_full_history", None)
        if hist is None or not hist.fw:
            return None
        rtol, atol = self.rtol, self.atol
        try:
            hist.start()
            ref_outs = _eval_fgraph(fgraph, in_vals)
            if _outputs_match(fgraph, ref_outs, opt_outs, rtol, atol):
                return None
            # the first change whose graph stops matching the graph before
            # the rewrites is the culprit
            while hist.pointer < len(hist.fw) - 1:
                hist.next()
                try:
                    step_outs = _eval_fgraph(fgraph, in_vals)
                except Exception:
                    continue  # a graph between two changes of one rewrite
                if not _outputs_match(fgraph, ref_outs, step_outs, rtol, atol):
                    return str(hist.reasons[hist.pointer])
            return "<unidentified rewrite>"
        finally:
            hist.end()


class DebugLinker:
    """The ``"py"`` plan on the function's device with every node held
    against its oracle (``DebugFunction``)."""

    required_rewrites = ("torch",)

    def __init__(self, check_isfinite=False, rtol=None, atol=None):
        self.check_isfinite = check_isfinite
        self.rtol = rtol
        self.atol = atol

    def make_torch_fn(self, fgraph, device, trust_input=False):
        from pytensor_tpu_torch.link.torch.linker import fgraph_to_torch

        return DebugFunction(fgraph_to_torch(fgraph, device, trust_input), self.check_isfinite,
                             self.rtol, self.atol)


class DebugMode(Mode):
    def __init__(self, optimizer="fast_run", check_isfinite=False, db=None):
        super().__init__(DebugLinker(check_isfinite=check_isfinite), optimizer, db)

    @property
    def optimizer(self):
        return _RecordingRewriter(Mode.optimizer.fget(self))

    def including(self, *tags):
        m = DebugMode(self._optimizer.including(*tags), db=self.db)
        m.linker = self.linker
        return m

    def excluding(self, *tags):
        m = DebugMode(self._optimizer.excluding(*tags), db=self.db)
        m.linker = self.linker
        return m

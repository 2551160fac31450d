"""Lazy conditional: IfElse.

Counterpart of ``pytensor_tpu/ifelse.py`` (PyTensor's ifelse.py
IfElse:42), with its three rewrites at their databases and positions.
The JAX package lowers ``IfElse`` to ``lax.cond``, so that only the taken
branch runs.  The port's plan (``link/torch/linker.py Plan``) runs a
graph that holds an ``IfElse`` demand-driven, as the JAX package's oracle
linker does (``pytensor_tpu/link/basic.py:160-250``): only the
condition's producers are the node's unconditional dependencies, and the
condition, read on the host when the node is reached, adds the taken
branch's producers, so the other branch launches nothing.  The lowering
(``link/torch/dispatch.py``) declares that read (``reads_back``), so a
plan holding an ``IfElse`` runs eagerly; one whose rewrites leave none
(a constant condition, identical branches) captures as before.
"""

from __future__ import annotations

from pytensor_tpu_torch.graph.basic import Apply
from pytensor_tpu_torch.graph.null_type import DisconnectedType
from pytensor_tpu_torch.graph.op import Op
from pytensor_tpu_torch.tensor.basic import as_tensor_variable, cast, zeros_like
from pytensor_tpu_torch.tensor.type import TensorType


class IfElse(Op):
    """ifelse(cond, *then_branch, *else_branch) -> branch outputs."""

    __props__ = ("n_outs",)

    def __init__(self, n_outs: int, as_view=False, name=None):
        self.n_outs = int(n_outs)
        self.name = name

    def make_node(self, condition, *true_false):
        if len(true_false) != 2 * self.n_outs:
            raise ValueError(f"IfElse expected {2 * self.n_outs} branch values")
        condition = as_tensor_variable(condition)
        if condition.type.ndim != 0:
            raise TypeError("ifelse condition must be a scalar")
        ts = [as_tensor_variable(t) for t in true_false[: self.n_outs]]
        fs = [as_tensor_variable(f) for f in true_false[self.n_outs:]]
        outs = []
        for k, (t, f) in enumerate(zip(ts, fs)):
            if t.type.dtype != f.type.dtype:
                from pytensor_tpu_torch.scalar.basic import upcast

                # the node takes the cast branches (the JAX package's make_node
                # keeps the uncast ones, so its oracle returns the narrower
                # dtype under the wider type, and its lax.cond refuses them)
                dt = upcast(t.type.dtype, f.type.dtype)
                t = ts[k] = cast(t, dt) if t.type.dtype != dt else t
                f = fs[k] = cast(f, dt) if f.type.dtype != dt else f
            if t.type.ndim != f.type.ndim:
                raise TypeError(
                    f"ifelse branches must have the same rank: {t.type} vs {f.type}"
                )
            shape = tuple(
                ts_ if ts_ is not None and ts_ == fs_ else None
                for ts_, fs_ in zip(t.type.shape, f.type.shape)
            )
            outs.append(TensorType(t.type.dtype, shape)())
        node_inputs = [condition]
        node_inputs.extend(ts)
        node_inputs.extend(fs)
        return Apply(self, node_inputs, outs)

    def perform(self, node, inputs, output_storage):
        cond, *rest = inputs
        branch = rest[: self.n_outs] if cond else rest[self.n_outs:]
        for s, v in zip(output_storage, branch):
            s[0] = v

    def infer_shape(self, fgraph, node, input_shapes):
        # shapes may differ between branches; pick the true branch's
        return input_shapes[1: 1 + self.n_outs]

    def connection_pattern(self, node):
        pat = [[False] * self.n_outs]
        for _ in range(2 * self.n_outs):
            pat.append([True] * self.n_outs)
        return pat

    def L_op(self, inputs, outputs, output_grads):
        cond = inputs[0]
        ts = inputs[1: 1 + self.n_outs]
        fs = inputs[1 + self.n_outs:]
        grads = [DisconnectedType()()]
        zeros_t = [zeros_like(t) for t in ts]
        zeros_f = [zeros_like(f) for f in fs]
        op = IfElse(self.n_outs)
        # grad wrt true inputs: gz if cond else 0 (and symmetrical)
        gts = op(cond, *output_grads, *zeros_t)
        if not isinstance(gts, list):
            gts = [gts]
        gfs = op(cond, *zeros_f, *output_grads)
        if not isinstance(gfs, list):
            gfs = [gfs]
        for g, t in zip(gts, ts):
            grads.append(cast(g, t.type.dtype) if g.type.dtype != t.type.dtype else g)
        for g, f in zip(gfs, fs):
            grads.append(cast(g, f.type.dtype) if g.type.dtype != f.type.dtype else g)
        return grads

    def __str__(self):
        return f"if{{{self.name or self.n_outs}}}"


def ifelse(condition, then_branch, else_branch, name=None):
    one = not isinstance(then_branch, (list, tuple))
    ts = [then_branch] if one else list(then_branch)
    fs = [else_branch] if one else list(else_branch)
    if len(ts) != len(fs):
        raise ValueError("ifelse branches must have the same arity")
    op = IfElse(len(ts), name=name)
    res = op(condition, *ts, *fs)
    if isinstance(res, list) and one:
        return res[0]
    return res




def _register_rewrites():
    """IfElse graph rewrites (reference ifelse.py:424-691): merge
    conditionals on the same predicate into one node (one read of the
    condition, one branch a call) and drop conditionals with a constant
    predicate."""
    from pytensor_tpu_torch.compile.mode import register_canonicalize, register_specialize
    from pytensor_tpu_torch.graph.basic import Constant
    from pytensor_tpu_torch.graph.rewriting.basic import copy_stack_trace, node_rewriter

    @node_rewriter([IfElse])
    def local_useless_ifelse(fgraph, node):
        """ifelse(const, t, f) -> taken branch; ifelse(c, x, x) -> x."""
        cond = node.inputs[0]
        ts = node.inputs[1: 1 + node.op.n_outs]
        fs = node.inputs[1 + node.op.n_outs:]
        if isinstance(cond, Constant):
            branch = ts if bool(cond.data) else fs
            res = []
            for b, out in zip(branch, node.outputs):
                if b.type.dtype != out.type.dtype:
                    b = cast(b, out.type.dtype)
                if not out.type.is_super(b.type):
                    from pytensor_tpu_torch.tensor.shape import specify_shape

                    b = specify_shape(b, out.type.shape)
                copy_stack_trace(out, b)
                res.append(b)
            return res
        if all(t is f for t, f in zip(ts, fs)):
            return list(ts)
        return False

    register_canonicalize(local_useless_ifelse, name="local_useless_ifelse")

    @node_rewriter([IfElse])
    def local_ifelse_merge(fgraph, node):
        """Merge independent IfElse nodes on the same condition into one
        multi-output conditional (reference cond_merge): one read of the
        condition and one branch instead of several."""
        from pytensor_tpu_torch.graph.traversal import ancestors

        cond = node.inputs[0]
        n = node.op.n_outs
        # find another IfElse on the same condition, independent of node
        other = None
        for client_node, _ in fgraph.clients.get(cond, ()):
            if client_node == "output" or client_node is node:
                continue
            if isinstance(client_node.op, IfElse) \
                    and client_node.inputs[0] is cond \
                    and client_node in fgraph.apply_nodes:
                other = client_node
                break
        if other is None:
            return False
        node_out_ids = {id(o) for o in node.outputs}
        other_out_ids = {id(o) for o in other.outputs}
        if any(id(a) in other_out_ids for a in ancestors(node.inputs)):
            return False
        if any(id(a) in node_out_ids for a in ancestors(other.inputs)):
            return False
        m = other.op.n_outs
        ts = list(node.inputs[1: 1 + n])
        fs = list(node.inputs[1 + n:])
        o_ts = list(other.inputs[1: 1 + m])
        o_fs = list(other.inputs[1 + m:])
        merged = IfElse(n + m, name=node.op.name)(
            cond, *ts, *o_ts, *fs, *o_fs)
        if not isinstance(merged, list):
            merged = [merged]
        repl = {}
        for old, new in zip(list(node.outputs) + list(other.outputs), merged):
            if not old.type.is_super(new.type):
                return False
            repl[old] = new
        for old, new in repl.items():
            copy_stack_trace(old, new)
        return repl

    register_specialize(local_ifelse_merge, name="local_ifelse_merge")

    def acceptable_ops():
        """Op classes safe to sink into IfElse branches (reference
        ifelse.py acceptable_ops; lazily resolved to avoid import
        cycles)."""
        from pytensor_tpu_torch.tensor.basic import Alloc
        from pytensor_tpu_torch.tensor.elemwise import CAReduce, DimShuffle, Elemwise
        from pytensor_tpu_torch.tensor.math import Dot
        from pytensor_tpu_torch.tensor.shape import Reshape, Shape, SpecifyShape
        from pytensor_tpu_torch.tensor.subtensor import Subtensor

        return (Alloc, CAReduce, DimShuffle, Dot, Elemwise, Reshape,
                Shape, SpecifyShape, Subtensor)

    @node_rewriter(None)
    def ifelse_lift_single_if_through_acceptable_ops(fgraph, node):
        """O(ifelse(c, t, f)) -> ifelse(c, O(t), O(f)) when this node is
        the ONLY client of the conditional outputs it consumes (reference
        ifelse.py:424): in the lazy plan the sunk op runs only in the
        taken branch instead of unconditionally after it."""
        from pytensor_tpu_torch.graph.traversal import ancestors

        if isinstance(node.op, IfElse) or not isinstance(
                node.op, acceptable_ops()):
            return False
        ife_nodes = {i.owner for i in node.inputs
                     if i.owner is not None and isinstance(i.owner.op, IfElse)}
        if len(ife_nodes) != 1:
            return False
        ife = ife_nodes.pop()
        for i in set(node.inputs):
            if i.owner is ife:
                if any(c is not node
                       for c, _ in fgraph.clients.get(i, ()) if c != "output"):
                    return False
                if any(c == "output" for c, _ in fgraph.clients.get(i, ())):
                    return False
        cond = ife.inputs[0]
        n = ife.op.n_outs
        ts = ife.inputs[1: 1 + n]
        fs = ife.inputs[1 + n:]
        other_in = [i for i in node.inputs if i.owner is not ife]
        ife_out_ids = {id(o) for o in ife.outputs}
        if any(id(a) in ife_out_ids for a in ancestors(other_in)):
            return False

        def branch_inputs(branch):
            return [branch[ife.outputs.index(i)] if i.owner is ife else i
                    for i in node.inputs]

        t_out = node.op.make_node(*branch_inputs(ts)).outputs
        f_out = node.op.make_node(*branch_inputs(fs)).outputs
        new = IfElse(len(node.outputs), name=ife.op.name)(
            cond, *t_out, *f_out)
        if not isinstance(new, list):
            new = [new]
        for old, nw in zip(node.outputs, new):
            if not old.type.is_super(nw.type):
                return False
        for old, nw in zip(node.outputs, new):
            copy_stack_trace(old, nw)
        return list(new)

    register_specialize(ifelse_lift_single_if_through_acceptable_ops,
                        name="ifelse_lift_single_if_through_acceptable_ops")

    # reference-name surface (ifelse.py:424-691): the two local rewrites
    # above jointly cover cond_remove_identical + cond_merge_ifs_*;
    # exported under both naming schemes for downstream tooling
    return {
        "local_useless_ifelse": local_useless_ifelse,
        "local_ifelse_merge": local_ifelse_merge,
        "ifelse_lift_single_if_through_acceptable_ops":
            ifelse_lift_single_if_through_acceptable_ops,
    }


_rewrites = _register_rewrites()
local_useless_ifelse = _rewrites["local_useless_ifelse"]
local_ifelse_merge = _rewrites["local_ifelse_merge"]
ifelse_lift_single_if_through_acceptable_ops = _rewrites[
    "ifelse_lift_single_if_through_acceptable_ops"]
cond_remove_identical = local_useless_ifelse
cond_merge_ifs_true = local_ifelse_merge
cond_merge_ifs_false = local_ifelse_merge
CondMerge = local_ifelse_merge


def apply_depends_on(apply, depends_on):
    """True when ``apply`` transitively depends on apply node(s)
    ``depends_on`` (reference ifelse.py:312)."""
    from pytensor_tpu_torch.graph.traversal import ancestors

    if not isinstance(depends_on, (list, tuple, set)):
        depends_on = [depends_on]
    targets = {id(a) for a in depends_on}
    return any(id(v.owner) in targets
               for v in ancestors(apply.inputs) if v.owner is not None)

"""Scan rewrites.

Counterpart of ``pytensor_tpu/scan/rewriting.py``, ported whole, each
rewrite at the JAX package's position and registered in its order (the
database sorts by position and keeps the order of registration between
equal positions): ``scan_remove_unused_outputs`` (1.605),
``scan_sit_sot_to_untraced`` (1.62), ``scan_truncate_trace_window``
(1.625), ``ScanMerge`` (1.63), ``scan_push_out_non_seqs`` (1.601),
``scan_push_out_seqs`` (1.602, batched over time by ``vectorize_graph``),
``scan_push_out_non_recurrent_outputs`` (1.603), ``scan_push_out_add``
(1.602) and ``scan_reduce_nsteps`` (1.611).  Each refuses a while-scan,
as the JAX package's does: pushing a nit-sot or a reduction out of one,
or cutting its trace, would change what its executed prefix holds.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np

from pytensor_tpu_torch.compile.mode import optdb
from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.graph.replace import clone_replace, vectorize_graph
from pytensor_tpu_torch.graph.rewriting.basic import (
    GraphRewriter,
    WalkingGraphRewriter,
    node_rewriter,
)
from pytensor_tpu_torch.graph.traversal import ancestors
from pytensor_tpu_torch.scan.op import Scan, ScanInfo
from pytensor_tpu_torch.tensor.basic import NotScalarConstantError, get_scalar_constant_value


def _rebuilt(op, info, inner_inputs, inner_outputs):
    return op.rebuilt(FunctionGraph(inner_inputs, inner_outputs, clone=True), info)


def _static_n_steps(node):
    try:
        return int(get_scalar_constant_value(node.inputs[0]))
    except NotScalarConstantError:
        return None


@node_rewriter([Scan])
def scan_remove_unused_outputs(fgraph, node):
    """Rebuild a Scan without the nit-sot outputs that have no clients."""
    op = node.op
    info = op.info
    if info.as_while:
        return False
    if info.n_nit_sot == 0:
        return False
    nit_start = info.n_states + info.n_untraced
    keep = [k for k in range(info.n_nit_sot) if fgraph.clients.get(node.outputs[nit_start + k])]
    if len(keep) == info.n_nit_sot:
        return False
    new_op = _rebuilt(
        op, ScanInfo(info.n_seqs, info.taps, len(keep), info.n_non_seqs,
                     n_untraced=info.n_untraced),
        list(op.fgraph.inputs),
        list(op.inner_state_outs()) + list(op.inner_untraced_outs())
        + [op.inner_nit_sot_outs()[k] for k in keep])
    new_outs = new_op(*node.inputs, return_list=True)
    repl = list(zip(node.outputs[:nit_start], new_outs[:nit_start]))
    repl += [(node.outputs[nit_start + k], new_outs[nit_start + j]) for j, k in enumerate(keep)]
    return dict(repl)


optdb.register("scan_remove_unused_outputs", WalkingGraphRewriter(scan_remove_unused_outputs),
               "fast_run", "scan", position=1.605)


def _last_index_clients_only(fgraph, node, out):
    """True iff every client of ``out`` is trace[-1] (or trace[n-1] when
    n_steps is a constant)."""
    from pytensor_tpu_torch.tensor.subtensor import Subtensor

    clients = fgraph.clients.get(out, ())
    if not clients:
        return False
    n_steps = _static_n_steps(node)
    for c, _ in clients:
        if c == "output" or not isinstance(c.op, Subtensor):
            return False
        il = c.op.idx_list
        if len(il) != 1 or not isinstance(il[0], (int, np.integer)):
            return False
        e = int(il[0])
        if e != -1 and not (n_steps is not None and e == n_steps - 1):
            return False
    return True


@node_rewriter([Scan])
def scan_sit_sot_to_untraced(fgraph, node):
    """Turn sit-sot states whose trace is only read at [-1] into untraced
    states: the loop carries one value instead of stacking an
    (n_steps, ...) trace."""
    op = node.op
    info = op.info
    if info.as_while:
        return False
    convert = [k for k, taps in enumerate(info.taps)
               if taps == (-1,) and _last_index_clients_only(fgraph, node, node.outputs[k])]
    if not convert:
        return False
    keep = [k for k in range(info.n_states) if k not in convert]
    tap_groups = op.inner_tap_vars()
    state_outs = op.inner_state_outs()
    new_op = _rebuilt(
        op,
        ScanInfo(info.n_seqs, tuple(info.taps[k] for k in keep), info.n_nit_sot,
                 info.n_non_seqs, n_untraced=info.n_untraced + len(convert)),
        list(op.inner_seq_vars()) + [v for k in keep for v in tap_groups[k]]
        + [tap_groups[k][0] for k in convert] + list(op.inner_untraced_vars())
        + list(op.inner_non_seq_vars()),
        [state_outs[k] for k in keep] + [state_outs[k] for k in convert]
        + list(op.inner_untraced_outs()) + list(op.inner_nit_sot_outs()))
    inits = op.outer_inits(node.inputs)
    new_outs = new_op(
        node.inputs[0], *op.outer_seqs(node.inputs), *[inits[k] for k in keep],
        *[inits[k] for k in convert], *op.outer_untraced_inits(node.inputs),
        *op.outer_non_seqs(node.inputs), return_list=True)
    # kept traces, then converted finals, old untraced finals, nit-sots
    repl = [(node.outputs[k], new_outs[j]) for j, k in enumerate(keep)]
    for j, k in enumerate(convert):
        final = new_outs[len(keep) + j]
        # every trace[-1] client takes the final value
        repl += [(c.outputs[0], final) for c, _ in fgraph.clients.get(node.outputs[k], ())]
    base = len(keep) + len(convert)
    rest = info.n_untraced + info.n_nit_sot
    repl += list(zip(node.outputs[info.n_states: info.n_states + rest],
                     new_outs[base: base + rest]))
    return dict(repl)


optdb.register("scan_sit_sot_to_untraced", WalkingGraphRewriter(scan_sit_sot_to_untraced),
               "fast_run", "scan", "scan_save_mem", position=1.62)


def _tail_of(e, n_steps):
    """How many of the last rows a constant index or slice start reads
    (trace[-j] and trace[-j:], or trace[n-j] and trace[n-j:])."""
    return -int(e) if int(e) < 0 else n_steps - int(e)


@node_rewriter([Scan])
def scan_truncate_trace_window(fgraph, node):
    """Truncate a sit-sot trace read only through its last w rows
    (``trace[-w:]``, ``trace[-j]``) to a rolling (w, ...) untraced carry.
    Needs a constant n_steps >= w, so that the window is full."""
    from pytensor_tpu_torch.tensor import basic as tb
    from pytensor_tpu_torch.tensor.subtensor import Subtensor
    from pytensor_tpu_torch.tensor.type import TensorType

    op = node.op
    info = op.info
    if info.as_while:
        return False
    n_steps = _static_n_steps(node)
    if n_steps is None:
        return False

    def window_need(out):
        """The longest tail the clients read, or None if one reads more
        than a constant tail."""
        clients = fgraph.clients.get(out, ())
        if not clients:
            return None
        w = 0
        for c, _ in clients:
            if c == "output" or not isinstance(c.op, Subtensor):
                return None
            il = c.op.idx_list
            if len(il) != 1:
                return None
            e = il[0]
            if isinstance(e, (int, np.integer)):
                j = _tail_of(e, n_steps)
            elif isinstance(e, tuple) and e[0] == "slice":
                a, b, s = e[1], e[2], e[3]
                if not isinstance(a, (int, np.integer)):
                    return None
                if b is not None or (s is not None and s != 1):
                    return None
                j = _tail_of(a, n_steps)
            else:
                return None
            if j <= 0:
                return None
            w = max(w, j)
        # w == 1 is scan_sit_sot_to_untraced's cheaper form
        return w if 2 <= w <= n_steps else None

    convert = {k: w for k, taps in enumerate(info.taps) if taps == (-1,)
               for w in [window_need(node.outputs[k])] if w is not None}
    if not convert:
        return False

    keep = [k for k in range(info.n_states) if k not in convert]
    tap_groups = op.inner_tap_vars()
    # fresh (w, ...) window inputs; the old h_prev tap becomes win[-1]
    win_vars, tap_repl = {}, {}
    for k, w in convert.items():
        tap_var = tap_groups[k][0]
        win_vars[k] = TensorType(tap_var.type.dtype, (w,) + tuple(tap_var.type.shape))(f"win_{k}")
        tap_repl[tap_var] = win_vars[k][-1]
    replaced = clone_replace(list(op.inner_state_outs()) + list(op.inner_untraced_outs())
                             + list(op.inner_nit_sot_outs()), replace=tap_repl)
    r_states = replaced[: info.n_states]
    r_rest = replaced[info.n_states:]
    # the window's output: shifted left, the new state appended
    win_outs = {k: tb.join(0, win_vars[k][1:], tb.shape_padleft(r_states[k])) for k in convert}
    new_op = _rebuilt(
        op,
        ScanInfo(info.n_seqs, tuple(info.taps[k] for k in keep), info.n_nit_sot,
                 info.n_non_seqs, n_untraced=info.n_untraced + len(convert)),
        list(op.inner_seq_vars()) + [v for k in keep for v in tap_groups[k]]
        + [win_vars[k] for k in convert] + list(op.inner_untraced_vars())
        + list(op.inner_non_seq_vars()),
        [r_states[k] for k in keep] + [win_outs[k] for k in convert] + list(r_rest))

    inits = op.outer_inits(node.inputs)
    # the initial rows are shifted out before the final window is read
    win_inits = [tb.alloc(tb.shape_padleft(inits[k]), w,
                          *[inits[k].shape[i] for i in range(inits[k].type.ndim)])
                 for k, w in convert.items()]
    new_outs = new_op(node.inputs[0], *op.outer_seqs(node.inputs), *[inits[k] for k in keep],
                      *win_inits, *op.outer_untraced_inits(node.inputs),
                      *op.outer_non_seqs(node.inputs), return_list=True)
    repl = [(node.outputs[k], new_outs[j]) for j, k in enumerate(keep)]
    for j, (k, w) in enumerate(convert.items()):
        final_win = new_outs[len(keep) + j]
        for c, _ in fgraph.clients.get(node.outputs[k], ()):
            e = c.op.idx_list[0]
            if isinstance(e, (int, np.integer)):
                repl.append((c.outputs[0], final_win[w - _tail_of(e, n_steps)]))
            else:
                t = _tail_of(e[1], n_steps)
                repl.append((c.outputs[0], final_win if t == w else final_win[w - t:]))
    base = len(keep) + len(convert)
    rest = info.n_untraced + info.n_nit_sot
    repl += list(zip(node.outputs[info.n_states: info.n_states + rest],
                     new_outs[base: base + rest]))
    return dict(repl)


optdb.register("scan_truncate_trace_window", WalkingGraphRewriter(scan_truncate_trace_window),
               "fast_run", "scan", "scan_save_mem", position=1.625)


class ScanMerge(GraphRewriter):
    """Merge independent Scans of the same n_steps variable into one
    loop."""

    name = "scan_merge"

    def apply(self, fgraph):
        merged = 0
        groups = defaultdict(list)
        for node in fgraph.toposort():
            if (isinstance(node.op, Scan) and node.op.truncate_gradient == -1
                    and not node.op.info.as_while):
                groups[id(node.inputs[0])].append(node)
        for nodes in groups.values():
            if len(nodes) < 2:
                continue
            # independent: no node's input depends on another's output
            outs = {id(o): n for n in nodes for o in n.outputs}
            ok = []
            for n in nodes:
                deps = {id(a) for a in ancestors(n.inputs)}
                if not any(oid in deps for oid in outs if outs[oid] is not n):
                    ok.append(n)
            if len(ok) < 2:
                continue
            try:
                self._merge(fgraph, ok)
                merged += 1
            except Exception:
                continue
        return merged

    def _merge(self, fgraph, nodes):
        # nodes may share one Scan instance: listing its inner variables
        # twice would collapse two input slots into one
        seen = set()
        ops = []
        for n in nodes:
            op = n.op.clone_fresh() if id(n.op) in seen else n.op
            seen.add(id(n.op))
            ops.append(op)
        infos = [op.info for op in ops]
        new_info = ScanInfo(
            n_seqs=sum(i.n_seqs for i in infos),
            taps=tuple(t for i in infos for t in i.taps),
            n_nit_sot=sum(i.n_nit_sot for i in infos),
            n_non_seqs=sum(i.n_non_seqs for i in infos),
            n_untraced=sum(i.n_untraced for i in infos))
        inner_inputs = ([v for op in ops for v in op.inner_seq_vars()]
                        + [v for op in ops for g in op.inner_tap_vars() for v in g]
                        + [v for op in ops for v in op.inner_untraced_vars()]
                        + [v for op in ops for v in op.inner_non_seq_vars()])
        inner_outputs = ([o for op in ops for o in op.inner_state_outs()]
                         + [o for op in ops for o in op.inner_untraced_outs()]
                         + [o for op in ops for o in op.inner_nit_sot_outs()])
        new_op = Scan(FunctionGraph(inner_inputs, inner_outputs, clone=True), new_info,
                      name="+".join(op.name or "scan" for op in ops),
                      unroll=max(op.unroll for op in ops))
        outer = ([v for n in nodes for v in n.op.outer_seqs(n.inputs)]
                 + [v for n in nodes for v in n.op.outer_inits(n.inputs)]
                 + [v for n in nodes for v in n.op.outer_untraced_inits(n.inputs)]
                 + [v for n in nodes for v in n.op.outer_non_seqs(n.inputs)])
        new_outs = iter(new_op(nodes[0].inputs[0], *outer, return_list=True))
        # the outputs go back section by section
        repl = []
        for n, i in zip(nodes, infos):
            repl += [(n.outputs[k], next(new_outs)) for k in range(i.n_states)]
        for n, i in zip(nodes, infos):
            repl += [(n.outputs[i.n_states + u], next(new_outs)) for u in range(i.n_untraced)]
        for n, i in zip(nodes, infos):
            repl += [(n.outputs[i.n_states + i.n_untraced + m], next(new_outs))
                     for m in range(i.n_nit_sot)]
        fgraph.replace_all_validate(repl, reason="scan_merge")


optdb.register("scan_merge", ScanMerge(), "fast_run", "scan", position=1.63)


@node_rewriter([Scan])
def scan_push_out_non_seqs(fgraph, node):
    """Hoist inner subgraphs that depend only on non-sequences and
    constants out of the loop: they become extra non-sequences, computed
    once in the outer graph."""
    op = node.op
    info = op.info
    if info.as_while:
        return False
    inner_non_seqs = set(op.inner_non_seq_vars())
    memo: dict = {}

    def invariant(v):
        if v not in memo:
            if v in inner_non_seqs or isinstance(v, Constant):
                memo[v] = True
            elif v.owner is None:
                memo[v] = False
            else:
                memo[v] = all(invariant(i) for i in v.owner.inputs)
        return memo[v]

    # maximal invariant values: some client is not invariant, or is an output
    candidates = []
    for inner_node in op.fgraph.toposort():
        for out in inner_node.outputs:
            if invariant(out) and any(
                    c == "output" or not all(invariant(o) for o in c.outputs)
                    for c, _ in op.fgraph.clients.get(out, ())):
                candidates.append(out)
    if not candidates:
        return False
    candidates = list(dict.fromkeys(candidates))
    mapping = dict(zip(op.inner_non_seq_vars(), op.outer_non_seqs(node.inputs)))
    outer_values = clone_replace(candidates, replace=mapping)
    fresh = [c.type() for c in candidates]
    new_inner_outputs = clone_replace(list(op.fgraph.outputs),
                                      replace=dict(zip(candidates, fresh)))
    used = set(map(id, ancestors(new_inner_outputs)))
    if not any(id(f) in used for f in fresh):
        return False
    new_op = _rebuilt(
        op, ScanInfo(info.n_seqs, info.taps, info.n_nit_sot, info.n_non_seqs + len(fresh),
                     n_untraced=info.n_untraced),
        list(op.fgraph.inputs) + fresh, new_inner_outputs)
    new_outs = new_op(*node.inputs, *outer_values, return_list=True)
    return dict(zip(node.outputs, new_outs))


optdb.register("scan_push_out_non_seqs", WalkingGraphRewriter(scan_push_out_non_seqs),
               "fast_run", "scan", position=1.601)


@node_rewriter([Scan])
def scan_push_out_seqs(fgraph, node):
    """Hoist inner computation that depends only on sequence slices and
    non-sequences out of the loop: it is computed once, vectorized over
    the time axis by ``vectorize_graph``, and comes back as a sequence."""
    op = node.op
    info = op.info
    if info.as_while:
        return False
    if info.n_seqs == 0:
        return False
    inner_seqs = list(op.inner_seq_vars())
    inner_non_seqs = list(op.inner_non_seq_vars())
    allowed = set(inner_seqs) | set(inner_non_seqs)
    seq_set = set(inner_seqs)
    cache: dict = {}

    def classify(v):
        """-> (eligible, touches a sequence)"""
        r = cache.get(id(v))
        if r is None:
            if v in allowed:
                r = (True, v in seq_set)
            elif isinstance(v, Constant):
                r = (True, False)
            elif v.owner is None:
                r = (False, False)
            else:
                subs = [classify(i) for i in v.owner.inputs]
                r = (all(e for e, _ in subs), any(s for _, s in subs))
            cache[id(v)] = r
        return r

    candidates = []
    for inner_node in op.fgraph.toposort():
        for out in inner_node.outputs:
            elig, has_seq = classify(out)
            # maximal: some consumer stays in the loop, or it is an output
            if elig and has_seq and any(
                    c == "output" or not all(classify(o)[0] for o in c.outputs)
                    for c, _ in op.fgraph.clients.get(out, ())):
                candidates.append(out)
    candidates = list(dict.fromkeys(candidates))
    if not candidates:
        return False

    outer_seqs = list(op.outer_seqs(node.inputs))
    outer_non_seqs = list(op.outer_non_seqs(node.inputs))
    mapping = dict(zip(inner_seqs, outer_seqs))
    mapping.update(zip(inner_non_seqs, outer_non_seqs))
    try:
        outer_vals = vectorize_graph(candidates, replace=mapping)
    except Exception:
        return False

    fresh = [c.type() for c in candidates]
    new_inner_outputs = clone_replace(list(op.fgraph.outputs),
                                      replace=dict(zip(candidates, fresh)))
    used = set(map(id, ancestors(new_inner_outputs)))
    keep = [i for i, f in enumerate(fresh) if id(f) in used]
    if not keep:
        return False
    # vectorize_graph gives a leading time axis only to values that vary
    # with the sequences; the others (shapes of a slice, ...) come back
    # with the core ndim and re-enter as non-sequences
    seq_fresh, seq_vals, ns_fresh, ns_vals = [], [], [], []
    for i in keep:
        f, c, v = fresh[i], candidates[i], outer_vals[i]
        if v.type.ndim == c.type.ndim + 1:
            seq_fresh.append(f)
            seq_vals.append(v)
        elif v.type.ndim == c.type.ndim:
            ns_fresh.append(f)
            ns_vals.append(v)
        else:
            return False
    new_op = _rebuilt(
        op, ScanInfo(info.n_seqs + len(seq_fresh), info.taps, info.n_nit_sot,
                     info.n_non_seqs + len(ns_fresh), n_untraced=info.n_untraced),
        inner_seqs + seq_fresh + [v for g in op.inner_tap_vars() for v in g]
        + list(op.inner_untraced_vars()) + inner_non_seqs + ns_fresh,
        new_inner_outputs)
    new_outs = new_op(node.inputs[0], *outer_seqs, *seq_vals, *op.outer_inits(node.inputs),
                      *op.outer_untraced_inits(node.inputs), *outer_non_seqs, *ns_vals,
                      return_list=True)
    return dict(zip(node.outputs, new_outs))


optdb.register("scan_push_out_seqs", WalkingGraphRewriter(scan_push_out_seqs),
               "fast_run", "scan", position=1.602)


@node_rewriter([Scan])
def scan_push_out_non_recurrent_outputs(fgraph, node):
    """Replace a nit-sot trace whose inner output is an inner sequence
    slice, a non-sequence or a constant with the outer expression that
    equals it; ``scan_remove_unused_outputs`` then drops the output."""
    from pytensor_tpu_torch.tensor.basic import alloc
    from pytensor_tpu_torch.tensor.shape import specify_shape

    op = node.op
    info = op.info
    if info.as_while:
        return False
    if info.n_nit_sot == 0:
        return False
    inner_seqs = list(op.inner_seq_vars())
    inner_non_seqs = list(op.inner_non_seq_vars())
    outer_seqs = list(op.outer_seqs(node.inputs))
    outer_non_seqs = list(op.outer_non_seqs(node.inputs))
    n_steps = node.inputs[0]
    nit_start = info.n_states + info.n_untraced
    repl = {}
    for m, inner_out in enumerate(op.inner_nit_sot_outs()):
        outer_out = node.outputs[nit_start + m]
        if not fgraph.clients.get(outer_out):
            continue
        # the JAX package's broadcast_to is alloc
        if inner_out in inner_seqs:
            val = outer_seqs[inner_seqs.index(inner_out)][:n_steps]
        elif inner_out in inner_non_seqs:
            v = outer_non_seqs[inner_non_seqs.index(inner_out)]
            val = alloc(v, n_steps, *tuple(v.shape))
        elif isinstance(inner_out, Constant):
            val = alloc(inner_out, n_steps, *inner_out.data.shape)
        else:
            continue
        if any(s is not None for s in outer_out.type.shape):
            val = specify_shape(val, outer_out.type.shape)
        repl[outer_out] = val
    return repl or False


optdb.register("scan_push_out_non_recurrent_outputs",
               WalkingGraphRewriter(scan_push_out_non_recurrent_outputs),
               "fast_run", "scan", position=1.603)


@node_rewriter([Scan])
def scan_push_out_add(fgraph, node):
    """Rewrite an accumulator ``acc' = acc + f(t)`` (f free of every
    carry) whose trace is read only at [-1] into a nit-sot trace of f,
    summed outside the loop."""
    from pytensor_tpu_torch.tensor import math as tm
    from pytensor_tpu_torch.tensor.elemwise import Elemwise

    op = node.op
    info = op.info
    if info.as_while:
        return False
    tap_groups = op.inner_tap_vars()
    carries = {v for g in tap_groups for v in g} | set(op.inner_untraced_vars())
    state_outs = op.inner_state_outs()
    others_anc = None  # computed on first need
    found = None
    for k, taps in enumerate(info.taps):
        if taps != (-1,) or not _last_index_clients_only(fgraph, node, node.outputs[k]):
            continue
        out = state_outs[k]
        if (out.owner is None or not isinstance(out.owner.op, Elemwise)
                or out.owner.op.scalar_op.name != "add" or len(out.owner.inputs) != 2):
            continue
        a, b = out.owner.inputs
        tap_var = tap_groups[k][0]
        rest = b if a is tap_var else (a if b is tap_var else None)
        if rest is None or any(v in carries for v in ancestors([rest])):
            continue
        # the accumulator feeds nothing but this add
        if others_anc is None:
            others = [o for j, o in enumerate(state_outs) if j != k]
            others += list(op.inner_untraced_outs()) + list(op.inner_nit_sot_outs())
            others_anc = set(ancestors(others))
        if tap_var in others_anc or rest.type.ndim != out.type.ndim:
            continue
        found = (k, rest)
        break  # one at a time; the walker runs again
    if found is None:
        return False
    k, rest = found
    keep = [j for j in range(info.n_states) if j != k]
    new_op = _rebuilt(
        op, ScanInfo(info.n_seqs, tuple(info.taps[j] for j in keep), info.n_nit_sot + 1,
                     info.n_non_seqs, n_untraced=info.n_untraced),
        list(op.inner_seq_vars()) + [v for j in keep for v in tap_groups[j]]
        + list(op.inner_untraced_vars()) + list(op.inner_non_seq_vars()),
        [state_outs[j] for j in keep] + list(op.inner_untraced_outs())
        + list(op.inner_nit_sot_outs()) + [rest])
    inits = op.outer_inits(node.inputs)
    new_outs = new_op(node.inputs[0], *op.outer_seqs(node.inputs), *[inits[j] for j in keep],
                      *op.outer_untraced_inits(node.inputs), *op.outer_non_seqs(node.inputs),
                      return_list=True)
    repl = [(node.outputs[j], new_outs[j2]) for j2, j in enumerate(keep)]
    rest_n = info.n_untraced + info.n_nit_sot
    repl += list(zip(node.outputs[info.n_states: info.n_states + rest_n],
                     new_outs[len(keep): len(keep) + rest_n]))
    final = inits[k] + tm.sum(new_outs[len(keep) + rest_n], axis=0)
    repl += [(c.outputs[0], final) for c, _ in fgraph.clients.get(node.outputs[k], ())]
    return dict(repl)


optdb.register("scan_push_out_add", WalkingGraphRewriter(scan_push_out_add),
               "fast_run", "scan", position=1.602)


@node_rewriter([Scan])
def scan_reduce_nsteps(fgraph, node):
    """Shorten a constant ``n_steps`` when every read of every output
    touches only a constant prefix of the trace: ``scan(...)[0][:k]`` or
    ``[i]`` with ``i >= 0`` needs ``max(k, i + 1)`` steps."""
    from pytensor_tpu_torch.tensor.basic import constant
    from pytensor_tpu_torch.tensor.subtensor import DYN, Subtensor

    op = node.op
    info = op.info
    if info.as_while:
        return False
    T = _static_n_steps(node)
    if T is None:
        return False
    # untraced finals need every step
    if any(fgraph.clients.get(node.outputs[info.n_states + u]) for u in range(info.n_untraced)):
        return False
    needed = 0
    to_rewrite = []
    for k, out in enumerate(node.outputs):
        for c, idx in fgraph.clients.get(out, ()):
            # a client that indexes with the trace cannot tell the prefix
            if c == "output" or not isinstance(c.op, Subtensor) or idx != 0:
                return False
            il = c.op.idx_list
            if not il:
                return False
            e = il[0]
            if isinstance(e, (int, np.integer)):
                if int(e) < 0:
                    return False
                needed = max(needed, int(e) + 1)
            elif isinstance(e, tuple) and e[0] == "slice":
                _, start, stop, step = e
                if stop is None or stop == DYN or int(stop) < 0:
                    return False
                if start == DYN or (start is not None and int(start) < 0):
                    return False
                if step == DYN or (step is not None and int(step) < 0):
                    return False
                needed = max(needed, int(stop))
            else:
                return False
            to_rewrite.append((c, k))
    if not to_rewrite or needed >= T or needed < 1:
        return False
    new_outs = op(constant(np.int64(needed)), *node.inputs[1:], return_list=True)
    # the same index expression against the shortened trace
    return {c.outputs[0]: c.op(new_outs[k], *c.inputs[1:]) for c, k in to_rewrite}


optdb.register("scan_reduce_nsteps", WalkingGraphRewriter(scan_reduce_nsteps),
               "fast_run", "scan", "scan_save_mem", position=1.611)

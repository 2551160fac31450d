"""Scan rewrites.

Counterpart of ``pytensor_tpu/scan/rewriting.py``, cut to the rewrites
that fire on the leapfrog chain and the ported tests, at the JAX
package's positions: ``scan_push_out_non_seqs`` (1.601),
``scan_remove_unused_outputs`` (1.605) and ``scan_sit_sot_to_untraced``
(1.62).  The others wait in ROADMAP.md Queue 1 item 5:
``scan_push_out_seqs``, ``scan_push_out_add``,
``scan_push_out_non_recurrent_outputs``, ``scan_reduce_nsteps``,
``scan_truncate_trace_window`` and ``ScanMerge``.
"""

from __future__ import annotations

import numpy as np

from pytensor_tpu_torch.compile.mode import optdb
from pytensor_tpu_torch.graph.basic import Constant
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.graph.rewriting.basic import WalkingGraphRewriter, node_rewriter
from pytensor_tpu_torch.scan.op import Scan, ScanInfo
from pytensor_tpu_torch.tensor.basic import NotScalarConstantError, get_scalar_constant_value


def _rebuilt(op, info, inner_inputs, inner_outputs):
    return Scan(FunctionGraph(inner_inputs, inner_outputs, clone=True), info, name=op.name)


@node_rewriter([Scan])
def scan_remove_unused_outputs(fgraph, node):
    """Rebuild a Scan without the nit-sot outputs that have no clients."""
    op = node.op
    info = op.info
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
    try:
        n_steps = int(get_scalar_constant_value(node.inputs[0]))
    except NotScalarConstantError:
        n_steps = None
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


@node_rewriter([Scan])
def scan_push_out_non_seqs(fgraph, node):
    """Hoist inner subgraphs that depend only on non-sequences and
    constants out of the loop: they become extra non-sequences, computed
    once in the outer graph."""
    from pytensor_tpu_torch.graph.replace import clone_replace
    from pytensor_tpu_torch.graph.traversal import ancestors

    op = node.op
    info = op.info
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

"""The scan() user API.

Counterpart of ``pytensor_tpu/scan/basic.py:26 scan``: classify the step
function's recurrences into sequences, states, nit-sots and
non-sequences, build the inner graph by calling the step function once on
symbolic slices, and wrap it in a Scan op.  Shared variables the step
function reads become implicit non-sequences; tensor shared variables it
updates become traced states whose last value is the update.

The JAX package's options are all accepted: ``truncate_gradient``
(``Scan.L_op``), ``go_backwards`` (the sequences flipped), taps on
sequences (each tap a shifted view of its sequence), several sequences
of unknown length without ``n_steps`` (the shortest wins), ``strict``,
``return_list``, ``return_updates``, ``unroll`` (kept on the op, ignored
by the step loop), and ``mode``, ``profile`` and ``allow_gc``, which the
JAX package accepts and ignores too.  A shared RNG key that a
RandomVariable of the step consumes becomes an untraced state (the
JAX package's ``scan/basic.py:345-480``): the key threads through the
loop, each step drawing from it and passing on the next key, and its
final value is the update of the shared variable; so does the target of
an explicit update that is not a tensor.

A step function that returns ``until(cond)`` (alone, or as ``(outputs,
until)`` or ``(outputs, updates, until)``) makes a while-scan
(``pytensor_tpu/scan/basic.py:269-300, :484-530``): the loop stops after
the step at which ``cond`` holds, or at ``n_steps``.  Each trace it
returns, and the last value a traced update reads, is the executed prefix
(``scan/dynlen.py TruncateToDone``), and outer variables that only the
condition reads become implicit non-sequences too.
"""

from __future__ import annotations

from typing import Callable

from pytensor_tpu_torch.graph.basic import Constant, Variable
from pytensor_tpu_torch.graph.fg import FunctionGraph, MissingInputError
from pytensor_tpu_torch.graph.traversal import ancestors, graph_inputs
from pytensor_tpu_torch.scan.op import Scan, ScanInfo
from pytensor_tpu_torch.scan.utils import until
from pytensor_tpu_torch.tensor.basic import as_tensor_variable
from pytensor_tpu_torch.tensor.type import TensorType
from pytensor_tpu_torch.updates import OrderedUpdates


def _listify(x):
    if x is None:
        return []
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


def _is_updates(x):
    if isinstance(x, (dict, OrderedUpdates)):
        return True
    return (isinstance(x, (list, tuple)) and len(x) > 0
            and all(isinstance(p, (tuple, list)) and len(p) == 2
                    and isinstance(p[0], Variable) for p in x))


def _sequences(sequences, go_backwards):
    """The inner sequences (each tap of a sequence is a shifted view of
    it; a sequence's tap k at step t reads s[t - lo + k]) and the usable
    length of each sequence the user gave."""
    from pytensor_tpu_torch.tensor.shape import shape
    from pytensor_tpu_torch.tensor.subtensor import flip

    seq_vars, lengths = [], []
    for s in sequences:
        taps = [0]
        if isinstance(s, dict):
            taps = list(s.get("taps") or [0])
            s = s["input"]
        sv = as_tensor_variable(s)
        if go_backwards:
            sv = flip(sv, 0)
        if taps == [0]:
            seq_vars.append(sv)
            lengths.append(shape(sv)[0])
            continue
        lo, hi = min(min(taps), 0), max(max(taps), 0)
        usable = shape(sv)[0] - int(hi - lo)
        lengths.append(usable)
        for tap in taps:
            start = tap - lo
            seq_vars.append(sv[start:] if hi == lo else sv[start: start + usable])
    return seq_vars, lengths


def _n_steps(n_steps, seq_vars, lengths):
    """(n_steps variable, its static value or None, whether it was given)."""
    from pytensor_tpu_torch.tensor.basic import (
        NotScalarConstantError,
        get_scalar_constant_value,
    )
    from pytensor_tpu_torch.tensor.math import minimum

    if n_steps is not None:
        n_steps_var = as_tensor_variable(n_steps)
    elif not seq_vars:
        raise ValueError("scan needs sequences or n_steps")
    else:
        # the shortest sequence's usable length
        n_steps_var = lengths[0]
        for ln in lengths[1:]:
            n_steps_var = minimum(n_steps_var, ln)
    try:
        static_n = int(get_scalar_constant_value(n_steps_var))
    except NotScalarConstantError:
        static_n = None
    return n_steps_var, static_n, n_steps is not None


def scan(fn: Callable, sequences=None, outputs_info=None, non_sequences=None,
         n_steps=None, truncate_gradient: int = -1, go_backwards: bool = False, mode=None,
         name: str | None = None, profile=False, allow_gc=None, strict: bool = False,
         return_list: bool = False, unroll: int | None = None, return_updates: bool = True):
    """Loop ``fn`` over sequences and recurrences; returns (outputs, updates),
    or the outputs alone with ``return_updates=False``.

    ``outputs_info`` holds, per output, an initial value (a state with tap
    -1), a dict ``{"initial": value, "taps": [...]}`` with negative taps,
    or None for an output without recurrence (a nit-sot).  A sequence may
    be a dict ``{"input": x, "taps": [...]}``.
    """
    from pytensor_tpu_torch.compile.sharedvalue import SharedVariable
    from pytensor_tpu_torch.graph.basic import clone_get_equiv
    from pytensor_tpu_torch.graph.replace import graph_replace
    from pytensor_tpu_torch.scalar.basic import upcast
    from pytensor_tpu_torch.tensor.random.op import RandomVariable
    from pytensor_tpu_torch.tensor.random.type import RandomGeneratorType

    sequences = _listify(sequences)
    outputs_info = _listify(outputs_info)
    non_sequences = _listify(non_sequences)

    seq_vars, lengths = _sequences(sequences, go_backwards)
    n_steps_var, static_n, explicit = _n_steps(n_steps, seq_vars, lengths)
    # clip each sequence to exactly n_steps rows
    if seq_vars and (explicit or len(lengths) > 1):
        seq_vars = [sv if static_n is not None and sv.type.shape[0] == static_n
                    else sv[: (static_n if static_n is not None else n_steps_var)]
                    for sv in seq_vars]

    states = []  # (initial, taps) or None for a nit-sot
    for oi in outputs_info:
        if oi is None or (isinstance(oi, dict) and oi.get("initial") is None):
            states.append(None)
        elif isinstance(oi, dict):
            # taps keep the user's order: fn gets its tap arguments as listed
            taps = tuple(oi.get("taps", [-1]))
            if any(t >= 0 for t in taps):
                raise ValueError("output taps must be negative")
            if len(set(taps)) != len(taps):
                raise ValueError(f"repeated output taps {taps}")
            states.append((as_tensor_variable(oi["initial"]), taps))
        else:
            states.append((as_tensor_variable(oi), (-1,)))
    non_seq_vars = [v if isinstance(v, Variable) else as_tensor_variable(v)
                    for v in non_sequences]

    # inner input variables; fn is called exactly once, and a state whose
    # output widens its dtype is reconciled by cloning the traced graph
    # with widened tap variables
    state_dtype: dict[int, str] = {}

    def build_taps():
        groups = []
        for k, (idx, st) in enumerate((i, s) for i, s in enumerate(states) if s is not None):
            init, taps = st
            dt = state_dtype.get(k, init.type.dtype)
            single = -min(taps) == 1 and len(taps) == 1
            core = TensorType(dt, init.type.shape if single else init.type.shape[1:])
            groups.append([core(f"state{idx}[t{tap}]") for tap in taps])
        return groups

    inner_seqs = [TensorType(s.type.dtype, s.type.shape[1:])(f"{s.name or 'seq'}[t]")
                  for s in seq_vars]
    inner_taps = build_taps()
    args = list(inner_seqs) + [v for g in inner_taps for v in g] + non_seq_vars
    raw = fn(*args)

    explicit_updates = OrderedUpdates()

    def collect_updates(u):
        for k, v in (u.items() if isinstance(u, dict) else u):
            tensor = isinstance(getattr(k, "type", None), TensorType)
            explicit_updates[k] = as_tensor_variable(v) if tensor else v

    condition = None
    if isinstance(raw, dict) or (_is_updates(raw) and not isinstance(raw, tuple)):
        outputs_raw = []
        collect_updates(raw)
    elif (isinstance(raw, tuple) and len(raw) in (2, 3)
          and (isinstance(raw[-1], until) or _is_updates(raw[-1]) or len(raw) == 3)
          and not all(isinstance(r, Variable) for r in raw)):
        # (outputs, updates), (outputs, until), (outputs, updates, until)
        outputs_raw = raw[0]
        for extra in raw[1:]:
            if isinstance(extra, until):
                condition = extra.condition
            elif isinstance(extra, dict) or _is_updates(extra):
                collect_updates(extra)
            else:
                raise TypeError(f"unexpected scan fn return component {extra}")
    elif isinstance(raw, until):
        outputs_raw = []
        condition = raw.condition
    else:
        outputs_raw = raw
    user_outs = [as_tensor_variable(o) for o in _listify(outputs_raw)]

    if outputs_info and len(states) != len(user_outs):
        raise ValueError(f"scan fn returned {len(user_outs)} outputs but outputs_info "
                         f"has {len(states)}")
    if not outputs_info:
        states = [None] * len(user_outs)

    for _ in range(4):
        state_outs = [o for o, st in zip(user_outs, states) if st is not None]
        retry = False
        for k, (out, group) in enumerate(zip(state_outs, inner_taps)):
            core = group[0]
            if out.type.ndim != core.type.ndim:
                raise TypeError(f"scan state {k}: output type {out.type} incompatible with "
                                f"initial/tap type {core.type}")
            if out.type.dtype != core.type.dtype:
                if upcast(core.type.dtype, out.type.dtype) != out.type.dtype:
                    raise TypeError(
                        f"scan state {k}: inner function downcasts the state from "
                        f"{out.type.dtype} given initial dtype {core.type.dtype}; cast the "
                        "initial state explicitly")
                state_dtype[k] = out.type.dtype
                retry = True
        if not retry:
            break
        new_taps = build_taps()
        mapping = [(old, new) for og, ng in zip(inner_taps, new_taps)
                   for old, new in zip(og, ng) if old.type != new.type]
        keys = list(explicit_updates)
        exprs = graph_replace(user_outs + [explicit_updates[k] for k in keys]
                              + ([condition] if condition is not None else []), mapping,
                              strict=False)
        user_outs = list(exprs[: len(user_outs)])
        for k, v in zip(keys, exprs[len(user_outs): len(user_outs) + len(keys)]):
            explicit_updates[k] = v
        if condition is not None:
            condition = exprs[-1]
        inner_taps = new_taps
    else:
        raise TypeError("scan could not reconcile state dtypes with fn outputs")

    state_outs = [o for o, st in zip(user_outs, states) if st is not None]
    nit_outs = [o for o, st in zip(user_outs, states) if st is None]
    taps_list = tuple(st[1] for st in states if st is not None)
    inits = [st[0] for st in states if st is not None]
    if state_dtype:
        from pytensor_tpu_torch.tensor.basic import cast

        inits = [cast(init, state_dtype[k]) if k in state_dtype else init
                 for k, init in enumerate(inits)]
    flat_taps = [v for g in inner_taps for v in g]
    inner_inputs = inner_seqs + flat_taps
    inner_outputs = state_outs + nit_outs + ([condition] if condition is not None else [])

    # implicit non-sequences: outer variables the inner graph reads
    upd_targets = list(explicit_updates)
    for t in upd_targets:
        if not isinstance(t, SharedVariable):
            raise TypeError(f"scan updates must target SharedVariables, got {t}")
    upd_exprs = [explicit_updates[k] for k in upd_targets]
    explicit_ns = set(non_seq_vars)
    output_roots = set(graph_inputs(inner_outputs, blockers=non_seq_vars))
    inner_set = set(inner_inputs)
    implicit = []
    for v in graph_inputs(inner_outputs + upd_exprs, blockers=non_seq_vars):
        if isinstance(v, Constant) or v in explicit_ns or v in inner_set or v in implicit:
            continue
        if v.owner is None and not isinstance(v, SharedVariable) and v not in output_roots:
            raise MissingInputError(
                f"Undeclared input {v} used by the scan inner function.\n"
                "Please pass this variable to the scan's inner function. Do not forget "
                "to also pass it to the `non_sequences` attribute of scan.")
        if strict and v not in upd_targets:
            raise MissingInputError(f"scan(strict=True): implicit input {v}")
        implicit.append(v)
    # shared RNG keys the step reads become untraced states below
    rng_implicit = [v for v in implicit if isinstance(v, SharedVariable)
                    and isinstance(v.type, RandomGeneratorType) and v not in upd_targets]
    implicit = [v for v in implicit if v not in upd_targets and v not in rng_implicit]

    # tensor update targets thread as traced states (so gradients flow
    # through them; the update reads trace[-1]); other targets, and the
    # RNG keys, as untraced states
    traced_upd = [k for k in upd_targets if isinstance(k.type, TensorType)]
    untraced_upd = [k for k in upd_targets if not isinstance(k.type, TensorType)]
    traced_in, traced_out, untraced_inits, untraced_in, untraced_out = [], [], [], [], []
    nonseq_inputs = []
    if implicit or upd_targets or non_seq_vars or rng_implicit:
        ns_placeholders = [v.type(v.name or "w") for v in non_seq_vars]
        placeholders = [v.type() for v in implicit]
        rng_placeholders = [v.type() for v in rng_implicit]
        upd_in = {k: k.type() for k in upd_targets}
        outer = non_seq_vars + implicit + rng_implicit + upd_targets
        memo = dict(zip(outer, ns_placeholders + placeholders + rng_placeholders
                        + [upd_in[k] for k in upd_targets]))
        memo = clone_get_equiv(inner_inputs + outer, inner_outputs + upd_exprs,
                               copy_inputs=False, copy_orphans=False, memo=memo)
        inner_outputs = [memo[o] for o in inner_outputs]
        upd_exprs = [memo.get(e, e) for e in upd_exprs]
        upd_of = dict(zip(upd_targets, upd_exprs))
        traced_in = [upd_in[k] for k in traced_upd]
        traced_out = [upd_of[k] for k in traced_upd]
        untraced_inits = list(untraced_upd)
        untraced_in = [upd_in[k] for k in untraced_upd]
        untraced_out = [upd_of[k] for k in untraced_upd]
        non_seq_vars = non_seq_vars + implicit
        nonseq_inputs = ns_placeholders + placeholders
        # a key's transition is the next key of the RandomVariable that
        # consumes it; a key read by nothing else stays a non-sequence
        consumers = {}
        for v in ancestors(inner_outputs + upd_exprs):
            node = v.owner
            if node is not None and isinstance(node.op, RandomVariable):
                consumers.setdefault(node.inputs[0], node.outputs[0])
        for sv, ph in zip(rng_implicit, rng_placeholders):
            if ph in consumers:
                untraced_inits.append(sv)
                untraced_in.append(ph)
                untraced_out.append(consumers[ph])
            else:
                non_seq_vars.append(sv)
                nonseq_inputs.append(ph)

    n_user_states = len(state_outs)
    info = ScanInfo(n_seqs=len(seq_vars), taps=taps_list + ((-1,),) * len(traced_upd),
                    n_nit_sot=len(nit_outs), n_non_seqs=len(non_seq_vars),
                    n_untraced=len(untraced_in), as_while=condition is not None)
    # canonical order: seqs + taps (user states, then update states) +
    # untraced + non-seqs; outputs: user states, update states, untraced,
    # nit-sots, the condition
    fgraph = FunctionGraph(
        inner_seqs + flat_taps + traced_in + untraced_in + nonseq_inputs,
        inner_outputs[:n_user_states] + traced_out + untraced_out
        + inner_outputs[n_user_states:],
        clone=True)
    node_outs = Scan(fgraph, info, name=name, truncate_gradient=truncate_gradient,
                     unroll=unroll)(
        n_steps_var, *seq_vars, *inits, *traced_upd, *untraced_inits, *non_seq_vars,
        return_list=True)

    steps_done = node_outs[-1] if info.as_while else None

    def prefix(trace):
        """A while-scan trace's executed prefix; a for-scan's whole trace."""
        if steps_done is None:
            return trace
        from pytensor_tpu_torch.scan.dynlen import truncate_to_done

        return truncate_to_done(trace, steps_done)

    updates = OrderedUpdates()
    traced_pos = {sv: n_user_states + j for j, sv in enumerate(traced_upd)}
    untraced_pos = {sv: info.n_states + u for u, sv in enumerate(untraced_inits)}
    for sv in upd_targets:
        updates[sv] = (prefix(node_outs[traced_pos[sv]])[-1] if sv in traced_pos
                       else node_outs[untraced_pos[sv]])
    for sv in untraced_inits:
        if sv not in updates:
            updates[sv] = node_outs[untraced_pos[sv]]
    traces = iter(prefix(o) for o in node_outs[:n_user_states])
    nit_end = info.n_states + info.n_untraced + info.n_nit_sot
    nits = iter(prefix(o) for o in node_outs[info.n_states + info.n_untraced: nit_end])
    results = [next(traces) if st is not None else next(nits) for st in states]
    if len(results) == 1 and not return_list:
        results = results[0]
    if not return_updates:
        if len(updates):
            raise ValueError(
                "scan(..., return_updates=False) but the inner function produced non-empty "
                "updates. Either use return_updates=True and pass the updates to `function`, "
                "or handle the recurrent state explicitly via outputs_info.")
        return results
    return results, updates

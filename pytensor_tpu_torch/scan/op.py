"""The Scan op: a loop over an inner graph.

Counterpart of ``pytensor_tpu/scan/op.py`` (ScanInfo:93, Scan:116).  The
state taxonomy is the JAX package's: sequences, states with negative taps
(a sit-sot is taps ``(-1,)``), untraced states (the final value only, no
trace), nit-sots, non-sequences and, in a while-scan (``as_while``), a
condition: the inner graph's last output, which stops the loop after the
step at which it holds.  A while-scan's node has one more output, the
int64 ``steps_done``, and its traces are static ``(n_steps, *core)``
buffers that are zero past the last step run (``scan()`` wraps each in
``scan/dynlen.py TruncateToDone``); its untraced states are their values
after that step.  Two Scans are
equal when their static structure, ``truncate_gradient``, ``unroll`` and
inner graphs agree structurally (``_signature``), as ``ScanMerge`` and
the merge pass need.

The gradient (``L_op``, ``pytensor_tpu/scan/op.py:399-780``) is backprop
through time as a graph: a reverse scan over the pullback of the inner
graph, with the state cotangents carried as windows of the states' taps
and the non-sequences' gradients accumulated in carries, truncated to the
last ``truncate_gradient`` steps when that is set.  A while-scan's
reverse scan runs over the steps its forward ran (``steps_done``), where
the JAX package's runs all ``n_steps`` and masks the ones past the exit.

The torch lowering (``link/torch/dispatch.py``) runs the loop step by
step, or, with ``config.scan__pallas`` on a CUDA device, an eligible
for-scan as one kernel (K2, ``link/cuda/scan_kernel.py``; it refuses a
while-scan, as the JAX package's Pallas kernel does).  ``unroll`` is kept
for equality and ignored by the lowering: the step loop has no compiled
body to replicate.  ``perform`` is the numpy loop that constant folding
evaluates.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.graph.null_type import DisconnectedType, NullType
from pytensor_tpu_torch.graph.op import HasInnerGraph, Op
from pytensor_tpu_torch.tensor.basic import (
    NotScalarConstantError,
    as_tensor_variable,
    get_scalar_constant_value,
)
from pytensor_tpu_torch.tensor.type import TensorType

class _NullInnerGradError(Exception):
    """Raised while building the reverse scan when an inner gradient is
    NullType (undefined); caught in L_op."""


def _op_token(op):
    """A discriminating string for an op: its type and ``__props__``
    values (``str(op)`` alone can collide across parameterizations)."""
    props = getattr(op, "__props__", None)
    if props:
        vals = ",".join(repr(getattr(op, p, None)) for p in props)
        return f"{type(op).__name__}({vals})"
    return f"{type(op).__name__}:{op}"


def _structural_signature(fgraph):
    """Structural signature of an inner graph: free of variable identity
    except for true orphans, recursing into inner graphs."""
    in_pos = {v: i for i, v in enumerate(fgraph.inputs)}
    memo = {}

    def sig(v):
        if v in memo:
            return memo[v]
        if v in in_pos:
            s = f"in{in_pos[v]}[{v.type}]"
        elif isinstance(v, Constant):
            try:
                body = np.asarray(v.data).tobytes().hex()[:64]
            except Exception:
                body = repr(v.data)
            s = f"const[{v.type}]{body}"
        elif v.owner is None:
            s = f"free[{v.type}]@{id(v)}"  # only identity tells orphans apart
        else:
            node = v.owner
            op = node.op
            op_s = (f"{type(op).__name__}<{_structural_signature(op.fgraph)}>"
                    if isinstance(op, HasInnerGraph) else _op_token(op))
            args = ",".join(sig(i) for i in node.inputs)
            s = f"{op_s}({args})#{node.outputs.index(v)}"
        memo[v] = s
        return s

    return ";".join(sig(o) for o in fgraph.outputs)


@dataclass(frozen=True)
class ScanInfo:
    """Static structure of a Scan node.

    taps[k] = negative taps of recurrent state k (sit-sot = (-1,)).
    Inner-input order:  seq slices + state taps (flattened) + untraced + non_seqs.
    Inner-output order: state outs + untraced outs + nit-sot outs (+ the
    condition, last, in a while-scan).
    Outer-input order:  n_steps + seqs + state inits + untraced inits + non_seqs.
    Outer-output order: state traces + untraced finals + nit-sot traces (+
    ``steps_done``, last, in a while-scan).
    """

    n_seqs: int
    taps: tuple
    n_nit_sot: int
    n_non_seqs: int
    n_untraced: int = 0
    as_while: bool = False

    @property
    def n_states(self):
        return len(self.taps)


class Scan(Op, HasInnerGraph):
    def __init__(self, fgraph: FunctionGraph, info: ScanInfo, name=None,
                 truncate_gradient: int = -1, mode=None, unroll=None):
        self.fgraph = fgraph
        self.info = info
        self.name = name
        self.truncate_gradient = truncate_gradient
        self.unroll = max(1, int(1 if unroll is None else unroll))
        expected_in = (info.n_seqs + sum(len(t) for t in info.taps)
                       + info.n_untraced + info.n_non_seqs)
        expected_out = info.n_states + info.n_untraced + info.n_nit_sot + info.as_while
        if len(fgraph.inputs) != expected_in:
            raise ValueError(
                f"Scan inner graph has {len(fgraph.inputs)} inputs, expected {expected_in}")
        if len(fgraph.outputs) != expected_out:
            raise ValueError(
                f"Scan inner graph has {len(fgraph.outputs)} outputs, expected {expected_out}")

    @property
    def _signature(self):
        # cached: rewrites build new Scans and never change an inner graph
        # in place
        sig = getattr(self, "_sig_cache", None)
        if sig is None:
            sig = self._sig_cache = (self.info, self.truncate_gradient, self.unroll,
                                     _structural_signature(self.fgraph))
        return sig

    def __getstate__(self):
        # the signature holds every constant's bytes; a loaded op makes it
        # again when it is first compared
        d = self.__dict__.copy()
        d.pop("_sig_cache", None)
        return d

    def __eq__(self, other):
        if self is other:
            return True
        if type(other) is not type(self):
            return NotImplemented
        return self._signature == other._signature

    def __hash__(self):
        return hash(self._signature)

    def clone(self):
        # the inner graph is never changed in place: rewrites build new ops
        return self

    def clone_fresh(self):
        """A copy with a freshly cloned inner graph (distinct inner
        variables), for rewrites that splice inner graphs (ScanMerge)."""
        import copy

        res = copy.copy(self)
        res.fgraph = self.fgraph.clone()
        res.__dict__.pop("_sig_cache", None)
        return res

    def rebuilt(self, fgraph, info):
        """A Scan over ``fgraph`` with ``info`` and this one's name,
        ``truncate_gradient`` and ``unroll``."""
        return Scan(fgraph, info, name=self.name, truncate_gradient=self.truncate_gradient,
                    unroll=self.unroll)

    # --- structure helpers ---
    def outer_seqs(self, inputs):
        return inputs[1: 1 + self.info.n_seqs]

    def outer_inits(self, inputs):
        k = 1 + self.info.n_seqs
        return inputs[k: k + self.info.n_states]

    def outer_untraced_inits(self, inputs):
        k = 1 + self.info.n_seqs + self.info.n_states
        return inputs[k: k + self.info.n_untraced]

    def outer_non_seqs(self, inputs):
        return inputs[1 + self.info.n_seqs + self.info.n_states + self.info.n_untraced:]

    def inner_seq_vars(self):
        return self.fgraph.inputs[: self.info.n_seqs]

    def inner_tap_vars(self):
        n = self.info.n_seqs
        res = []
        for taps in self.info.taps:
            res.append(self.fgraph.inputs[n: n + len(taps)])
            n += len(taps)
        return res

    def inner_untraced_vars(self):
        n = self.info.n_seqs + sum(len(t) for t in self.info.taps)
        return self.fgraph.inputs[n: n + self.info.n_untraced]

    def inner_non_seq_vars(self):
        n = (self.info.n_seqs + sum(len(t) for t in self.info.taps)
             + self.info.n_untraced)
        return self.fgraph.inputs[n:]

    def inner_state_outs(self):
        return self.fgraph.outputs[: self.info.n_states]

    def inner_untraced_outs(self):
        return self.fgraph.outputs[self.info.n_states: self.info.n_states + self.info.n_untraced]

    def inner_nit_sot_outs(self):
        k = self.info.n_states + self.info.n_untraced
        return self.fgraph.outputs[k: k + self.info.n_nit_sot]

    def make_node(self, n_steps, *outer_inputs):
        info = self.info
        n_steps = as_tensor_variable(n_steps)
        outer_inputs = [x if isinstance(x, Variable) else as_tensor_variable(x)
                        for x in outer_inputs]
        seqs = outer_inputs[: info.n_seqs]
        try:
            static_T = int(get_scalar_constant_value(n_steps))
        except NotScalarConstantError:
            static_T = None
        if static_T is None and seqs:
            static_T = seqs[0].type.shape[0]
        outputs = [TensorType(o.type.dtype, (static_T, *o.type.shape))()
                   for o in self.inner_state_outs()]
        outputs += [o.type() for o in self.inner_untraced_outs()]
        outputs += [TensorType(o.type.dtype, (static_T, *o.type.shape))()
                    for o in self.inner_nit_sot_outs()]
        if info.as_while:
            outputs.append(TensorType("int64", ())())  # steps_done
        return Apply(self, [n_steps, *outer_inputs], outputs)

    # --- numpy loop (constant folding) ---
    def _inner(self, vals):
        storage = dict(zip(self.fgraph.inputs, vals))
        for node in self.fgraph.toposort():
            args = [i.data if isinstance(i, Constant) else storage[i] for i in node.inputs]
            out = [[None] for _ in node.outputs]
            node.op.perform(node, args, out)
            storage.update((o, s[0]) for o, s in zip(node.outputs, out))
        return [o.data if isinstance(o, Constant) else storage[o] for o in self.fgraph.outputs]

    def perform(self, node, inputs, output_storage):
        info = self.info
        n_steps = int(inputs[0])
        seqs = self.outer_seqs(inputs)
        inits = self.outer_inits(inputs)
        untraced = list(self.outer_untraced_inits(inputs))
        non_seqs = self.outer_non_seqs(inputs)
        # state histories, oldest first
        hist = []
        for init, taps in zip(inits, info.taps):
            m = -min(taps)
            single = m == 1 and len(taps) == 1
            hist.append([np.asarray(init)] if single else [np.asarray(init[i]) for i in range(m)])
        state_traces = [[] for _ in range(info.n_states)]
        nit_traces = [[] for _ in range(info.n_nit_sot)]
        steps_done = 0
        for t in range(n_steps):
            args = [np.asarray(s[t]) for s in seqs]
            for k, taps in enumerate(info.taps):
                m = -min(taps)
                args.extend(hist[k][m + tap] for tap in taps)
            args.extend(untraced)
            args.extend(np.asarray(ns) for ns in non_seqs)
            res = self._inner(args)
            for k in range(info.n_states):
                state_traces[k].append(res[k])
                hist[k].append(res[k])
                hist[k].pop(0)
            untraced = res[info.n_states: info.n_states + info.n_untraced]
            for j in range(info.n_nit_sot):
                nit_traces[j].append(res[info.n_states + info.n_untraced + j])
            steps_done += 1
            if info.as_while and bool(res[-1]):
                break  # the condition held: this step is the last
        # a while-scan's traces are zero past its last step
        for tr in state_traces + nit_traces:
            tr.extend([np.zeros_like(tr[-1])] * (n_steps - len(tr)) if tr else [])
        outs = node.outputs
        for k in range(info.n_states):
            output_storage[k][0] = (np.stack(state_traces[k]) if n_steps else np.zeros(
                (0, *np.shape(hist[k][-1])), dtype=outs[k].type.numpy_dtype))
        for u in range(info.n_untraced):
            output_storage[info.n_states + u][0] = np.asarray(untraced[u])
        for j in range(info.n_nit_sot):
            pos = info.n_states + info.n_untraced + j
            shape = tuple(s or 0 for s in outs[pos].type.shape[1:])
            output_storage[pos][0] = (np.stack(nit_traces[j]) if n_steps else
                                      np.zeros((0, *shape), dtype=outs[pos].type.numpy_dtype))
        if info.as_while:
            output_storage[-1][0] = np.int64(steps_done)

    def infer_shape(self, fgraph, node, input_shapes):
        """Trace shapes are (n_steps, *core); a state's core shape comes
        from its initial value, a nit-sot's from the static inner shape or
        the output's own Shape_i."""
        from pytensor_tpu_torch.tensor.basic import cast
        from pytensor_tpu_torch.tensor.shape import shape as sym_shape

        info = self.info
        n_steps = cast(node.inputs[0], "int64")
        res = []
        for k, taps in enumerate(info.taps):
            init_shape = input_shapes[1 + info.n_seqs + k]
            single = -min(taps) == 1 and len(taps) == 1
            res.append((n_steps, *(init_shape if single else init_shape[1:])))
        for u in range(info.n_untraced):
            res.append(tuple(input_shapes[1 + info.n_seqs + info.n_states + u]))
        for j, inner_out in enumerate(self.inner_nit_sot_outs()):
            out = node.outputs[info.n_states + info.n_untraced + j]
            dims = [n_steps]
            for d, static in enumerate(inner_out.type.shape):
                dims.append(static if static is not None else sym_shape(out)[d + 1])
            res.append(tuple(dims))
        if info.as_while:
            res.append(())
        return res

    def connection_pattern(self, node):
        # every input but n_steps may affect every output
        return [[False] * len(node.outputs)] + [[True] * len(node.outputs)
                                                for _ in node.inputs[1:]]

    def L_op(self, inputs, outputs, output_grads):
        """Backprop through time: a reverse scan over the pullback of the
        inner graph (``pytensor_tpu/scan/op.py:399-780``, its for-scan
        branches).

        Its sequences are the reversed output cotangents, the reversed
        values each tap read and the reversed sequence slices.  Its
        carries are, for each state, the window of pending cotangents of
        the state's last ``-min(taps)`` values (slot i for h^{t-1-i}), and
        for each non-sequence its accumulated gradient; its nit-sots are
        the sequences' gradients.  With ``truncate_gradient = n`` only the
        last n steps run, and earlier sequence rows get zeros.

        RNG keys (untraced states) have no gradient, but the reverse scan
        must draw what each forward step drew: the forward is run again
        with a trace of the key each step consumed (``TensorFromKey``), and
        the reverse scan takes the reversed trace as a sequence and draws
        from each key again (``pytensor_tpu/scan/op.py:419-461, :573-620``).

        A while-scan's reverse scan (``pytensor_tpu/scan/op.py:468-616``)
        runs over the executed prefixes, ``steps_done`` steps, where the
        JAX package's runs ``n_steps`` and masks the steps past the exit:
        the values are the same, and the padded rows' pullbacks (a 0 * inf
        there is NaN in the JAX package) are never built.  With
        ``truncate_gradient = n`` it takes ``steps_done`` as a
        non-sequence and each reverse step's forward index as a sequence,
        as the JAX package's does, and keeps the cotangents of the last n
        steps run only, the pending windows cut below them.
        """
        from pytensor_tpu_torch.graph.basic import clone_get_equiv
        from pytensor_tpu_torch.gradient import grad_not_implemented, grad_undefined, pullback
        from pytensor_tpu_torch.scan.basic import scan
        from pytensor_tpu_torch.tensor import math as tm
        from pytensor_tpu_torch.tensor.basic import (
            alloc,
            arange,
            concatenate,
            shape_padleft,
            stack,
            zeros_like,
        )
        from pytensor_tpu_torch.tensor.shape import shape
        from pytensor_tpu_torch.tensor.subtensor import flip

        from pytensor_tpu_torch.tensor.random.type import (
            RandomGeneratorType,
            key_from_tensor,
            tensor_from_key,
        )

        info = self.info
        key_traces = []
        if info.n_untraced:
            if any(not isinstance(v.type, RandomGeneratorType)
                   for v in self.inner_untraced_vars()):
                # tensor-typed untraced states only arise from rewrites
                # (scan() threads explicit updates as traced states); BPTT
                # through them would need their per-step values
                return [grad_not_implemented(self, i, inp, "tensor-typed untraced scan state")
                        for i, inp in enumerate(inputs)]
            # the forward again, with each step's consumed key as a nit-sot
            # (a while-scan's condition stays last)
            outs = list(self.fgraph.outputs)
            cond = [outs.pop()] if info.as_while else []
            aug_fg = FunctionGraph(
                list(self.fgraph.inputs),
                outs + [tensor_from_key(v) for v in self.inner_untraced_vars()] + cond,
                clone=True)
            aug_info = ScanInfo(n_seqs=info.n_seqs, taps=info.taps,
                                n_nit_sot=info.n_nit_sot + info.n_untraced,
                                n_non_seqs=info.n_non_seqs, n_untraced=info.n_untraced,
                                as_while=info.as_while)
            aug_outs = Scan(aug_fg, aug_info, name=f"{self.name or 'scan'}_keys",
                            unroll=self.unroll)(*inputs, return_list=True)
            base = info.n_states + info.n_untraced + info.n_nit_sot
            key_traces = aug_outs[base: base + info.n_untraced]

        as_while = info.as_while
        if as_while:
            # steps_done has no cotangent; trace rows past it are zero
            steps_done = outputs[-1]
            outputs, output_grads = outputs[:-1], output_grads[:-1]
        n_steps = inputs[0]
        truncate = self.truncate_gradient
        seqs = list(self.outer_seqs(inputs))
        inits = list(self.outer_inits(inputs))
        non_seqs = list(self.outer_non_seqs(inputs))

        # an initial value broadcastable where the inner output is not makes
        # the pullback ill-typed
        for k, (init, taps) in enumerate(zip(inits, info.taps)):
            single = -min(taps) == 1 and len(taps) == 1
            core_shape = init.type.shape if single else init.type.shape[1:]
            out_shape = self.inner_state_outs()[k].type.shape
            for a, b in zip(core_shape, out_shape):
                if a == 1 and b != 1:
                    raise TypeError(
                        f"scan state {k}: the initial value has a broadcastable dimension "
                        f"(shape {core_shape}) where the inner function's output does not "
                        f"(shape {out_shape}); the gradient graph cannot be built. Give the "
                        "initial state the output's type.")
        state_traces = outputs[: info.n_states]

        # missing output cotangents are zeros; the keys have none
        data = slice(info.n_states, info.n_states + info.n_untraced)
        filled = []
        for out, g in zip(outputs[:data.start] + outputs[data.stop:],
                          output_grads[:data.start] + output_grads[data.stop:]):
            if isinstance(getattr(g, "type", None), (DisconnectedType, NullType)):
                filled.append(zeros_like(out))
                continue
            if (g.type.ndim == out.type.ndim and g.type.ndim > 0
                    and g.type.shape[0] == 1 and out.type.shape[0] != 1):
                # a broadcastable (1, ...) cotangent is expanded to the
                # trace's length: scan never broadcasts a sequence
                g = tm.second(out, g)
            filled.append(g)

        # each state's full history: the initial rows, then the trace
        hists = []
        for k, (init, taps) in enumerate(zip(inits, info.taps)):
            m = -min(taps)
            init_buf = shape_padleft(init) if (m == 1 and len(taps) == 1) else init[:m]
            hists.append(concatenate([init_buf, state_traces[k]], axis=0))

        n_steps_i = tm.cast(n_steps, "int64")
        # the steps the forward ran: all n_steps, or a while-scan's
        # steps_done
        n_run = steps_done if as_while else n_steps_i
        # a truncated while-scan masks by the step index
        window = as_while and truncate != -1
        rev_seqs = [flip(g[:n_run] if as_while else g, 0) for g in filled]
        for k, taps in enumerate(info.taps):
            m = -min(taps)
            for tap in taps:
                # the value tap read at step t is hist[t + m + tap]
                rev_seqs.append(flip(hists[k][m + tap: m + tap + n_run], 0))
        # a sequence may be longer than n_steps: only the consumed prefix
        # is reversed
        rev_seqs += [flip(s[:n_run], 0) for s in seqs]
        rev_seqs += [flip(k[:n_run] if as_while else k, 0) for k in key_traces]
        if window:
            # the forward step of each reverse step: n-1, ..., 0
            rev_seqs.append(flip(arange(n_run), 0))

        n_taps_total = sum(len(t) for t in info.taps)
        op = self

        def reverse_step(*args):
            # args: state cotangents, nit-sot cotangents, tap values, sequence
            # slices, the step's keys, then the carries (windows,
            # accumulators), then the non-sequences
            pos = 0

            def take(n):
                nonlocal pos
                pos += n
                return list(args[pos - n: pos])

            g_states = take(info.n_states)
            g_nits = take(info.n_nit_sot)
            tap_vals = take(n_taps_total)
            seq_vals = take(info.n_seqs)
            key_vals = take(info.n_untraced)
            t_idx = take(1)[0] if window else None
            P = take(info.n_states)
            wbars = take(info.n_non_seqs)
            ns_vals = list(args[pos:])
            if window:
                # only the last `truncate` steps run keep their cotangents,
                # and the pending windows are cut below them
                below = tm.lt(t_idx, ns_vals.pop() - truncate)
                P = [tm.switch(below, zeros_like(p), p) for p in P]
                g_states = [tm.switch(below, zeros_like(g), g) for g in g_states]
                g_nits = [tm.switch(below, zeros_like(g), g) for g in g_nits]

            memo = dict(zip(op.inner_seq_vars(), seq_vals))
            memo.update(zip([v for g in op.inner_tap_vars() for v in g], tap_vals))
            memo.update(zip(op.inner_non_seq_vars(), ns_vals))
            memo.update((v, key_from_tensor(k)) for v, k in zip(op.inner_untraced_vars(),
                                                                 key_vals))
            memo = clone_get_equiv(op.fgraph.inputs, op.fgraph.outputs, copy_inputs=False,
                                   copy_orphans=False, memo=memo)
            step_outs = [memo[o] for o in op.fgraph.outputs]
            if as_while:
                step_outs = step_outs[:-1]  # the condition takes no cotangent
            # the next keys take no cotangent
            step_outs = step_outs[:data.start] + step_outs[data.stop:]

            # a state's output takes its trace's cotangent and the head of
            # its pending window
            cots = [g_states[k] + P[k][0] for k in range(info.n_states)] + g_nits
            # outputs that are one variable share its node: their
            # cotangents add
            uniq: dict = {}
            uniq_outs = []
            for o, c in zip(step_outs, cots):
                if id(o) in uniq:
                    uniq[id(o)] = uniq[id(o)] + c
                else:
                    uniq[id(o)] = c
                    uniq_outs.append(o)
            igs = pullback(uniq_outs, seq_vals + tap_vals + ns_vals,
                           [uniq[id(o)] for o in uniq_outs],
                           disconnected_inputs="ignore", return_disconnected="zero")
            for g in igs:
                if isinstance(getattr(g, "type", None), NullType):
                    raise _NullInnerGradError(g.type.why_null)
            seq_grads = igs[: info.n_seqs]
            tap_grads = igs[info.n_seqs: info.n_seqs + n_taps_total]
            ns_grads = igs[info.n_seqs + n_taps_total:]

            # shift each window by one step and add this step's tap
            # cotangents
            new_P = []
            ti = 0
            for k, taps in enumerate(info.taps):
                m = -min(taps)
                contrib = {tap: tap_grads[ti + j] for j, tap in enumerate(taps)}
                ti += len(taps)
                rows = []
                for i in range(m):
                    row = P[k][i + 1] if i + 1 < m else zeros_like(P[k][0])
                    if -(i + 1) in contrib:
                        row = row + contrib[-(i + 1)]
                    rows.append(row)
                new_P.append(stack(rows, axis=0))
            return new_P + [wb + g for wb, g in zip(wbars, ns_grads)] + seq_grads

        P0 = [stack([zeros_like(state_traces[k][0])] * -min(taps), axis=0)
              for k, taps in enumerate(info.taps)]
        if any(not isinstance(w.type, TensorType) for w in non_seqs):
            return [grad_not_implemented(self, i, inp, "non-tensor non-sequence")
                    for i, inp in enumerate(inputs)]
        w0 = [zeros_like(w) for w in non_seqs]

        if as_while:
            # a while-scan truncates by the mask in reverse_step
            rev_n_steps = steps_done
        elif truncate != -1:
            # truncated BPTT: only the last `truncate` steps run backwards
            rev_n_steps = tm.minimum(n_steps_i, tm.cast(truncate, "int64"))
        else:
            rev_n_steps = n_steps
        try:
            rev, _ = scan(reverse_step, sequences=rev_seqs,
                          outputs_info=([dict(initial=p, taps=[-1]) for p in P0]
                                        + [dict(initial=w, taps=[-1]) for w in w0]
                                        + [None] * info.n_seqs),
                          non_sequences=non_seqs + ([steps_done] if window else []),
                          n_steps=rev_n_steps,
                          name=f"grad_of_{self.name or 'scan'}", return_list=True)
        except _NullInnerGradError as e:
            return [grad_undefined(self, i, inp, str(e) or "undefined inner gradient inside scan")
                    for i, inp in enumerate(inputs)]
        P_traces = rev[: info.n_states]
        w_traces = rev[info.n_states: info.n_states + info.n_non_seqs]
        seq_grad_traces = rev[info.n_states + info.n_non_seqs:]

        def zero_rows(template, n_rows):
            if template.type.ndim > 1:
                return alloc(zeros_like(template[0]), n_rows,
                             *[shape(template)[d] for d in range(1, template.type.ndim)])
            return alloc(tm.cast(0.0, template.type.dtype), n_rows)

        try:
            static_T = int(get_scalar_constant_value(n_steps))
        except NotScalarConstantError:
            static_T = None

        grads = [DisconnectedType()()]  # n_steps
        for i, s in enumerate(seqs):
            g_seq = flip(seq_grad_traces[i], 0)
            if as_while:
                # rows past steps_done were never read
                tail = tm.maximum(tm.cast(shape(s)[0], "int64") - steps_done,
                                  tm.cast(0, "int64"))
                grads.append(concatenate([g_seq, zero_rows(g_seq, tail)], axis=0))
                continue
            if truncate != -1:
                # zeros for the steps before the window
                pad = tm.maximum(n_steps_i - tm.cast(truncate, "int64"), tm.cast(0, "int64"))
                g_seq = concatenate([zero_rows(g_seq, pad), g_seq], axis=0)
            if not (s.type.shape[0] is not None and s.type.shape[0] == static_T):
                # rows past n_steps were never read
                tail = tm.maximum(tm.cast(shape(s)[0], "int64") - n_steps_i,
                                  tm.cast(0, "int64"))
                g_seq = concatenate([g_seq, zero_rows(g_seq, tail)], axis=0)
            grads.append(g_seq)
        for k, (init, taps) in enumerate(zip(inits, info.taps)):
            final_P = P_traces[k][-1]  # (m, *core); slot i is h^{-1-i}
            grads.append(final_P[0] if (-min(taps) == 1 and len(taps) == 1)
                         else flip(final_P, 0))
        first = 1 + info.n_seqs + info.n_states
        grads += [grad_undefined(self, first + u, inputs[first + u],
                                 "RNG state is not differentiable")
                  for u in range(info.n_untraced)]
        grads += [w_traces[j][-1] for j in range(info.n_non_seqs)]
        return grads

    def __str__(self):
        return f"Scan{{{self.name or 'scan'}, {'while' if self.info.as_while else 'for'}}}"

"""The Scan op: a loop over an inner graph.

Counterpart of ``pytensor_tpu/scan/op.py`` (ScanInfo:93, Scan:116), for
for-scans.  The state taxonomy is the JAX package's: sequences, states
with negative taps (a sit-sot is taps ``(-1,)``), untraced states (the
final value only, no trace), nit-sots and non-sequences.

The torch lowering (``link/torch/dispatch.py``) runs the loop step by
step, or, with ``config.scan__pallas`` on a CUDA device, an eligible scan
as one kernel (K2, ``link/cuda/scan_kernel.py``).  ``perform`` is the
numpy loop that constant folding evaluates.  Left out here, until
ROADMAP.md Queue 1 item 5: backprop through time (``L_op`` gives a
not-implemented gradient), while-scans (no ``as_while``; ``scan``
raises on ``until``), the structural equality the JAX package uses to
merge identical scans (a Scan here equals only itself),
``truncate_gradient`` and ``unroll``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.graph.op import HasInnerGraph, Op
from pytensor_tpu_torch.tensor.basic import (
    NotScalarConstantError,
    as_tensor_variable,
    get_scalar_constant_value,
)
from pytensor_tpu_torch.tensor.type import TensorType

NOT_PORTED = "ROADMAP.md Queue 1, item 5"


@dataclass(frozen=True)
class ScanInfo:
    """Static structure of a Scan node.

    taps[k] = negative taps of recurrent state k (sit-sot = (-1,)).
    Inner-input order:  seq slices + state taps (flattened) + untraced + non_seqs.
    Inner-output order: state outs + untraced outs + nit-sot outs.
    Outer-input order:  n_steps + seqs + state inits + untraced inits + non_seqs.
    Outer-output order: state traces + untraced finals + nit-sot traces.
    """

    n_seqs: int
    taps: tuple
    n_nit_sot: int
    n_non_seqs: int
    n_untraced: int = 0

    @property
    def n_states(self):
        return len(self.taps)


class Scan(Op, HasInnerGraph):
    def __init__(self, fgraph: FunctionGraph, info: ScanInfo, name=None):
        self.fgraph = fgraph
        self.info = info
        self.name = name
        expected_in = (info.n_seqs + sum(len(t) for t in info.taps)
                       + info.n_untraced + info.n_non_seqs)
        expected_out = info.n_states + info.n_untraced + info.n_nit_sot
        if len(fgraph.inputs) != expected_in:
            raise ValueError(
                f"Scan inner graph has {len(fgraph.inputs)} inputs, expected {expected_in}")
        if len(fgraph.outputs) != expected_out:
            raise ValueError(
                f"Scan inner graph has {len(fgraph.outputs)} outputs, expected {expected_out}")

    def __eq__(self, other):
        return self is other

    def __hash__(self):
        return id(self)

    def clone(self):
        # the inner graph is never changed in place: rewrites build new ops
        return self

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
        return res

    def connection_pattern(self, node):
        # every input but n_steps may affect every output
        return [[False] * len(node.outputs)] + [[True] * len(node.outputs)
                                                for _ in node.inputs[1:]]

    def L_op(self, inputs, outputs, output_grads):
        from pytensor_tpu_torch.gradient import grad_not_implemented

        why = f"backprop through time is not ported yet ({NOT_PORTED})"
        return [grad_not_implemented(self, i, inp, why) for i, inp in enumerate(inputs)]

    def __str__(self):
        return f"Scan{{{self.name or 'scan'}, for}}"

"""train_loop: compile K update iterations into one loop.

Counterpart of ``pytensor_tpu/compile/train.py:22 train_loop``, ported
whole.  A driver that calls ``f()`` once a step pays the host's cost of a
call every step.  ``train_loop`` rewrites the (outputs, updates) pair into
a Scan over the update body: the shared state threads through the loop's
carry, the K steps are one call, and the shared variables receive the
final state exactly as K separate calls would have left them.  On a CUDA
device the Scan runs as K2 when it is eligible (``config.scan__pallas``),
else as the step loop of ``link/torch/dispatch.py scan_loop``, and the
whole call, K steps included, is one CUDA graph (``TorchLinker``).

Semantics: ``g = train_loop(inputs, outputs, updates, n_steps=K,
device=d)``; ``g(*args)`` equals ``[f(*args) for _ in range(K)][-1]``
where ``f = function(inputs, outputs, updates=updates, device=d)``: the
same inputs every iteration, the outputs of the last iteration (computed
against the pre-update state of that iteration, like the plain call).
"""

from __future__ import annotations


def train_loop(inputs, outputs=None, updates=None, *, n_steps, mode=None, name=None,
               device, **kwargs):
    from pytensor_tpu_torch.compile.maker import function
    from pytensor_tpu_torch.compile.sharedvalue import SharedVariable
    from pytensor_tpu_torch.graph.replace import graph_replace
    from pytensor_tpu_torch.scan.basic import scan
    from pytensor_tpu_torch.tensor.shape import specify_shape

    if not updates:
        raise ValueError("train_loop needs updates (the loop-carried state)")
    items = updates.items() if isinstance(updates, dict) else list(updates)
    shareds = []
    new_exprs = []
    for k, v in items:
        if not isinstance(k, SharedVariable):
            raise TypeError(f"update target {k} is not a shared variable")
        shareds.append(k)
        new_exprs.append(v)

    single = outputs is not None and not isinstance(outputs, (list, tuple))
    out_list = [] if outputs is None else ([outputs] if single else list(outputs))
    n_out = len(out_list)

    # Pin the loop-carried state to the current shared-value shapes.  The
    # carry of a loop keeps its shape, so this is free, and it hands
    # shape-gated rewrites (the routed SpMV) static dims in the loop body.
    inits = []
    for s in shareds:
        dims = tuple(s.get_value(borrow=True).shape)
        if s.type.ndim == len(dims) and any(d is None for d in s.type.shape):
            inits.append(specify_shape(s, dims))
        else:
            inits.append(s)

    loop_invariants = list(inputs)

    def body(*args):
        state = args[: len(shareds)]
        invars = args[len(shareds):]
        mapping = dict(zip(shareds, state))
        mapping.update(zip(loop_invariants, invars))
        outs = [graph_replace(o, mapping) for o in out_list]
        new_state = [graph_replace(e, mapping) for e in new_exprs]
        return tuple(new_state) + tuple(outs)

    res, inner_updates = scan(body, outputs_info=inits + [None] * n_out,
                              non_sequences=loop_invariants, n_steps=n_steps,
                              name=name or "train_loop")
    if inner_updates:
        raise NotImplementedError(
            "train_loop over a body with implicit (RNG) updates: thread the rng as an "
            "explicit update instead")
    if not isinstance(res, (list, tuple)):
        res = [res]
    state_traces = res[: len(shareds)]
    out_traces = res[len(shareds):]
    final_updates = [(s, tr[-1]) for s, tr in zip(shareds, state_traces)]
    final_outs = [tr[-1] for tr in out_traces]
    return function(inputs, (final_outs[0] if single else final_outs) if n_out else None,
                    updates=final_updates, mode=mode, name=name, device=device, **kwargs)

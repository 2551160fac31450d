"""Graph rebuilding for function compilation.

Counterpart of ``pytensor_tpu/compile/rebuild.py:17
rebuild_collect_shared``: clone a user graph, and collect the shared
variables it reads and their updates, with the default update of each
shared variable that the caller's updates do not name (``:60``; only
RNG keys have one, a RandomStream's next key), unless
``no_default_updates``.  Its ``replace`` (givens) is left out:
``function`` applies the givens first, and keeps the graph they give for
``Function.copy`` and pickling.
"""

from __future__ import annotations

from pytensor_tpu_torch.compile.sharedvalue import SharedVariable
from pytensor_tpu_torch.graph.basic import Variable, clone_get_equiv
from pytensor_tpu_torch.graph.traversal import graph_inputs


def rebuild_collect_shared(outputs, inputs=None, updates=None, no_default_updates=False):
    """Returns ``(inputs, outputs, [clone_map, shared_inputs, updates])``:
    the cloned explicit inputs followed by the cloned shared inputs, the
    cloned outputs, and ``{shared variable: cloned update value}``."""
    one = isinstance(outputs, Variable)
    outputs_list = [outputs] if one else list(outputs or [])
    inputs = list(inputs or [])
    update_items = list(updates.items()) if isinstance(updates, dict) else list(updates or [])

    shared_inputs: list[SharedVariable] = []
    seen = set()

    def discover(vs):
        for v in graph_inputs(vs):
            if isinstance(v, SharedVariable) and v not in seen:
                seen.add(v)
                shared_inputs.append(v)

    exprs = outputs_list + [u for _, u in update_items]
    if exprs:
        discover(exprs)
    for k, _ in update_items:
        if k not in seen:
            seen.add(k)
            shared_inputs.append(k)
    shared_updates = dict(update_items)
    # default updates, to a fixpoint: a default update may read more shared
    # variables
    k = 0
    while k < len(shared_inputs):
        sv = shared_inputs[k]
        k += 1
        du = getattr(sv, "default_update", None)
        if du is not None and sv not in shared_updates and not no_default_updates:
            shared_updates[sv] = sv.type.filter_variable(du)
            discover([du])
    exprs = outputs_list + list(shared_updates.values())
    all_inputs = inputs + shared_inputs
    memo = clone_get_equiv(all_inputs, exprs, copy_inputs=True, copy_orphans=False)
    cloned_inputs = [memo.get(i, i) for i in all_inputs]
    cloned_outputs = [memo.get(o, o) for o in outputs_list]
    cloned_updates = {k: memo.get(v, v) for k, v in shared_updates.items()}
    cloned_out = cloned_outputs[0] if one and cloned_outputs else cloned_outputs
    return cloned_inputs, cloned_out, [memo, shared_inputs, cloned_updates]

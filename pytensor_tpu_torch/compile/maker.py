"""``function``: compile a graph into a callable.

Counterpart of ``pytensor_tpu/compile/maker.py:33 function``: apply givens,
collect shared variables and updates (``compile/rebuild.py``), clone into
a FunctionGraph whose outputs are the user's outputs followed by the
update values, rewrite it with the mode's query, link it for torch on an
explicit ``device`` (``TorchLinker``: one CUDA graph per input signature
on a card, with ``config.xla__jit``) and wrap it in a ``Function``
(``compile/executor.py``).

The device is an argument, never guessed: every shared variable the
graph reads must hold its tensor there, or ``function`` raises.  A shared
variable with a ``default_update`` (an RNG key of a RandomStream) is
updated with it on every call unless the caller's updates name it or
``no_default_updates`` leaves it out (``pytensor_tpu/compile/maker.py:146-147``).
Left out: ``rebuild_strict``,
``allow_input_downcast``, ``profile``, ``on_unused_input`` (an unused
input always raises), ``In(update=...)``, pickling, ``Function.copy``
and the compile-time records.
"""

from __future__ import annotations

from typing import Sequence

from pytensor_tpu_torch.compile.io import SymbolicInput, SymbolicOutput
from pytensor_tpu_torch.compile.mode import get_mode
from pytensor_tpu_torch.compile.rebuild import rebuild_collect_shared
from pytensor_tpu_torch.compile.sharedvalue import SharedVariable
from pytensor_tpu_torch.graph.basic import Variable
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.graph.traversal import graph_inputs


class UnusedInputError(Exception):
    pass


def function(inputs: Sequence, outputs=None, mode=None, updates=None, givens=None,
             no_default_updates=False, name: str | None = None,
             trust_input: bool = False, *, device):
    """Compile a callable from graph inputs to outputs on ``device``.

    ``updates`` maps shared variables to new values (a dict or a list of
    pairs); each call writes them into the shared tensors in place, after
    the outputs are computed.  ``givens`` substitutes variables of the
    graph before it is compiled.  With ``trust_input`` the call skips the
    checks and conversions of its explicit inputs: they must already be
    tensors of the right dtype and shape on ``device``.
    """
    from pytensor_tpu_torch.compile.executor import Function
    from pytensor_tpu_torch.link.torch.convert import resolve_device
    from pytensor_tpu_torch.link.torch.linker import TorchLinker

    device = resolve_device(device)
    if isinstance(inputs, (Variable, SymbolicInput)):
        inputs = [inputs]
    explicit = []
    for i in inputs:
        v = i.variable if isinstance(i, SymbolicInput) else i
        if isinstance(v, SharedVariable):
            raise TypeError("Shared variables must not be passed as explicit inputs; "
                            "they are implicit.")
        if not isinstance(v, Variable):
            raise TypeError(f"function inputs must be Variables, got {type(v)}")
        explicit.append(v)

    unpack_single = isinstance(outputs, (Variable, SymbolicOutput))
    if outputs is None:
        outputs_list = []
    else:
        outs = [outputs] if unpack_single else list(outputs)
        outputs_list = [o.variable if isinstance(o, SymbolicOutput) else o for o in outs]

    update_pairs = []
    if updates is not None:
        seen = set()
        for k, v in (updates.items() if isinstance(updates, dict) else list(updates)):
            if not isinstance(k, SharedVariable):
                raise TypeError(f"update target {k} is not a shared variable")
            if k in seen:
                raise ValueError(f"this shared variable is updated twice: {k}")
            seen.add(k)
            update_pairs.append((k, k.type.filter_variable(v)))

    all_inputs, fg_outputs, (_, shared_vars, cloned_updates) = rebuild_collect_shared(
        outputs_list, explicit, replace=givens, updates=update_pairs,
        no_default_updates=no_default_updates)
    targets = list(cloned_updates)
    fg_outputs = list(fg_outputs) + [cloned_updates[k] for k in targets]

    used = set(graph_inputs(fg_outputs)) if fg_outputs else set()
    for var, cloned in zip(explicit, all_inputs):
        if cloned not in used:
            raise UnusedInputError(f"function input {var} is unused")
    for sv in shared_vars:
        if sv.device != device:
            raise ValueError(f"shared variable {sv} holds a tensor on {sv.device}; "
                             f"the function is for {device}")

    fgraph = FunctionGraph(all_inputs, fg_outputs, clone=False)
    get_mode(mode).optimizer.rewrite(fgraph)
    return Function(TorchLinker.make_torch_fn(fgraph, device, trust_input=trust_input), fgraph,
                    n_explicit=len(explicit), shared_vars=shared_vars, update_targets=targets,
                    n_outputs=len(outputs_list), unpack_single=unpack_single, name=name,
                    device=device)

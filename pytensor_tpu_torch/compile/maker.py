"""``function``: compile a graph into a callable.

Counterpart of ``pytensor_tpu/compile/maker.py:33 function``, whole: apply
givens, collect shared variables and updates (``compile/rebuild.py``),
clone into a FunctionGraph whose outputs are the user's outputs followed
by the update values, rewrite it with the mode's query, link it on an
explicit ``device`` with the mode's linker (``"torch"``: one CUDA graph per
input signature on a card, with ``config.xla__jit``; ``"py"``: the eager
plan) and wrap it in a ``Function`` (``compile/executor.py``).

The device is an argument, never guessed: every shared variable the
graph reads must hold its tensor there, or ``function`` raises.  A shared
variable with a ``default_update`` (an RNG key of a RandomStream) is
updated with it on every call unless the caller's updates name it or
``no_default_updates`` leaves it out (``pytensor_tpu/compile/maker.py:146-147``).
``In(shared, update=u)`` adds ``u`` to the updates and leaves the
variable implicit; the JAX package also counts it as an explicit input
whose value it never reads.  ``rebuild_strict`` is accepted and changes
nothing, as in the JAX package: a given is converted to the replaced
variable's type (``filter_variable``) or refused.  The function records
what made it (``_spec``), which ``Function.copy`` and pickling rebuild
from, with the flags the rewrites and the linker read (``LINK_FLAGS``:
a chain made under ``scan__pallas`` is one K2 launch when loaded too), and
its compile and rewrite seconds.
"""

from __future__ import annotations

import time
import warnings
from typing import Sequence

from pytensor_tpu_torch.compile.io import In, SymbolicInput, SymbolicOutput
from pytensor_tpu_torch.compile.mode import get_mode
from pytensor_tpu_torch.compile.rebuild import rebuild_collect_shared
from pytensor_tpu_torch.compile.sharedvalue import SharedVariable
from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.graph.basic import Variable
from pytensor_tpu_torch.graph.fg import FunctionGraph
from pytensor_tpu_torch.graph.traversal import graph_inputs


# the flags the rewrites and the linker read: a copy or a loaded function
# is made under the values its original was made under
LINK_FLAGS = ("scan__pallas", "sparse__routed_spmv", "xla__jit")


class UnusedInputError(Exception):
    pass


def _update_pairs(updates, seen):
    pairs = []
    for k, v in (updates.items() if isinstance(updates, dict) else list(updates or ())):
        if not isinstance(k, SharedVariable):
            raise TypeError(f"update target {k} is not a shared variable")
        if k in seen:
            raise ValueError(f"this shared variable is updated twice: {k}")
        seen.add(k)
        pairs.append((k, k.type.filter_variable(v)))
    return pairs


def function(inputs: Sequence, outputs=None, mode=None, updates=None, givens=None,
             no_default_updates=False, name: str | None = None,
             rebuild_strict: bool = True, allow_input_downcast: bool | None = None,
             profile=None, on_unused_input: str = "raise", trust_input: bool = False,
             *, device):
    """Compile a callable from graph inputs to outputs on ``device``.

    ``updates`` maps shared variables to new values (a dict or a list of
    pairs); each call writes them into the shared tensors in place, after
    the outputs are computed.  ``givens`` substitutes variables of the
    graph before it is compiled.  An input given as ``In`` may carry a
    name, a default value, ``strict`` and ``allow_downcast``
    (``allow_input_downcast`` is the default of the others).  An input
    the outputs do not read raises ``UnusedInputError``, or warns, or
    passes, as ``on_unused_input`` says.  With ``profile`` (or
    ``config.profile``) the function keeps a ``ProfileStats``
    (``compile/debug/profiling.py``).  With ``trust_input`` the call skips
    the checks and conversions of its explicit inputs: they must already
    be tensors of the right dtype and shape on ``device``.
    """
    from pytensor_tpu_torch.compile.executor import Function
    from pytensor_tpu_torch.graph.replace import graph_replace
    from pytensor_tpu_torch.link.torch.convert import resolve_device

    t0 = time.perf_counter()
    device = resolve_device(device)
    if profile is None:
        profile = config.profile
    if on_unused_input not in ("raise", "warn", "ignore"):
        raise ValueError(f"on_unused_input must be 'raise', 'warn' or 'ignore', "
                         f"not {on_unused_input!r}")
    if isinstance(inputs, (Variable, SymbolicInput)):
        inputs = [inputs]
    wrapped: list[SymbolicInput] = []
    shared_ins = []
    for i in inputs:
        if isinstance(i, SymbolicInput):
            if isinstance(i.variable, SharedVariable):
                if i.update is None:
                    raise TypeError("In(shared) without an update: a shared variable is "
                                    "an implicit input already")
                shared_ins.append(i)
                continue
            if i.update is not None:
                raise NotImplementedError(
                    "In(update=...) on a variable that is not shared: pass updates= instead")
            wrapped.append(i)
        elif isinstance(i, SharedVariable):
            raise TypeError("Shared variables must not be passed as explicit inputs; "
                            "they are implicit.")
        elif isinstance(i, Variable):
            wrapped.append(In(i, allow_downcast=allow_input_downcast))
        else:
            raise TypeError(f"function inputs must be Variables, got {type(i)}")
    explicit = [wi.variable for wi in wrapped]

    unpack_single = isinstance(outputs, (Variable, SymbolicOutput))
    if outputs is None:
        outputs_list = []
    else:
        outs = [outputs] if unpack_single else list(outputs)
        outputs_list = [o.variable if isinstance(o, SymbolicOutput) else o for o in outs]

    seen: set = set()
    update_pairs = _update_pairs(updates, seen)
    update_pairs += _update_pairs([(i.variable, i.update) for i in shared_ins], seen)
    if givens:
        exprs = outputs_list + [v for _, v in update_pairs]
        if exprs:
            exprs = graph_replace(exprs, givens, strict=False)
        outputs_list = exprs[: len(outputs_list)]
        update_pairs = [(k, e) for (k, _), e in zip(update_pairs, exprs[len(outputs_list):])]

    all_inputs, fg_outputs, (_, shared_vars, cloned_updates) = rebuild_collect_shared(
        outputs_list, explicit, updates=update_pairs, no_default_updates=no_default_updates)
    targets = list(cloned_updates)
    fg_outputs = list(fg_outputs) + [cloned_updates[k] for k in targets]

    used = set(graph_inputs(fg_outputs)) if fg_outputs else set()
    for var, cloned in zip(explicit, all_inputs):
        if cloned not in used:
            if on_unused_input == "raise":
                raise UnusedInputError(f"function input {var} is unused; pass "
                                       "on_unused_input='ignore' to allow it")
            if on_unused_input == "warn":
                warnings.warn(f"unused input {var}", stacklevel=2)
    for sv in shared_vars:
        if sv.device != device:
            raise ValueError(f"shared variable {sv} holds a tensor on {sv.device}; "
                             f"the function is for {device}")

    n_out = len(outputs_list)
    update_mapping = {n_out + k: len(explicit) + shared_vars.index(sv)
                      for k, sv in enumerate(targets)}
    fgraph = FunctionGraph(all_inputs, fg_outputs, clone=False, update_mapping=update_mapping)
    t_graph = time.perf_counter()
    mode_obj = get_mode(mode)
    rewrite_profile = mode_obj.optimizer.rewrite(fgraph)
    t_rewrite = time.perf_counter()
    linked = mode_obj.make_linker().make_torch_fn(fgraph, device, trust_input=trust_input)
    fn = Function(linked, fgraph, wrapped, shared_vars, targets, n_out, unpack_single,
                  name=name, device=device, trust_input=trust_input, mode=mode_obj)
    fn._spec = dict(inputs=wrapped, outputs=outputs_list, updates=update_pairs,
                    no_default_updates=no_default_updates, unpack_single=unpack_single,
                    name=name, trust_input=trust_input, mode=mode_obj,
                    flags={k: getattr(config, k) for k in LINK_FLAGS})
    fn.compile_time = time.perf_counter() - t0
    fn.rewrite_time = t_rewrite - t_graph
    fn.rewrite_profile = rewrite_profile
    if profile:
        from pytensor_tpu_torch.compile.debug.profiling import profile_function

        profile_function(fn)
    return fn


def predict_function_backend(mode=None) -> str:
    """The name of the linker ``function`` would take for ``mode``."""
    m = get_mode(mode)
    return m.linker if isinstance(m.linker, str) else type(m.linker).__name__


class FunctionMaker:
    """What a function is made from (PyTensor's compile/maker.py:264): the
    build itself is ``function()``; ``create`` calls it again."""

    def __init__(self, inputs, outputs, mode=None, updates=None, givens=None,
                 name=None, *, device, **kwargs):
        self.inputs = inputs
        self.outputs = outputs
        self.mode = mode
        self.updates = updates
        self.givens = givens
        self.name = name
        self.device = device
        self.kwargs = kwargs

    def create(self):
        return function(self.inputs, self.outputs, mode=self.mode, updates=self.updates,
                        givens=self.givens, name=self.name, device=self.device, **self.kwargs)

"""Function: the compiled callable.

Counterpart of ``pytensor_tpu/compile/executor.py:28 Function``, whole:
fill the inputs (by position, by name, or from an ``In``'s ``value``),
filter them by each input's ``strict`` and ``allow_downcast``, run the
linked graph on them and the shared tensors, write the update values into
the shared tensors in place, return the outputs.  ``copy`` rebuilds the
function from what made it (``_spec``), with its own shared variables
unless ``share_memory``; a pickle holds the same record and loading it
links the function again, for the device it was made for.

The torch lowerings return views where numpy would (``Subtensor``,
``Reshape``, ``DimShuffle``), and the identity returns the tensor itself,
so an output may share memory with a shared tensor.  Such an output is
copied, as the JAX package's ``DeepCopyOp`` copies it: an output never
changes under the caller, whichever function updates the shared
variable later (``Out(borrow=True)`` changes nothing there).  An update
value that shares memory with a shared tensor this call updates is
copied before any update is written, so a swap of two shared variables
reads both old values.  Other values are returned as they are, but a
sparse output: the JAX package returns a BCOO on its device, the port a
torch sparse compressed tensor in the output's format (csr or csc) on
the function's device.
``dprint`` prints the rewritten graph (``printing.py``).
"""

from __future__ import annotations

import torch

from pytensor_tpu_torch.config import config
from pytensor_tpu_torch.link.torch.convert import (
    CSR,
    UNSIGNED,
    csr_as_torch_sparse,
    torch_dtype,
    unheld,
)


class Function:
    def __init__(self, linked, fgraph, explicit_inputs, shared_vars, update_targets,
                 n_outputs, unpack_single, name, device, trust_input=False, mode=None):
        self.linked = linked
        self.fgraph = fgraph
        self.maker = self  # PyTensor's f.maker.fgraph
        self.explicit_inputs = list(explicit_inputs)
        self.shared_vars = list(shared_vars)
        self.update_targets = list(update_targets)
        self.n_outputs = n_outputs
        self.unpack_single = unpack_single
        self.name = name
        self.device = device
        self.trust_input = trust_input
        self.mode = mode
        self.profile = None
        self.call_count = 0
        self.compile_time = 0.0
        self.rewrite_time = 0.0
        self._input_names = {wi.name: k for k, wi in enumerate(self.explicit_inputs)
                             if wi.name}

    @property
    def n_explicit(self):
        return len(self.explicit_inputs)

    def __contains__(self, item):
        return item in self._input_names

    def _fill(self, args, kwargs):
        """The positional values with the keywords and defaults put in."""
        n = self.n_explicit
        if len(args) > n:
            raise TypeError(f"expected {n} inputs, got {len(args)}")
        args = list(args) + [None] * (n - len(args))
        for k, v in kwargs.items():
            if k not in self._input_names:
                raise TypeError(f"unknown input name {k!r}")
            args[self._input_names[k]] = v
        for k, (a, wi) in enumerate(zip(args, self.explicit_inputs)):
            if a is None and wi.value is not None:
                args[k] = wi.value
        missing = [wi.variable for a, wi in zip(args, self.explicit_inputs) if a is None]
        if missing:
            raise TypeError(f"missing input value(s) for {missing} (no default)")
        return args

    @staticmethod
    def _filter(value, wi):
        """``value`` filtered as ``wi`` asks (``strict``, ``allow_downcast``);
        the linked plan converts what is left to a tensor."""
        t = wi.variable.type
        try:
            if isinstance(value, torch.Tensor):
                if wi.allow_downcast and value.dtype != torch_dtype(t.dtype):
                    return value.to(torch_dtype(t.dtype))
                return value
            return t.filter(value, strict=wi.strict, allow_downcast=wi.allow_downcast)
        except Exception as e:
            raise TypeError(f"Bad input argument for {wi.variable}: {e}") from e

    def __call__(self, *args, **kwargs):
        if kwargs or len(args) != self.n_explicit:
            args = self._fill(args, kwargs)
        if not self.trust_input:
            args = [self._filter(a, wi) if wi.strict or wi.allow_downcast is not None else a
                    for a, wi in zip(args, self.explicit_inputs)]
        shared = [sv.storage[0] for sv in self.shared_vars]
        stats = self.profile
        if stats is None:
            results = list(self.linked(*args, *shared))
        else:
            results = list(stats.timed_call(self.linked, args, shared))
        held = set().union(*map(_storages, shared))
        outputs = [_copied(r, held) for r in results[: self.n_outputs]]
        if self.update_targets:
            updated = {sv.storage[0].untyped_storage().data_ptr()
                       for sv in self.update_targets}
            values = [_copied(r, updated) for r in results[self.n_outputs:]]
            for sv, value in zip(self.update_targets, values):
                if value.shape != sv.storage[0].shape:
                    # copy_ would broadcast; an update keeps the shape
                    raise ValueError(f"update of {sv} has shape {tuple(value.shape)}, "
                                     f"the shared tensor {tuple(sv.storage[0].shape)}")
                sv.storage[0].copy_(value)
        self.call_count += 1
        # the unsigned dtypes above uint8 leave in torch's dtype of their
        # width; a sparse value as a torch sparse tensor in its graph format
        outputs = [_returned(r, o.type) for r, o in zip(outputs, self.fgraph.outputs)]
        if self.unpack_single:
            return outputs[0]
        return outputs

    def copy(self, share_memory=False, swap=None, delete_updates=False, name=None):
        """The function made again from what made it.

        ``swap`` maps shared variables of the graph to others that take
        their place.  Without ``share_memory`` every other shared variable
        is replaced by a new one holding a copy of its value, on the same
        device, so the copy's updates move only its own tensors; with it the
        copy reads and updates the original's.  ``delete_updates`` drops the
        updates (default updates too).
        """
        from pytensor_tpu_torch.compile.maker import function
        from pytensor_tpu_torch.graph.replace import graph_replace

        spec = self._spec
        outputs = list(spec["outputs"])
        updates = [] if delete_updates else list(spec["updates"])
        swap = dict(swap or {})
        if not share_memory:
            fresh = {sv: sv.snapshot() for sv in self.shared_vars if sv not in swap}
            swap = {**fresh, **swap}
            for old, new in fresh.items():
                if old.default_update is not None:
                    new.default_update = graph_replace(old.default_update, swap, strict=False)
        if swap:
            exprs = outputs + [v for _, v in updates]
            if exprs:
                exprs = graph_replace(exprs, swap, strict=False)
            outputs = exprs[: len(outputs)]
            updates = [(swap.get(k, k), e) for (k, _), e in zip(updates, exprs[len(outputs):])]
        out_arg = outputs[0] if spec["unpack_single"] else outputs
        with config.change_flags(**spec["flags"]):
            return function(spec["inputs"], out_arg, mode=spec["mode"], updates=updates,
                            no_default_updates=delete_updates or spec["no_default_updates"],
                            name=name or spec["name"], trust_input=spec["trust_input"],
                            on_unused_input="ignore", device=self.device)

    def __reduce__(self):
        spec = self._spec
        payload = {**spec, "device": str(self.device)}
        return (_rebuild_function, (payload,))

    def free(self):
        """Drop the captured CUDA graphs; the next call captures again."""
        graphs = getattr(self.linked, "graphs", None)
        if graphs is not None:
            graphs.clear()

    def dprint(self, **kwargs):
        from pytensor_tpu_torch.printing import debugprint

        return debugprint(self.fgraph, **kwargs)

    def get_shared(self):
        return list(self.shared_vars)

    def __str__(self):
        return f"Function({self.name or 'anonymous'}, device={self.device})"


def _storages(value) -> set:
    """The storages of a tensor, of a sparse triple's three or of a typed
    list's elements."""
    if isinstance(value, list):
        return set().union(*map(_storages, value))
    if isinstance(value, CSR):
        return {t.untyped_storage().data_ptr() for t in (value.indptr, value.indices, value.data)}
    return {value.untyped_storage().data_ptr()}


def _copied(value, held):
    """``value``, or a copy of it where it shares storage with one of the
    tensors ``held`` names (a typed list element by element, a sparse
    triple whole)."""
    if isinstance(value, list):
        return [_copied(v, held) for v in value]
    if not _storages(value) & held:
        return value
    if isinstance(value, CSR):
        return CSR(value.indptr.clone(), value.indices.clone(), value.data.clone(), value.shape)
    return value.clone()


def _returned(value, ty):
    """An output as the caller gets it: a sparse value as a torch sparse
    compressed tensor in its graph format (``convert.py
    csr_as_torch_sparse``), an unsigned dtype above uint8 as numpy's."""
    if isinstance(value, CSR):
        return csr_as_torch_sparse(value, ty.format)
    if getattr(ty, "dtype", None) in UNSIGNED:
        return unheld(value, ty.dtype)
    return value


def _rebuild_function(payload, mode=None, device=None):
    """A pickled function linked again: for its recorded device unless
    ``device`` is given (a recorded CUDA device where there is none
    raises), with its recorded mode unless ``mode`` is given."""
    from pytensor_tpu_torch.compile.maker import function

    out_arg = payload["outputs"][0] if payload["unpack_single"] else payload["outputs"]
    with config.change_flags(**payload["flags"]):
        return function(payload["inputs"], out_arg, mode=mode or payload["mode"],
                        updates=payload["updates"],
                        no_default_updates=payload["no_default_updates"], name=payload["name"],
                        trust_input=payload["trust_input"], on_unused_input="ignore",
                        device=device or payload["device"])

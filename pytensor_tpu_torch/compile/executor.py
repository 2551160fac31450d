"""Function: the compiled callable.

Counterpart of ``pytensor_tpu/compile/executor.py:28 Function``: run the
linked graph on the explicit inputs and the shared tensors, write the
update values into the shared tensors in place, return the outputs.

The torch lowerings return views where numpy would (``Subtensor``,
``Reshape``, ``DimShuffle``), and the identity returns the tensor itself,
so an output may share memory with a shared tensor.  Such an output is
copied, as the JAX package's ``DeepCopyOp`` copies it: an output never
changes under the caller, whichever function updates the shared
variable later.  An update value that shares memory with a shared tensor
this call updates is copied before any update is written, so a swap of
two shared variables reads both old values.  Other values are returned
as they are.
"""

from __future__ import annotations

from pytensor_tpu_torch.link.torch.convert import UNSIGNED, unheld


class Function:
    def __init__(self, linked, fgraph, n_explicit, shared_vars, update_targets,
                 n_outputs, unpack_single, name, device):
        self.linked = linked
        self.fgraph = fgraph
        self.n_explicit = n_explicit
        self.shared_vars = list(shared_vars)
        self.update_targets = list(update_targets)
        self.n_outputs = n_outputs
        self.unpack_single = unpack_single
        self.name = name
        self.device = device

    def __call__(self, *args):
        if len(args) != self.n_explicit:
            raise TypeError(f"expected {self.n_explicit} inputs, got {len(args)}")
        shared = [sv.storage[0] for sv in self.shared_vars]
        results = list(self.linked(*args, *shared))
        held = {t.untyped_storage().data_ptr() for t in shared}
        outputs = [r.clone() if r.untyped_storage().data_ptr() in held else r
                   for r in results[: self.n_outputs]]
        if self.update_targets:
            updated = {sv.storage[0].untyped_storage().data_ptr()
                       for sv in self.update_targets}
            values = [r.clone() if r.untyped_storage().data_ptr() in updated else r
                      for r in results[self.n_outputs:]]
            for sv, value in zip(self.update_targets, values):
                if value.shape != sv.storage[0].shape:
                    # copy_ would broadcast; an update keeps the shape
                    raise ValueError(f"update of {sv} has shape {tuple(value.shape)}, "
                                     f"the shared tensor {tuple(sv.storage[0].shape)}")
                sv.storage[0].copy_(value)
        # the unsigned dtypes above uint8 leave in torch's dtype of their width
        outputs = [unheld(r, o.type.dtype) if o.type.dtype in UNSIGNED else r
                   for r, o in zip(outputs, self.fgraph.outputs)]
        if self.unpack_single:
            return outputs[0]
        return outputs

    def __str__(self):
        return f"Function({self.name or 'anonymous'}, device={self.device})"

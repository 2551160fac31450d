"""HasInnerFunction: inner-graph ops whose ``perform`` runs a compiled
inner function.

Counterpart of ``pytensor_tpu/compile/inner_function.py`` (PyTensor's
compile/inner_function.py:26).  The JAX package compiles the inner graph
with its numpy oracle linker; the port compiles it with the ``"py"``
linker, unrewritten, on the device it is asked for (``fn(device)``; the
card unless the caller asks for the CPU, as every entry point of the
port), and ``perform`` runs it on the CPU, which it asks for.
"""

from __future__ import annotations

from pytensor_tpu_torch.graph.op import HasInnerGraph


class HasInnerFunction(HasInnerGraph):
    """Mixin: ``fn(device)`` compiles ``self.fgraph`` once a device."""

    _inner_fns = None

    def fn(self, device="cuda"):
        from pytensor_tpu_torch.compile.maker import function
        from pytensor_tpu_torch.compile.mode import Mode
        from pytensor_tpu_torch.link.torch.convert import resolve_device

        device = resolve_device(device)
        if self._inner_fns is None:
            self._inner_fns = {}
        if device not in self._inner_fns:
            self._inner_fns[device] = function(
                list(self.fgraph.inputs), list(self.fgraph.outputs),
                mode=Mode(linker="py", optimizer="None"), on_unused_input="ignore",
                device=device)
        return self._inner_fns[device]

    def perform(self, node, inputs, output_storage):
        from pytensor_tpu_torch.link.torch.convert import to_numpy

        outs = self.fn("cpu")(*inputs)
        if not isinstance(outs, (list, tuple)):
            outs = [outs]
        for s, v in zip(output_storage, outs):
            s[0] = to_numpy(v)

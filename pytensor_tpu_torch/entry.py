"""The port's entry point: the radon logp+dlogp function on one device.

Counterpart of ``__graft_entry__.entry()``: build the hierarchical radon
graph in float32 with its gradient, wrap it in a FunctionGraph, rewrite
it with FAST_RUN and link it, here for torch on ``device``: on a card a
``CapturedFunction`` (one CUDA graph per input signature) unless
``config.xla__jit`` is off.
"""

from __future__ import annotations

import numpy as np


def entry(device="cuda"):
    """Return ``(fn, (theta0,))``: ``fn(theta) -> (logp, dlogp)``, on the
    card unless ``device`` names another; CUDA without a card raises."""
    from pytensor_tpu_torch.compile.mode import get_mode
    from pytensor_tpu_torch.graph.fg import FunctionGraph
    from pytensor_tpu_torch.link.torch.convert import as_torch
    from pytensor_tpu_torch.link.torch.linker import TorchLinker
    from pytensor_tpu_torch.models.radon import make_radon_graphs

    inputs, outputs, n_params = make_radon_graphs(dtype="float32")
    fgraph = FunctionGraph(inputs, outputs, clone=True)
    get_mode("FAST_RUN").optimizer.rewrite(fgraph)
    fn = TorchLinker.make_torch_fn(fgraph, device)
    theta0 = as_torch(np.zeros(n_params, dtype="float32"), device)
    return fn, (theta0,)

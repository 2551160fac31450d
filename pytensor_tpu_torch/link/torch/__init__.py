"""The torch linker: a rewritten FunctionGraph run node by node in eager
torch on an explicit device, and on a card captured as one CUDA graph per
input signature."""

from pytensor_tpu_torch.link.torch.convert import as_torch  # noqa: F401
from pytensor_tpu_torch.link.torch.linker import TorchLinker, fgraph_to_torch  # noqa: F401

"""Graph core: Variable/Apply/Constant, the Op and Type protocols,
FunctionGraph with Features, traversal and replacement utilities.

Counterpart of ``pytensor_tpu/graph/`` (PyTensor's graph/).
"""

from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable, clone  # noqa: F401
from pytensor_tpu_torch.graph.fg import FunctionGraph  # noqa: F401
from pytensor_tpu_torch.graph.op import Op  # noqa: F401
from pytensor_tpu_torch.graph.replace import clone_replace, graph_replace  # noqa: F401
from pytensor_tpu_torch.graph.type import Type  # noqa: F401

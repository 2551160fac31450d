"""pytensor_tpu_torch: the PyTorch and CUDA port of pytensor_tpu.

The same graph IR, rewrite engine and gradient machinery as the JAX
package, with ``scan``, ``function`` and ``train_loop``, linked to eager
torch on an explicit device; fused elementwise chains, whole for-scans,
the radon leapfrog chain and the constant-pattern CSR matvec run as
hand-written Hopper kernels (``tensor/fused_kernel.py``,
``link/cuda/scan_kernel.py``, ``csrc/radon_leapfrog.cu``,
``csrc/spmv_csr.cu``).  ``pytensor_tpu_torch.sparse`` holds the sparse
ops.  This package imports torch and never jax
or pytensor_tpu.
"""

from pytensor_tpu_torch.config import config  # noqa: F401

__version__ = "0.1.0"

from pytensor_tpu_torch.graph.basic import Apply, Constant, Variable  # noqa: F401
from pytensor_tpu_torch.graph.fg import FunctionGraph  # noqa: F401
from pytensor_tpu_torch.graph.op import Op  # noqa: F401
from pytensor_tpu_torch.compile.mode import FAST_COMPILE, FAST_RUN, Mode, get_mode  # noqa: F401
from pytensor_tpu_torch.compile.io import In, Out  # noqa: F401
from pytensor_tpu_torch.graph.replace import clone_replace, graph_replace, vectorize_graph  # noqa: F401,E501
from pytensor_tpu_torch.gradient import (  # noqa: F401
    Lop,
    Rop,
    grad,
    hessian,
    jacobian,
    pullback,
    pushforward,
    verify_grad,
)

import pytensor_tpu_torch.tensor as tensor  # noqa: F401

# rewrite packs register into optdb at import time
import pytensor_tpu_torch.tensor.rewriting  # noqa: F401
import pytensor_tpu_torch.assumptions  # noqa: F401  (assumption-driven rewrites)
import pytensor_tpu_torch.compile.rewriting  # noqa: F401

from pytensor_tpu_torch.compile.maker import function  # noqa: F401
from pytensor_tpu_torch.basic_symbolic import as_symbolic  # noqa: F401
from pytensor_tpu_torch.printing import debugprint, dprint, pp, pprint, pydotprint  # noqa: F401
import pytensor_tpu_torch.basic_symbolic as basic  # noqa: F401  (PyTensor's pytensor.basic)
from pytensor_tpu_torch.compile.builders import OpFromGraph  # noqa: F401
from pytensor_tpu_torch.compile.train import train_loop  # noqa: F401
from pytensor_tpu_torch.compile.sharedvalue import shared  # noqa: F401
from pytensor_tpu_torch.updates import OrderedUpdates  # noqa: F401

# bind the scan *function* after the subpackage import, so that the name
# refers to the callable, as in the JAX package
import pytensor_tpu_torch.scan  # noqa: F401,E402
from pytensor_tpu_torch.scan.basic import scan  # noqa: F401,E402
from pytensor_tpu_torch.scan.checkpoints import scan_checkpoints  # noqa: F401,E402
from pytensor_tpu_torch.scan.views import foldl, foldr  # noqa: F401,E402
from pytensor_tpu_torch.scan.views import map as scan_map  # noqa: F401,E402
from pytensor_tpu_torch.scan.views import reduce as scan_reduce  # noqa: F401,E402

map = scan_map
reduce = scan_reduce


# import the submodule eagerly, then rebind the name to the callable: a
# later `from pytensor_tpu_torch.ifelse import ...` must not shadow it back
# to the module (the import system only sets the parent attr on the
# submodule's FIRST load)
import pytensor_tpu_torch.ifelse as _ifelse_module  # noqa: E402,F401
from pytensor_tpu_torch.ifelse import ifelse  # noqa: E402,F401


def __getattr__(name):
    if name == "breakpoint":
        import pytensor_tpu_torch.breakpoint as breakpoint

        return breakpoint
    raise AttributeError(f"module pytensor_tpu_torch has no attribute {name}")

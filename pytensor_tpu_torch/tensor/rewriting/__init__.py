"""Tensor rewrite packs, registered into the global optdb on import.

The modules are imported in the JAX package's order, so that rewrites
that may match one node are tried in the same order in both packages.
"""

import pytensor_tpu_torch.tensor.rewriting.basic  # noqa: F401
import pytensor_tpu_torch.tensor.rewriting.math  # noqa: F401
import pytensor_tpu_torch.tensor.rewriting.shape  # noqa: F401
import pytensor_tpu_torch.tensor.rewriting.subtensor  # noqa: F401
import pytensor_tpu_torch.tensor.rewriting.linalg  # noqa: F401
import pytensor_tpu_torch.tensor.rewriting.special  # noqa: F401
import pytensor_tpu_torch.tensor.rewriting.blockwise  # noqa: F401

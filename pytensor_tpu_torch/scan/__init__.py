from pytensor_tpu_torch.scan.basic import scan  # noqa: F401
from pytensor_tpu_torch.scan.utils import until  # noqa: F401
from pytensor_tpu_torch.scan.checkpoints import scan_checkpoints  # noqa: F401
from pytensor_tpu_torch.scan.views import foldl, foldr, map, reduce  # noqa: F401

import pytensor_tpu_torch.scan.rewriting  # noqa: F401,E402  (registers the scan passes)

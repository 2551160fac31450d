"""The debug modes (``debugmode.py``, ``nanguardmode.py``,
``monitormode.py``), ``dump.py`` and profiling (``profiling.py``), as the
JAX package exports them."""

from pytensor_tpu_torch.compile.debug.debugmode import BadOptimization, BadThunkOutput, DebugMode
from pytensor_tpu_torch.compile.debug.monitormode import MonitorMode, detect_nan
from pytensor_tpu_torch.compile.debug.nanguardmode import NanGuardMode
from pytensor_tpu_torch.compile.debug.profiling import ProfileStats

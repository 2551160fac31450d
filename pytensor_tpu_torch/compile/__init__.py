"""The compile driver: modes and the global rewrite pipeline (``mode.py``),
``function`` (``maker.py``, ``executor.py``, ``io.py``), shared variables,
``OpFromGraph`` (``builders.py``), ``train_loop``, the aliasing contracts,
inner functions, the build locks, profiling and the debug modes
(``debug/``).  Import the modules themselves: the package imports none of
them, and gives ``MonitorMode`` and ``function_dump`` on first use, as the
JAX package exports them."""


def __getattr__(name):
    if name == "MonitorMode":
        from pytensor_tpu_torch.compile.debug.monitormode import MonitorMode

        return MonitorMode
    if name == "function_dump":
        from pytensor_tpu_torch.compile.debug.dump import dump_function

        return dump_function
    raise AttributeError(f"module {__name__} has no attribute {name}")

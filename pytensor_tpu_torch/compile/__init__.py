"""The compile driver: modes and the global rewrite pipeline (``mode.py``),
``function`` (``maker.py``, ``executor.py``, ``io.py``), shared variables,
``OpFromGraph`` (``builders.py``), ``train_loop``, the aliasing contracts,
inner functions, the build locks and profiling (``debug/profiling.py``).
Import the modules themselves: the package imports none of them."""

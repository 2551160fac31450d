"""Locks around the kernel builds.

Counterpart of ``pytensor_tpu/compile/compilelock.py`` (PyTensor's
compile/compilelock.py): ``lock_ctx`` holds an ``fcntl`` lock on a file
of a build directory, ``force_unlock`` removes the lock files nobody
holds.  ``link/cuda/build.py build_library`` takes one lock a library (a
hash of its source and flags), so that two processes building the same
library run nvcc once, while builds of other libraries, such as the
pool of ``chip_smoke.py``'s phase 2, go on beside it.  The library is
still written to a temporary name and moved into place (``os.replace``),
so that a reader never loads half a file.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path


def _default_dir() -> Path:
    from pytensor_tpu_torch.link.cuda.build import BUILD_DIR

    return BUILD_DIR


@contextlib.contextmanager
def lock_ctx(lock_dir=None, name: str = ""):
    """Hold the lock ``<lock_dir>/.lock<name>`` (``build/kernels/`` by
    default) for the ``with`` block."""
    import fcntl

    lock_dir = Path(lock_dir) if lock_dir is not None else _default_dir()
    lock_dir.mkdir(parents=True, exist_ok=True)
    with open(lock_dir / f".lock{name}", "w") as fh:
        fcntl.flock(fh, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(fh, fcntl.LOCK_UN)


def force_unlock(lock_dir=None):
    """Remove the lock files of ``lock_dir`` that no process holds."""
    import fcntl

    lock_dir = Path(lock_dir) if lock_dir is not None else _default_dir()
    for path in lock_dir.glob(".lock*"):
        try:
            fd = os.open(path, os.O_RDWR)
        except OSError:
            continue
        try:
            fcntl.flock(fd, fcntl.LOCK_EX | fcntl.LOCK_NB)
            fcntl.flock(fd, fcntl.LOCK_UN)
            os.remove(path)
        except OSError:
            pass  # held by a live process: left
        finally:
            os.close(fd)

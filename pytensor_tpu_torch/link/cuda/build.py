"""Build a CUDA source into a shared library with nvcc, and load it.

The route of the port's CUDA kernels (K1-K4): ``nvcc -gencode
arch=compute_90a,code=sm_90a -O3 -shared -Xcompiler -fPIC`` into
``build/kernels/`` (listed in ``.gitignore``), keyed by a hash of the
source and the flags, then loaded with ``ctypes``.  No fast-math flags.
The sources have a plain C interface, so a build takes seconds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

from pytensor_tpu_torch.compile.compilelock import lock_ctx

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
CSRC = Path(__file__).resolve().parents[2] / "csrc"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine "
                       "with the CUDA toolkit")


def build_library(source: str, stem: str, source_path: Path | None = None,
                  verbose: bool = False, flags=()) -> tuple[ctypes.CDLL, str]:
    """Compile ``source`` (once per hash of source and flags) and load it.

    ``source_path`` is the file to compile when the source lives in the
    repo; a generated source is written under ``build/kernels/`` first.
    ``flags`` are added to ``NVCC_FLAGS``.
    Returns ``(library, log)``: the log holds the compiler's output of
    this build (with ``verbose``, its ``-Xptxas -v`` register and
    shared-memory report), and is empty when the library was built before.
    """
    cmd_flags = [*NVCC_FLAGS, *flags]
    key = hashlib.sha256(source.encode() + " ".join(cmd_flags).encode()).hexdigest()[:16]
    lib_path = BUILD_DIR / f"lib{stem}_{key}.so"
    log = ""
    if not lib_path.exists():
        # one process builds it; another that asks for it meanwhile waits,
        # then finds it built (compile/compilelock.py)
        with lock_ctx(BUILD_DIR, f"_{stem}_{key}"):
            if not lib_path.exists():
                log = _nvcc(source, stem, key, source_path, cmd_flags, lib_path, verbose)
    return ctypes.CDLL(str(lib_path)), log


def _nvcc(source, stem, key, source_path, cmd_flags, lib_path, verbose) -> str:
    """Compile into ``lib_path`` (written to a temporary name, then moved);
    returns the compiler's output."""
    if source_path is None:
        source_path = BUILD_DIR / f"{stem}_{key}.cu"
        tmp_src = source_path.with_suffix(f".{os.getpid()}.tmp")
        tmp_src.write_text(source)
        os.replace(tmp_src, source_path)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *cmd_flags, *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(source_path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}) on {source_path}:\n{log}")
    os.replace(tmp, lib_path)
    return log


def build_csrc(stem: str, headers=(), verbose: bool = False,
               flags=()) -> tuple[ctypes.CDLL, str]:
    """``build_library`` of ``csrc/<stem>.cu``, keyed also by the ``csrc/``
    headers it includes."""
    source = CSRC / f"{stem}.cu"
    text = "".join((CSRC / h).read_text() for h in headers) + source.read_text()
    return build_library(text, stem, source, verbose, flags)

"""Build a CUDA source into a shared library with nvcc, and load it.

The route of the port's CUDA kernels (K2, K3): ``nvcc -gencode
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

BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
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
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
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
    return ctypes.CDLL(str(lib_path)), log

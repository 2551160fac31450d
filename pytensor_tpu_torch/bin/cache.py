"""pytensor-tpu-torch-cache: inspect or clear the port's kernel builds.

Counterpart of ``pytensor_tpu/bin/cache.py`` (PyTensor's only CLI,
``pytensor-cache``).  The JAX package's cache holds its host VM's build
and jax's compilation cache; the port's is ``build/kernels/``
(``link/cuda/build.py BUILD_DIR``): the libraries nvcc builds, keyed by a
hash of their source and flags, with their lock files
(``compile/compilelock.py``).  Run: ``python -m
pytensor_tpu_torch.bin.cache [list|clear|unlock]``.
"""

from __future__ import annotations

import argparse
import shutil


def _dir():
    from pytensor_tpu_torch.link.cuda.build import BUILD_DIR

    return BUILD_DIR


def list_cache():
    d = _dir()
    if not d.exists():
        print(f"kernels: {d} (empty)")
        return
    files = [f for f in d.rglob("*") if f.is_file()]
    total = sum(f.stat().st_size for f in files)
    print(f"kernels: {d} — {len(files)} files, {total / 1e6:.1f} MB")


def clear_cache():
    d = _dir()
    if d.exists():
        shutil.rmtree(d)
        print(f"cleared {d}")


def unlock():
    from pytensor_tpu_torch.compile.compilelock import force_unlock

    d = _dir()
    locks = list(d.glob(".lock*")) if d.exists() else []
    if locks:
        force_unlock(d)
    for lock in locks:
        if not lock.exists():
            print(f"removed {lock}")


def main(argv=None):
    p = argparse.ArgumentParser(prog="pytensor-tpu-torch-cache")
    p.add_argument("action", choices=["list", "clear", "unlock"], nargs="?", default="list")
    args = p.parse_args(argv)
    {"list": list_cache, "clear": clear_cache, "unlock": unlock}[args.action]()


if __name__ == "__main__":
    main()

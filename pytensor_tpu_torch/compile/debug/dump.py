"""Dump a compiled Function's graphs for offline inspection.

Counterpart of ``pytensor_tpu/compile/debug/dump.py`` (PyTensor's
compile/debug/dump.py): the signature, the rewritten graph (debugprint),
the profile where the function keeps one, and with ``hlo=True`` what the
function runs below the graph.  The JAX package prints the lowered HLO
text of its jitted executable there; the port's counterpart is the
generated CUDA source of each of its kernels that the graph holds: each
``FusedElemwise`` node's K1 source (``tensor/fused_kernel.py``) and each
scan that K2 takes under ``config.scan__pallas``
(``link/cuda/scan_kernel.py``).  The sources are generated here, on any
device; nothing is built.
"""

from __future__ import annotations

import io


def _linker_name(fn) -> str:
    linker = getattr(fn.mode, "linker", None)
    if linker is None or isinstance(linker, str):
        return str(linker)
    return linker.__name__ if isinstance(linker, type) else type(linker).__name__


def kernel_sources(fn):
    """``[(node, kind, CUDA source)]`` of the kernels ``fn``'s graph holds,
    in topological order."""
    from pytensor_tpu_torch.config import config
    from pytensor_tpu_torch.link.cuda.scan_kernel import ScanKernelSource, scan_kernel_eligible
    from pytensor_tpu_torch.scan.op import Scan
    from pytensor_tpu_torch.tensor.fused import FusedElemwise
    from pytensor_tpu_torch.tensor.fused_kernel import FusedElemwiseKernel

    out = []
    for node in fn.fgraph.toposort():
        if isinstance(node.op, FusedElemwise):
            out.append((node, "K1", FusedElemwiseKernel(node.op.fgraph, "cpu").source))
        elif (isinstance(node.op, Scan) and config.scan__pallas
              and scan_kernel_eligible(node.op, node)):
            out.append((node, "K2", ScanKernelSource(node.op, node).source))
    return out


def dump_function(fn, file=None, hlo=False):
    """Write a readable dump of a compiled Function.

    Sections: signature, rewritten graph (debugprint), profile stats if
    attached, and with ``hlo`` the generated CUDA source of each K1 and
    K2 kernel of the graph.  Returns the text.
    """
    from pytensor_tpu_torch.printing import debugprint

    buf = io.StringIO()
    print(f"Function {fn.name or '<anonymous>'}", file=buf)
    print(f"  backend: {_linker_name(fn)}", file=buf)
    print(f"  device: {fn.device}", file=buf)
    print(f"  inputs: {[str(i) for i in fn.fgraph.inputs]}", file=buf)
    print(f"  outputs: {len(fn.fgraph.outputs)}", file=buf)
    print("-" * 60, file=buf)
    debugprint(fn.fgraph, file=buf)
    stats = getattr(fn, "profile", None)
    if stats is not None:
        print("-" * 60, file=buf)
        stats.summary(file=buf)
    if hlo:
        for node, kind, source in kernel_sources(fn):
            print("-" * 60, file=buf)
            print(f"{kind} kernel of {node}:", file=buf)
            print(source, file=buf)
    text = buf.getvalue()
    if file is not None:
        file.write(text)
    return text

"""Linker support shared by the backends: error annotation.

Counterpart of ``raise_with_op`` in ``pytensor_tpu/link/basic.py``
(PyTensor's link/utils.py:271).
"""

from __future__ import annotations

import sys
import traceback


def raise_with_op(fgraph, node, exc_info=None):
    """Re-raise the current exception annotated with the failing node and
    the user-level creation trace."""
    if exc_info is None:
        exc_info = sys.exc_info()
    exc_type, exc_value, exc_trace = exc_info
    trace_info = ""
    for v in node.outputs:
        tr = getattr(v.tag, "trace", None)
        if tr:
            trace_info = "".join(traceback.format_list(tr[0][-2:]))
            break
    detail = (
        f"\nApply node that caused the error: {node}"
        f"\nInputs types: {[getattr(i, 'type', None) for i in node.inputs]}"
    )
    if trace_info:
        detail += f"\nVariable created at:\n{trace_info}"
    args = exc_value.args if exc_value.args else ("",)
    try:
        exc_value.args = (str(args[0]) + detail, *args[1:])
    except (AttributeError, TypeError):
        pass
    raise exc_value.with_traceback(exc_trace)

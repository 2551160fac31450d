"""IPython/Jupyter rich display hooks: host-only HTML of a graph.

Counterpart of ``pytensor_tpu/ipython.py`` (PyTensor's ipython.py).
"""

from __future__ import annotations


def _repr_html(graph_like):
    import html as _html

    from pytensor_tpu_torch.printing import debugprint

    text = debugprint(graph_like, file="str")
    return f"<pre>{_html.escape(text)}</pre>"


def register_ipython_formatters():
    """Register HTML formatters for Variables/FunctionGraphs in IPython."""
    try:
        from IPython import get_ipython

        ip = get_ipython()
        if ip is None:
            return False
    except ImportError:
        return False
    from pytensor_tpu_torch.graph.basic import Variable
    from pytensor_tpu_torch.graph.fg import FunctionGraph

    html_f = ip.display_formatter.formatters["text/html"]
    html_f.for_type(Variable, _repr_html)
    html_f.for_type(FunctionGraph, _repr_html)
    return True

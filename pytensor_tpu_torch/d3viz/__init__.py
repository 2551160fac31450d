"""HTML views of graphs (``d3viz.py``)."""

from pytensor_tpu_torch.d3viz.d3viz import d3viz, d3write

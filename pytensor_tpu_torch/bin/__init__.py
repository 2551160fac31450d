"""Command-line tools (``cache.py``)."""

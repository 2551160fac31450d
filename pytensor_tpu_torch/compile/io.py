"""In/Out wrappers for ``function()``.

Counterpart of ``pytensor_tpu/compile/io.py``, cut to what ``function``
reads: the variable and, for an input, its name.  Left out: ``update``,
``mutable``, ``strict``, ``allow_downcast``, ``value`` and ``borrow``,
which select behaviours the port's ``function`` does not have.
"""

from __future__ import annotations


class SymbolicInput:
    def __init__(self, variable, name=None):
        self.variable = variable
        self.name = name if name is not None else variable.name

    def __str__(self):
        return f"In({self.variable})"


class In(SymbolicInput):
    pass


class SymbolicOutput:
    def __init__(self, variable):
        self.variable = variable

    def __str__(self):
        return f"Out({self.variable})"


class Out(SymbolicOutput):
    pass

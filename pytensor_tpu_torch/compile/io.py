"""In/Out wrappers for ``function()``.

Counterpart of ``pytensor_tpu/compile/io.py``, whole: an input's
``name`` (a keyword of the call), ``value`` (its default when the call
leaves it out), ``strict`` and ``allow_downcast`` (how its value is
filtered: ``TensorType.filter``), ``update`` (on a shared variable: its
update, joined to the function's), and ``mutable``, ``implicit``,
``borrow`` and ``shared``, which are recorded: the port's functions never
write into an explicit input, and keep no input between calls.  An
output's ``borrow`` is accepted and changes nothing: a function's output
never shares storage with a shared tensor (``compile/executor.py``).
"""

from __future__ import annotations


class SymbolicInput:
    def __init__(self, variable, name=None, update=None, mutable=None,
                 strict=False, allow_downcast=None, implicit=False, value=None,
                 borrow=None, shared=False):
        self.variable = variable
        self.name = name if name is not None else variable.name
        self.update = update
        self.mutable = mutable if mutable is not None else (update is not None)
        self.strict = strict
        self.allow_downcast = allow_downcast
        self.implicit = implicit
        self.value = value
        self.borrow = borrow
        self.shared = shared

    def __str__(self):
        if self.update is not None:
            return f"In({self.variable} -> {self.update})"
        return f"In({self.variable})"


class In(SymbolicInput):
    pass


class SymbolicOutput:
    def __init__(self, variable, borrow=False):
        self.variable = variable
        self.borrow = borrow

    def __str__(self):
        return f"Out({self.variable})"


class Out(SymbolicOutput):
    pass

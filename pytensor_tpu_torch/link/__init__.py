"""Linkers: from a rewritten FunctionGraph to a callable."""

"""Modes and the global rewrite pipeline; OpFromGraph."""

"""Profiling of compiled functions (``profiling.py``); the debug modes
wait for ROADMAP.md Queue 1 item 11."""

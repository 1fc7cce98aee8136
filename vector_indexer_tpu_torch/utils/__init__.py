"""Heuristics, vector-file I/O and tracing."""

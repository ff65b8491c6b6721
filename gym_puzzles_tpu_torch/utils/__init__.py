"""Utilities: tracing and determinism checks (:mod:`.profiling`)."""

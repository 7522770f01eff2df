"""Checkpoints, metrics and profiling of the port (counterpart of
dtown/utils)."""

"""Measurement scripts of the port (run on a machine with the GPU)."""

"""Measurement tools for the port (need a CUDA device)."""

"""Numpy-only dataset readers (no imageio, no JAX)."""

"""Numpy-only dataset readers and the synthetic camera-array renderer (no imageio, no JAX)."""

"""Plain PyTorch ops and the CUDA kernel wrappers of the two-view path."""

"""Backend resolution: the tensor's device decides (twin of
``stereovisionarray_tpu/backend.py``).

``"auto"`` runs the hand-written CUDA kernel for a CUDA tensor and the plain
PyTorch version for a CPU tensor. ``"torch"`` forces the plain version on any
device (used to hold a kernel against its plain version on the card); the
plain versions are the twins of the reference's Pallas route. ``"cuda"``
demands the kernel and refuses a CPU tensor. ``"xla"`` is the plain twin of
the reference's XLA oracle route: the pipelines take their float scans and
edge-clamped extraction (integer cost dtypes compute in float32 there, as in
the reference), and every kernel wrapper treats it as ``"torch"``, so it never
launches a kernel. There is no fallback: a kernel that does not build or
launch raises.
"""

import torch

__all__ = ["resolve_backend"]

BACKENDS = ("auto", "cuda", "torch", "xla")


def resolve_backend(tensor: torch.Tensor, backend: str = "auto") -> str:
    """Return ``"cuda"`` (launch the kernel), ``"torch"`` (plain twin of the
    reference's kernel route) or ``"xla"`` (plain twin of its XLA route)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend in ("torch", "xla"):
        return backend
    if tensor.is_cuda:
        return "cuda"
    if backend == "cuda":
        raise ValueError(f"backend='cuda' needs a CUDA tensor, got device {tensor.device}")
    return "torch"

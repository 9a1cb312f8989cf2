"""Backend resolution: the tensor's device decides (twin of
``stereovisionarray_tpu/backend.py``).

``"auto"`` runs the hand-written CUDA kernel for a CUDA tensor and the plain
PyTorch version for a CPU tensor. ``"torch"`` forces the plain version on any
device (used to hold a kernel against its plain version on the card).
``"cuda"`` demands the kernel and refuses a CPU tensor. There is no fallback:
a kernel that does not build or launch raises.
"""

import torch

__all__ = ["resolve_backend"]

BACKENDS = ("auto", "cuda", "torch")


def resolve_backend(tensor: torch.Tensor, backend: str = "auto") -> str:
    """Return ``"cuda"`` (launch the kernel) or ``"torch"`` (plain version)."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of {BACKENDS}")
    if backend == "torch":
        return "torch"
    if tensor.is_cuda:
        return "cuda"
    if backend == "cuda":
        raise ValueError(f"backend='cuda' needs a CUDA tensor, got device {tensor.device}")
    return "torch"

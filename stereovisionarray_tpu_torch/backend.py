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

from collections import OrderedDict

import numpy as np
import torch

__all__ = ["host_to_device", "resolve_backend"]

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


_DEVICE_TABLES: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()
_DEVICE_TABLES_MAX = 64


def host_to_device(a, device) -> torch.Tensor:
    """A host table (numpy array or CPU tensor) on `device`, values unchanged;
    the result is shared: read it, never write it.

    A copy from pageable memory to the card waits until the stream has run
    everything queued before it. The tables of the timed paths (resize
    weights, plane depths, shift tables) repeat from frame to frame, so a CUDA
    target keeps the last tables it was given on the card, keyed by their
    contents, and copies a new one once, staged in pinned memory and
    asynchronously (``non_blocking``)."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(a))
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    t = t.contiguous()
    key = (device, t.dtype, tuple(t.shape), t.numpy().tobytes())
    hit = _DEVICE_TABLES.get(key)
    if hit is None:
        hit = t.pin_memory().to(device, non_blocking=True)
        _DEVICE_TABLES[key] = hit
        if len(_DEVICE_TABLES) > _DEVICE_TABLES_MAX:
            _DEVICE_TABLES.popitem(last=False)
    else:
        _DEVICE_TABLES.move_to_end(key)
    return hit

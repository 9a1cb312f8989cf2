"""Hat-weighted sampling along one image axis: kernel K9 (twin of
``stereovisionarray_tpu/ops/hatsample.py::hat_sample``).

    out(y, x) = sum_{k=k0}^{k1} max(0, 1 - |t(y, x) - k|) * values(y, clamp(x - k))

a bilinear sample of ``values`` at ``x - t`` wherever t lies in [k0, k1],
with edge-replicated columns; t outside the range keeps the partial weight
of the taps inside it. With ``aux`` (a (W,) table) it also returns
``aux_out(y, x) = sum_k hat(t - k) * aux(clamp(x - k))``. ``axis=-2``
samples along rows instead (``values(clamp(y - k), x)``), which the array
cascade's vertical pre-warp pass uses in place of two transposes. A leading
batch axis samples every map of a stack in one launch.

The reference pads by ``max(k1, 0)`` columns on the left, so with k1 < 0 it
reads ``values(x + k1 - k)`` (``hatsample.py:94``); no caller passes k1 < 0,
and the port implements the formula above.

:func:`hat_sample` launches ``csrc/hat_sample.cu`` on CUDA tensors;
:func:`hat_sample_plain` is the same two-tap computation in plain PyTorch,
bit-identical to the kernel.
"""

from __future__ import annotations

from typing import Optional

import torch

from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.backend import resolve_backend

__all__ = ["hat_sample", "hat_sample_plain"]


def _validate(values, t, k0, k1, aux, axis):
    if values.dim() not in (2, 3) or t.shape != values.shape:
        raise ValueError(f"values and t must share an (H, W) or (B, H, W) shape, got "
                         f"{tuple(values.shape)} and {tuple(t.shape)}")
    if axis not in (-1, -2):
        raise ValueError(f"axis must be -1 (along x) or -2 (along y), got {axis}")
    if k0 > k1:
        raise ValueError(f"empty tap range [{k0}, {k1}]")
    if aux is not None and (axis != -1 or tuple(aux.shape) != (values.shape[-1],)):
        raise ValueError(f"aux must be a (W,) table sampled along x, got {tuple(aux.shape)}")


def hat_sample_plain(values: torch.Tensor, t: torch.Tensor, k0: int, k1: int,
                     aux: Optional[torch.Tensor] = None, axis: int = -1):
    """Plain PyTorch twin of K9: the taps floor(t) and floor(t) + 1 (the only
    ones whose hat weight can be non-zero), each kept where it lies in
    [k0, k1], summed from +0 in ascending k."""
    _validate(values, t, k0, k1, aux, axis)
    values, t = values.to(torch.float32), t.to(torch.float32)
    n = values.shape[axis]
    pos = torch.arange(n, device=values.device)
    if axis == -2:
        pos = pos[:, None]
    f = torch.floor(t)
    out = torch.zeros_like(t)
    aout = torch.zeros_like(t) if aux is not None else None
    for tap in (0, 1):
        kf = f + tap
        inside = (kf >= k0) & (kf <= k1)
        wgt = (1.0 - (t - kf).abs()).clamp_min(0.0)
        idx = (pos - kf.clamp(k0 - 1, k1 + 1).to(torch.int64)).clamp(0, n - 1)
        out = out + torch.where(inside, wgt * values.gather(axis, idx), 0.0)
        if aux is not None:
            aout = aout + torch.where(inside, wgt * aux.to(torch.float32)[idx], 0.0)
    return out if aux is None else (out, aout)


def hat_sample(values: torch.Tensor, t: torch.Tensor, k0: int, k1: int,
               aux: Optional[torch.Tensor] = None, axis: int = -1, backend: str = "auto"):
    """K9: values, t (H, W) or (B, H, W) float32; aux (W,) or None. Returns
    ``out`` or ``(out, aux_out)``, each of t's shape."""
    if resolve_backend(values, backend) != "cuda":
        return hat_sample_plain(values, t, k0, k1, aux, axis)
    _validate(values, t, k0, k1, aux, axis)
    shape = tuple(values.shape)
    b, h, w = (1, *shape) if len(shape) == 2 else shape
    _native.check(values, "values", torch.float32, shape)
    _native.check(t, "t", torch.float32, shape)
    out = torch.empty(shape, dtype=torch.float32, device=values.device)
    aout = None
    if aux is not None:
        _native.check(aux, "aux", torch.float32, (w,))
        aout = torch.empty(shape, dtype=torch.float32, device=values.device)
    _native.launch("svt_hat_sample", values.device, values.data_ptr(), t.data_ptr(),
                   aux.data_ptr() if aux is not None else None, out.data_ptr(),
                   aout.data_ptr() if aout is not None else None, b, h, w, int(k0), int(k1),
                   int(axis == -2))
    hat_sample.launches += 1
    return out if aux is None else (out, aout)


hat_sample.launches = 0

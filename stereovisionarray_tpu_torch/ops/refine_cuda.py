"""The static candidate stack's refinement pass on the card: ``csrc/refine.cu``
(``svt_refine_costs``: the data term and the row scan, then the column scan;
``svt_refine_select``: the fused costs, the winner and its parabola).

The kernels give the bits of ``ops/refine.py``'s plain route on the same
card: each float32 operation rounded where PyTorch rounds, each sum in the
order of the PyTorch kernel the plain route runs (the view sum's four
accumulators, ``torch.cumsum``'s chunked Sklansky scan along W and its
sequential scan along H). ``ops/refine.py::multiview_refine`` takes this
route by its ``backend``, for a pass the kernels do not refuse
(:func:`refusal`: the limits live in ``csrc/refine.cu`` alone); the host
plan (``stack_plan``) is the plain route's own, with the kernels' table
packed from it.
"""

from __future__ import annotations

from typing import Optional

import torch

from stereovisionarray_tpu_torch import _native
from stereovisionarray_tpu_torch.backend import host_to_device
from stereovisionarray_tpu_torch.ops.refine import stack_plan
from stereovisionarray_tpu_torch.utils.profiling import span

__all__ = ["refine_pass", "refusal"]

# svt_refine_refusal's codes
_REFUSALS = {
    1: "more views than one thread of PyTorch's reduction sums (64 or more), whose split "
       "order the kernels do not follow",
    2: "a window on a single row or column, which PyTorch scans with another algorithm",
    3: "a row whose scan does not fit in a block's shared memory",
}


def refusal(views: int, h: int, w: int, window: int, device: torch.device) -> Optional[str]:
    """None when the kernels take a pass of `views` views on (h, w) with this
    window on `device` (a CUDA tensor's device), else why they do not."""
    code = _native.call("svt_refine_refusal", device, views, h, w, int(window > 1))
    return _REFUSALS[code] if code else None


def refine_pass(reference, aux, bl, disparity, mask, radius: int, step: float, window: int,
                subpixel: bool, max_disparity: float):
    """One static-stack refinement pass on float32 CUDA tensors: reference
    (H, W), aux (V, H, W), disparity (H, W), mask (H, W) bool or None; bl
    (V, 2) float64 host baselines. Returns the refined disparity, the applied
    offset, the winner's cost and its validity (``ops.refine.RefineOutput``'s
    fields)."""
    h, w = reference.shape
    views, num = aux.shape[0], 2 * radius + 1
    dev = reference.device
    box = window > 1
    with span("svt.refine.stack"):
        plan = stack_plan(bl, radius, step, max_disparity)
        table = host_to_device(plan.table, dev)
        reference, aux, disparity = (t.contiguous() for t in (reference, aux, disparity))
        if mask is not None:
            mask = mask.contiguous()
            _native.check(mask, "mask", torch.bool, (h, w))
        _native.check(reference, "reference", torch.float32, (h, w))
        _native.check(aux, "aux", torch.float32, (views, h, w))
        _native.check(disparity, "disparity", torch.float32, (h, w))
    with span("svt.refine.costs"):
        c1 = torch.empty((num, h, w), dtype=torch.float32, device=dev)
        n1 = torch.empty((num, h, w), dtype=torch.int32, device=dev)
        c2, n2 = (torch.empty_like(c1), torch.empty_like(n1)) if box else (c1, n1)
        _native.launch("svt_refine_costs", dev, reference.data_ptr(), aux.data_ptr(),
                       disparity.data_ptr(), table.data_ptr(), c1.data_ptr(), n1.data_ptr(),
                       c2.data_ptr(), n2.data_ptr(), views, num, h, w, window // 2, int(box),
                       int(plan.q is not None), radius * step)
    with span("svt.refine.select"):
        out = (torch.empty_like(disparity), torch.empty_like(disparity),
               torch.empty_like(disparity), torch.empty((h, w), dtype=torch.bool, device=dev))
        _native.launch("svt_refine_select", dev, c2.data_ptr(), n2.data_ptr(),
                       disparity.data_ptr(), mask.data_ptr() if mask is not None else None,
                       *(t.data_ptr() for t in out), num, h, w, window // 2, int(box),
                       int(subpixel), float(step))
    return out

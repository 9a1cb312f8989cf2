"""Multi-view photoconsistency disparity refinement, plain PyTorch (twin of
``stereovisionarray_tpu/ops/refine.py``).

Every auxiliary view is warped into the reference view at the current
disparity plus each candidate offset in ``[-radius*step, radius*step]``; the
box-filtered absolute difference, fused over the in-view views, scores each
candidate, and a parabola over the offset axis refines the winner. The three
warp paths of the reference are kept:

 - the static candidate stack (host baselines and a disparity ceiling): every
   integer step along each view's epipolar line is one uniform shift of the
   view; the warp at a candidate disparity blends the two bracketing stack
   entries, read with ``torch.gather`` where the reference sums one-hot
   selects (the values are the same);
 - warp-once: each view warped once at the current disparity, the candidates
   as uniform shifts of that warp;
 - ``exact_warp``: every view re-warped at every candidate.

The reference has no Pallas kernel here, so neither has the port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from stereovisionarray_tpu_torch.ops.warp import pixel_grid, warp_with_disparity
from stereovisionarray_tpu_torch.utils.profiling import span

__all__ = ["RefineOutput", "box_filter2d", "multiview_refine"]

_BIG = 1e9


def box_filter2d(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sum over a k x k window of the last two axes, zero outside (border
    windows sum only in-bounds elements), by two cumulative sums."""
    if k <= 1:
        return x
    r = k // 2

    def along(a, dim):
        n = a.shape[dim]
        c = torch.cumsum(a, dim=dim)
        # windowsum(i) = c[min(i + r, n - 1)] - (c[i - r - 1] if i - r - 1 >= 0 else 0)
        hi = c.index_select(dim, (torch.arange(n, device=a.device) + r).clamp(max=n - 1))
        lo_idx = torch.arange(n, device=a.device) - r - 1
        lo = c.index_select(dim, lo_idx.clamp(min=0))
        shape = [1] * a.dim()
        shape[dim] = n
        return hi - torch.where((lo_idx >= 0).reshape(shape), lo, 0.0)

    return along(along(x, -1), -2)


class RefineOutput(NamedTuple):
    disparity: torch.Tensor  # (H, W) refined disparity
    delta: torch.Tensor  # (H, W) applied offset (subpixel)
    cost: torch.Tensor  # (H, W) fused photoconsistency at the winner
    valid: torch.Tensor  # (H, W) pixels where refinement had >= 1 view in bounds


def _uniform_shift(img: torch.Tensor, su: float, sv: float, pad: int,
                   fill: float = 0.0) -> torch.Tensor:
    """(H, W) `img` sampled at the uniform subpixel shift (su, sv), float32
    host values: ``out[y, x] = img[y + sv, x + su]`` over a `pad`-wide `fill`
    ring, each corner window's start clamped into the padded image."""
    h, w = img.shape
    padded = torch.nn.functional.pad(img, (pad, pad, pad, pad), value=fill)
    j0, i0 = np.floor(sv), np.floor(su)
    fv, fu = float(sv - j0), float(su - i0)
    y0, x0 = pad + int(j0), pad + int(i0)

    def sl(dy, dx):
        y = min(max(y0 + dy, 0), 2 * pad)
        x = min(max(x0 + dx, 0), 2 * pad)
        return padded[y: y + h, x: x + w]

    top = sl(0, 0) * float(np.float32(1.0) - np.float32(fu)) + sl(0, 1) * fu
    bot = sl(1, 0) * float(np.float32(1.0) - np.float32(fu)) + sl(1, 1) * fu
    return top * float(np.float32(1.0) - np.float32(fv)) + bot * fv


def _static_shift(padded: torch.Tensor, su: float, sv: float, pad: int, h: int,
                  w: int) -> torch.Tensor:
    """A `pad`-padded image sampled at the static subpixel shift (su, sv)."""
    j0, i0 = int(np.floor(sv)), int(np.floor(su))
    fv, fu = float(sv - j0), float(su - i0)
    y0, x0 = pad + j0, pad + i0

    def sl(dy, dx):
        return padded[y0 + dy: y0 + dy + h, x0 + dx: x0 + dx + w]

    if fu == 0.0 and fv == 0.0:
        return sl(0, 0)
    top = sl(0, 0) * (1.0 - fu) + sl(0, 1) * fu
    bot = sl(1, 0) * (1.0 - fu) + sl(1, 1) * fu
    return top * (1.0 - fv) + bot * fv


def _fuse(diffs, oks, window: int):
    """Box-filtered view sums -> (fused cost, any view in bounds)."""
    total_c = box_filter2d(diffs.sum(dim=0), window)
    total_n = box_filter2d(oks.sum(dim=0), window)
    fused = total_c / torch.clamp_min(total_n, 1.0)
    return torch.where(total_n > 0, fused, _BIG), total_n > 0


def _stack_costs(reference, aux_images, bl, disparity, radius, step, window, max_disparity):
    """Per-offset fused costs over the static candidate stack."""
    with span("svt.refine.stack"):
        h, w = reference.shape
        num = 2 * radius + 1
        offsets_np = (np.arange(num, dtype=np.float64) - radius) * step
        off_hi = abs(radius * step)
        v_iota, u_iota = pixel_grid(h, w, reference.device, reference.dtype)

        stacks = []
        for v in range(aux_images.shape[0]):
            bu, bv = float(bl[v, 0]), float(bl[v, 1])
            blen = float(np.hypot(bu, bv))
            if blen < 1e-12:  # zero baseline: the warp is the identity at every candidate
                ux = uy = 0.0
                s_lo = s_hi = 0
            else:
                ux, uy = bu / blen, bv / blen
                s_lo = int(np.floor(-off_hi * blen))
                s_hi = int(np.ceil((max_disparity + off_hi) * blen))
            pad_v = int(np.ceil(max(abs(s_lo), abs(s_hi)) * max(abs(ux), abs(uy)))) + 2
            padded = torch.nn.functional.pad(aux_images[v], (pad_v,) * 4)
            stack = torch.stack([_static_shift(padded, s * ux, s * uy, pad_v, h, w)
                                 for s in range(s_lo, s_hi + 1)])
            stacks.append((stack, s_lo, s_hi, blen, bu, bv))

    def ok_mask(delta, blen, bu, bv):
        # a non-positive candidate disparity is no evidence (warp_with_disparity's gate)
        d_new = disparity + delta
        return ((u_iota + d_new * bu >= 0.0) & (u_iota + d_new * bu <= w - 1.0)
                & (v_iota + d_new * bv >= 0.0) & (v_iota + d_new * bv <= h - 1.0)
                & (d_new > 0.0))

    def at(stack, s_lo, s_hi, j):
        """stack entry j (integer steps, clipped to [s_lo, s_hi]) per pixel."""
        return torch.gather(stack, 0, (j.clamp(s_lo, s_hi) - s_lo)[None])[0]

    with span("svt.refine.costs"):
        q_ints = [int(round(step * b[3])) for b in stacks]
        integer_spacing = all(abs(step * b[3] - q) < 1e-9 for b, q in zip(stacks, q_ints))
        per = []
        if integer_spacing:
            # integer candidate spacing q: candidate o is the lerp of stack
            # entries i0 + o*q and i0 + o*q + 1, t0 = (d - radius*step)*blen
            warped_all = []
            for (stack, s_lo, s_hi, blen, _, _), q in zip(stacks, q_ints):
                t0 = (disparity - radius * step) * blen
                i0f = torch.floor(t0)
                f = t0 - i0f
                i0 = i0f.to(torch.int64)
                warped_all.append([(1.0 - f) * at(stack, s_lo, s_hi, i0 + o * q)
                                   + f * at(stack, s_lo, s_hi, i0 + o * q + 1)
                                   for o in range(num)])
            for o, delta in enumerate(offsets_np):
                oks = [ok_mask(float(delta), b[3], b[4], b[5]) for b in stacks]
                diffs = [torch.where(ok, (reference - wv[o]).abs(), 0.0)
                         for ok, wv in zip(oks, warped_all)]
                per.append(_fuse(torch.stack(diffs), torch.stack(oks).to(reference.dtype),
                                 window))
        else:
            # hat blend: weights max(0, 1 - |t - s|) are non-zero only at
            # s = floor(t) and floor(t) + 1
            for delta in offsets_np:
                diffs, oks = [], []
                for stack, s_lo, s_hi, blen, bu, bv in stacks:
                    t = ((disparity + float(delta)) * blen).clamp(s_lo, s_hi)
                    s0 = torch.floor(t)
                    w0 = torch.clamp_min(1.0 - (t - s0).abs(), 0.0)
                    w1 = torch.clamp_min(1.0 - (t - (s0 + 1.0)).abs(), 0.0)
                    j = s0.to(torch.int64)
                    warped = w0 * at(stack, s_lo, s_hi, j) + w1 * at(stack, s_lo, s_hi, j + 1)
                    ok = ok_mask(float(delta), blen, bu, bv)
                    diffs.append(torch.where(ok, (reference - warped).abs(), 0.0))
                    oks.append(ok)
                per.append(_fuse(torch.stack(diffs), torch.stack(oks).to(reference.dtype),
                                 window))
    return per


def multiview_refine(
    reference: torch.Tensor,
    aux_images: torch.Tensor,
    baselines_uv,
    disparity: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    radius: int = 5,
    step: float = 1.0,
    window: int = 21,
    subpixel: bool = True,
    exact_warp: bool = False,
    max_disparity: Optional[float] = None,
) -> RefineOutput:
    """Refine `disparity` (H, W) against aux views (V, H, W).

    baselines_uv: (V, 2) host (numpy) epipolar directions, scaled so that
    `disparity` pixels along them align each view with the reference.
    mask: optional (H, W) ROI; pixels outside pass through. max_disparity:
    the static disparity ceiling that enables the candidate-stack path.
    exact_warp: re-warp every view at every candidate (the literal objective);
    otherwise, without a ceiling, each view is warped once."""
    num = 2 * radius + 1
    offsets_np = (np.arange(num, dtype=np.float64) - radius) * step
    bl = np.asarray(baselines_uv.detach().cpu() if torch.is_tensor(baselines_uv)
                    else baselines_uv, dtype=np.float64)
    bl32 = bl.astype(np.float32)
    dtype = reference.dtype

    if not exact_warp and max_disparity is not None and max_disparity > 0:
        per = _stack_costs(reference, aux_images, bl, disparity, radius, step, window,
                           max_disparity)
    else:
        if not exact_warp:
            with span("svt.refine.stack"):
                base = [warp_with_disparity(img, disparity, bl32[v])
                        for v, img in enumerate(aux_images)]
                shift_pad = int(np.ceil(abs(radius * step))) + 2
        with span("svt.refine.costs"):
            per = []
            for delta in offsets_np.astype(np.float32):
                if exact_warp:
                    d = disparity + float(delta)
                    pairs = [warp_with_disparity(img, d, bl32[v])
                             for v, img in enumerate(aux_images)]
                    warped = torch.stack([p[0] for p in pairs])
                    ok = torch.stack([p[1] for p in pairs])
                else:
                    ws, oks = [], []
                    for v, (w0, o0) in enumerate(base):
                        su, sv = delta * bl32[v, 0], delta * bl32[v, 1]
                        ws.append(_uniform_shift(w0, su, sv, shift_pad))
                        okf = _uniform_shift(o0.to(dtype), su, sv, shift_pad)
                        oks.append(okf > 0.999)  # all four lerp corners valid
                    warped, ok = torch.stack(ws), torch.stack(oks)
                diff = (reference[None] - warped).abs()
                per.append(_fuse(torch.where(ok, diff, 0.0), ok.to(dtype), window))
    with span("svt.refine.select"):
        costs = torch.stack([p[0] for p in per])
        any_valid = torch.stack([p[1] for p in per])
        return _select_best(costs, any_valid, disparity, mask, num, step, subpixel)


def _select_best(costs, any_valid, disparity, mask, num, step, subpixel) -> RefineOutput:
    """WTA + parabola over the offset axis (O, H, W), shared by all warp
    paths; per-pixel reads along O are gathers."""
    best_cost, best = torch.min(costs, dim=0)

    def at(vol, idx):
        return torch.gather(vol, 0, idx[None])[0]

    valid = at(any_valid, best)
    delta = (best.to(costs.dtype) - (num - 1) / 2.0) * step
    if subpixel and num >= 3:
        bm = best.clamp(1, num - 2)
        cm1, c0, cp1 = at(costs, bm - 1), at(costs, bm), at(costs, bm + 1)
        denom = cm1 - 2.0 * c0 + cp1
        nonflat = denom.abs() > 1e-9
        frac = torch.where(nonflat, 0.5 * (cm1 - cp1) / torch.where(nonflat, denom, 1.0), 0.0)
        frac = frac.clamp(-0.5, 0.5)
        interior = (best >= 1) & (best <= num - 2)
        delta = delta + torch.where(interior, frac, 0.0) * step
    apply = valid if mask is None else (valid & mask)
    new_disp = torch.clamp_min(torch.where(apply, disparity + delta, disparity), 0.0)
    return RefineOutput(disparity=new_disp, delta=torch.where(apply, delta, 0.0),
                        cost=best_cost, valid=valid)

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

The reference has no Pallas kernel here. On the card the static candidate
stack's pass runs as hand-written CUDA instead (``ops/refine_cuda.py``,
``csrc/refine.cu``): three launches a pass that give this route's bits on
the card, its sums taken in the order PyTorch's own CUDA kernels take them.
``backend`` chooses the route as for every kernel of the package; both
routes read one host plan of the stack (:func:`stack_plan`), and the plain
route stays the CPU route and the twin the kernels are tested against.
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from stereovisionarray_tpu_torch.backend import resolve_backend
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


class _ViewPlan(NamedTuple):
    bu: float  # the view's baseline, host float64
    bv: float
    blen: float
    s_lo: int  # its stack spans the integer steps [s_lo, s_hi] along the line
    s_hi: int
    pad: int  # zero padding that holds every step's shift
    shifts: Tuple[Tuple[int, int, float, float], ...]  # per step: (j0, i0, fv, fu)


class _StackPlan(NamedTuple):
    views: Tuple[_ViewPlan, ...]
    q: Optional[Tuple[int, ...]]  # integer candidate spacing per view, or None (hat blend)
    table: np.ndarray  # the plan packed for the fused kernels (_kernel_table); never write it


def stack_plan(bl: np.ndarray, radius: int, step: float, max_disparity: float) -> _StackPlan:
    """The static candidate stack's host plan, which both routes read, and
    its table for the kernels. The scalars keep their types (a numpy float32
    ceiling computes its bounds in float32), so their types key the cache
    beside their values. Shared between callers: read it, never write it."""
    return _stack_plan_cached(np.asarray(bl, np.float64).tobytes(), len(bl), radius, step,
                              max_disparity, type(step), type(max_disparity))


@functools.lru_cache(maxsize=32)
def _stack_plan_cached(bl_bytes: bytes, num_views: int, radius: int, step: float,
                       max_disparity: float, *types) -> _StackPlan:
    bl = np.frombuffer(bl_bytes, np.float64).reshape(num_views, 2)
    off_hi = abs(radius * step)
    views = []
    for v in range(num_views):
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
        shifts = []
        for s in range(s_lo, s_hi + 1):
            su, sv = s * ux, s * uy
            j0, i0 = int(np.floor(sv)), int(np.floor(su))
            shifts.append((j0, i0, float(sv - j0), float(su - i0)))
        views.append(_ViewPlan(bu, bv, blen, s_lo, s_hi, pad_v, tuple(shifts)))
    q_ints = tuple(int(round(step * p.blen)) for p in views)
    integer_spacing = all(abs(step * p.blen - q) < 1e-9 for p, q in zip(views, q_ints))
    q = q_ints if integer_spacing else None
    return _StackPlan(tuple(views), q, _kernel_table(views, q, radius, step))


def _kernel_table(views, q, radius: int, step: float) -> np.ndarray:
    """The fused kernels' int32 table of a plan (layout in csrc/refine.cu):
    the offsets, per view its bounds, entry offset, candidate spacing and
    float32 baseline, then per stack step its integer shift, whether it is
    exact and its float32 weights: each float as PyTorch rounds the plain
    route's Python scalar (float64) to float32."""
    num, f32 = 2 * radius + 1, np.float32
    offsets = ((np.arange(num, dtype=np.float64) - radius) * step).astype(f32)
    first = -(-(num + 8 * len(views)) // 8) * 8
    table = np.zeros(first + 8 * sum(len(p.shifts) for p in views), np.int32)
    table[:num] = offsets.view(np.int32)
    entry = first
    for v, p in enumerate(views):
        table[num + 8 * v: num + 8 * v + 4] = (p.s_lo, p.s_hi, entry, q[v] if q else 0)
        table[num + 8 * v + 4: num + 8 * v + 7] = np.array([p.bu, p.bv, p.blen], f32).view(np.int32)
        ints = np.array([sh[:2] for sh in p.shifts], np.int32)  # (S, 2): j0, i0
        fv, fu = np.array([sh[2:] for sh in p.shifts], np.float64).T
        rows = table[entry: entry + 8 * len(p.shifts)].reshape(-1, 8)
        rows[:, 0], rows[:, 1] = ints[:, 1], ints[:, 0]
        rows[:, 2] = (fu == 0.0) & (fv == 0.0)
        rows[:, 4:] = np.stack([1.0 - fu, fu, 1.0 - fv, fv], 1).astype(f32).view(np.int32)
        entry += 8 * len(p.shifts)
    return table


def _static_shift(padded: torch.Tensor, shift, pad: int, h: int, w: int) -> torch.Tensor:
    """A `pad`-padded image sampled at a static subpixel shift, given as its
    integer part and fraction (j0, i0, fv, fu)."""
    j0, i0, fv, fu = shift
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


def _build_stacks(aux_images, plan: _StackPlan):
    """Each view's (S, H, W) stack: its image at every integer step along its
    epipolar line."""
    h, w = aux_images.shape[-2:]
    stacks = []
    for img, p in zip(aux_images, plan.views):
        padded = torch.nn.functional.pad(img, (p.pad,) * 4)
        stacks.append(torch.stack([_static_shift(padded, sh, p.pad, h, w) for sh in p.shifts]))
    return stacks


def _stack_costs(reference, aux_images, bl, disparity, radius, step, window, max_disparity):
    """Per-offset fused costs over the static candidate stack."""
    with span("svt.refine.stack"):
        plan = stack_plan(bl, radius, step, max_disparity)
        h, w = reference.shape
        num = 2 * radius + 1
        offsets_np = (np.arange(num, dtype=np.float64) - radius) * step
        v_iota, u_iota = pixel_grid(h, w, reference.device, reference.dtype)
        stacks = [(stack, p.s_lo, p.s_hi, p.blen, p.bu, p.bv)
                  for stack, p in zip(_build_stacks(aux_images, plan), plan.views)]

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
        q_ints = plan.q
        per = []
        if q_ints is not None:
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
    backend: str = "auto",
) -> RefineOutput:
    """Refine `disparity` (H, W) against aux views (V, H, W).

    baselines_uv: (V, 2) host (numpy) epipolar directions, scaled so that
    `disparity` pixels along them align each view with the reference.
    mask: optional (H, W) ROI; pixels outside pass through. max_disparity:
    the static disparity ceiling that enables the candidate-stack path.
    exact_warp: re-warp every view at every candidate (the literal objective);
    otherwise, without a ceiling, each view is warped once.

    backend: "auto" runs the candidate-stack pass of float32 CUDA tensors on
    the fused kernels, which give the plain route's bits on the card; "cuda"
    demands them (any dtype the kernels refuse raises); "torch" and "xla" run
    the plain route on any device. The kernels take 1 to 63 views, at least
    two rows and two columns with a window wider than 1, and a row whose scan
    fits in a block's shared memory (about 28,000 columns on an H100):
    outside those limits "cuda" raises and "auto" warns and runs the plain
    route. Warp-once and exact_warp have no kernel: they run the plain route
    on every backend."""
    num = 2 * radius + 1
    offsets_np = (np.arange(num, dtype=np.float64) - radius) * step
    bl = np.asarray(baselines_uv.detach().cpu() if torch.is_tensor(baselines_uv)
                    else baselines_uv, dtype=np.float64)
    bl32 = bl.astype(np.float32)
    dtype = reference.dtype
    route = resolve_backend(reference, backend)

    if not exact_warp and max_disparity is not None and max_disparity > 0:
        if route == "cuda" and (backend == "cuda" or all(
                t.dtype == torch.float32 for t in (reference, aux_images, disparity))):
            from stereovisionarray_tpu_torch.ops import refine_cuda

            h, w = reference.shape[-2:]
            refused = refine_cuda.refusal(aux_images.shape[0], h, w, window, reference.device)
            if refused is None:
                return RefineOutput(*refine_cuda.refine_pass(
                    reference, aux_images, bl, disparity, mask, radius, step, window, subpixel,
                    max_disparity))
            if backend == "cuda":
                raise ValueError(f"backend='cuda': the refinement's kernels refuse this pass: "
                                 f"{refused}")
            warnings.warn(f"the refinement's kernels refuse this pass ({refused}): it runs the "
                          "plain route, thousands of launches", RuntimeWarning, stacklevel=2)
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

"""Plain reference of the camera-array depth pipeline on a translation-only
rig: census plane sweep with view fusion, the plane volume quantized and
aggregated by integer SGM over the plane index, WTA with the parabola in
inverse depth, then multi-view photoconsistency refinement in disparity.

A frozen copy of the plain twins of ``stereovisionarray_tpu_torch``'s array
route (``ops/sweep_cuda.plane_sweep_census_plain``, ``models/plane_sweep``,
``ops/refine`` and ``models/array_pipeline``): on the same device it gives
the bits of the port's K8, K2/K3 and K4 and of its refinement. It works the
plane depths, shifts, penalties, baselines and the disparity ceiling out
again from the rig and the configuration, and imports nothing of the port.
``refine_dtype`` computes the refinement in another float type (the
benchmark's lower-precision control).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, Tuple

import numpy as np
import torch

from benchmark.reference import plain

PLANE_COST_SCALE = 4
PLAIN_PLANE_CHUNK = 4
_BIG = 1e9


# ----------------------------------------------------------------- geometry
def _round_f32(x: Fraction) -> np.float32:
    near = np.float32(float(x))
    cands = (np.nextafter(near, np.float32(-np.inf)), near, np.nextafter(near, np.float32(np.inf)))
    return min(cands, key=lambda c: (abs(Fraction(float(c)) - x), int(c.view(np.int32)) & 1))


def _fma_f32(a: np.ndarray, b, c: np.ndarray) -> np.ndarray:
    b = Fraction(float(b))
    return np.array([_round_f32(Fraction(float(x)) * b + Fraction(float(z)))
                     for x, z in zip(a, c)], dtype=np.float32)


def inverse_depth_samples(z_near: float, z_far: float, num: int) -> np.ndarray:
    """(num,) float32 plane depths uniform in inverse depth, as a compiled
    float32 ``linspace(1/z_near, 1/z_far, num)`` computes them (one fused
    multiply-add an element), then ``1 / inv``."""
    start = np.float32(1.0 / z_near)
    stop = np.float32(1.0 / z_far)
    if num > 1:
        div = num - 1
        c = np.float32(1.0) / np.float32(div)
        i = np.arange(div, dtype=np.float32)
        inv = np.append(_fma_f32(i, stop * c, start * (np.float32(1.0) - i * c)), stop)
        if 2 < num <= 32:
            inv[1] = _fma_f32(np.array([start]), np.float32(1.0) - c, np.array([stop * c]))[0]
    else:
        inv = np.full((num,), start, dtype=np.float32)
    return np.float32(1.0) / inv.astype(np.float32)


def reference_and_sources(rows: int, cols: int, topology: str) -> Tuple[int, Tuple[int, ...]]:
    """The grid centre and its sources: CROSS its four neighbours (left,
    right, up, down), to_center every other view."""
    ref = (rows // 2) * cols + cols // 2
    r, c = divmod(ref, cols)
    if topology.lower() == "cross":
        src = [(r + dr) * cols + c + dc for dr, dc in ((0, -1), (0, 1), (-1, 0), (1, 0))
               if 0 <= r + dr < rows and 0 <= c + dc < cols]
    elif topology.lower() == "to_center":
        src = [i for i in range(rows * cols) if i != ref]
    else:
        raise ValueError(f"the reference has no topology {topology!r}")
    return ref, tuple(src)


def centers(rig: Dict[str, np.ndarray]) -> np.ndarray:
    """(N, 3) camera centres ``-R^T t``."""
    return -np.einsum("nji,nj->ni", rig["R"], rig["t"])


def shifts(rig, ref: int, src, depths: np.ndarray) -> np.ndarray:
    """(S, D, 2) float32 pixel shifts of each source at each plane."""
    inv_d = np.float32(1.0) / depths.astype(np.float32)
    src = np.asarray(src, dtype=np.int64)
    t_rel = rig["t"][src] - rig["t"][ref]
    su = rig["fx"][src][:, None] * t_rel[:, 0:1] * inv_d[None, :] + (
        rig["cx"][src] - rig["cx"][ref])[:, None]
    sv = rig["fy"][src][:, None] * t_rel[:, 1:2] * inv_d[None, :] + (
        rig["cy"][src] - rig["cy"][ref])[:, None]
    return np.stack([su, sv], axis=-1).astype(np.float32)


def baselines(rig, ref: int, src) -> Tuple[np.ndarray, float]:
    """(V, 2) epipolar directions scaled to the mean baseline B0, and B0."""
    c = centers(rig)
    rel = c[ref][None, :2] - c[list(src), :2]
    b_len = np.linalg.norm(rel, axis=-1)
    b0 = float(b_len.mean())
    unit = rel / np.maximum(b_len[:, None], 1e-12)
    return (unit * (b_len / max(b0, 1e-12))[:, None]).astype(np.float32), b0


# --------------------------------------------------------------- the sweep
def _ref_bits(ref: torch.Tensor, M: int) -> torch.Tensor:
    h, w = ref.shape
    rows = torch.arange(-M, h + M, device=ref.device).clamp(0, h - 1)
    cols = torch.arange(-M, w + M, device=ref.device).clamp(0, w - 1)
    padded = ref[rows][:, cols]
    return torch.stack([padded[M + dy: M + dy + h, M + dx: M + dx + w] < ref
                        for dy in range(-M, M + 1) for dx in range(-M, M + 1)
                        if (dy, dx) != (0, 0)])


def reciprocal_f32(n: int) -> float:
    return float(np.float32(1.0) / np.float32(n))


def _sweep_chunk(src_images, ref_bits, sh, patch, valid_mean, topk):
    """Fused cost and in-view count (DC, H, W) of a chunk of planes: each
    source shifted bilinearly (zero outside), census-compared with the
    reference, the ceiling where the shifted pixel leaves the image."""
    S, h, w = src_images.shape
    M = patch // 2
    dev = src_images.device
    su, sv = sh[..., 0], sh[..., 1]
    i0, j0 = torch.floor(su), torch.floor(sv)
    fu, fv = su - i0, sv - j0
    rows = torch.arange(-M, h + M + 1, device=dev) + j0.to(torch.int64)[..., None]
    cols = torch.arange(-M, w + M + 1, device=dev) + i0.to(torch.int64)[..., None]
    s_idx = torch.arange(S, device=dev)[None, :, None, None]
    win = src_images[s_idx, rows.clamp(0, h - 1)[..., :, None], cols.clamp(0, w - 1)[..., None, :]]
    inb = ((rows >= 0) & (rows < h))[..., :, None] & ((cols >= 0) & (cols < w))[..., None, :]
    win = torch.where(inb, win, 0.0)
    fu4, fv4 = fu[..., None, None], fv[..., None, None]
    top = win[..., :-1, :-1] * (1.0 - fu4) + win[..., :-1, 1:] * fu4
    bot = win[..., 1:, :-1] * (1.0 - fu4) + win[..., 1:, 1:] * fu4
    warped = top * (1.0 - fv4) + bot * fv4
    center = warped[..., M: M + h, M: M + w]
    ham = torch.zeros(center.shape, dtype=torch.int32, device=dev)
    bit = 0
    for dy in range(-M, M + 1):
        for dx in range(-M, M + 1):
            if (dy, dx) == (0, 0):
                continue
            nb = warped[..., M + dy: M + dy + h, M + dx: M + dx + w]
            ham += (nb < center) != ref_bits[bit]
            bit += 1
    u = torch.arange(w, dtype=torch.float32, device=dev)
    v = torch.arange(h, dtype=torch.float32, device=dev)
    su2, sv2 = (i0 + fu)[..., None], (j0 + fv)[..., None]
    ok = (((v + sv2 >= 0.0) & (v + sv2 <= h - 1.0))[..., :, None]
          & ((u + su2 >= 0.0) & (u + su2 <= w - 1.0))[..., None, :])
    nv = ok.sum(dim=1, dtype=torch.int32)
    cost = ham.to(torch.float32)
    ceiling = float(patch * patch - 1)
    if topk is not None:
        best = torch.topk(torch.where(ok, cost, ceiling), topk, dim=1, largest=False).values
        fused = best.sum(dim=1) * reciprocal_f32(topk)
    elif valid_mean:
        fused = torch.where(ok, cost, 0.0).sum(dim=1) / nv.clamp_min(1).to(torch.float32)
    else:
        fused = torch.where(ok, cost, ceiling).sum(dim=1) * reciprocal_f32(S)
    return fused, nv


def sweep_volume(ref, src_images, sh, patch, fusion, topk):
    """(fused (H, W, D) float32, in-view count (H, W, D) int32)."""
    S = src_images.shape[0]
    valid_mean = fusion == "mean"
    k = topk if fusion == "topk_mean" and 1 <= topk < S else None
    if fusion not in ("mean", "topk_mean"):
        raise ValueError(f"the reference fuses by mean or topk_mean, not {fusion!r}")
    bits = _ref_bits(ref, patch // 2)
    outs = [_sweep_chunk(src_images, bits, sh[i: i + PLAIN_PLANE_CHUNK], patch, valid_mean, k)
            for i in range(0, sh.shape[0], PLAIN_PLANE_CHUNK)]
    return (torch.cat([o[0] for o in outs]).permute(1, 2, 0).contiguous(),
            torch.cat([o[1] for o in outs]).permute(1, 2, 0).contiguous())


# ---------------------------------------------------------- the refinement
def box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sum over a k x k window of the last two axes, zero outside."""
    if k <= 1:
        return x
    r = k // 2

    def along(a, dim):
        n = a.shape[dim]
        c = torch.cumsum(a, dim=dim)
        hi = c.index_select(dim, (torch.arange(n, device=a.device) + r).clamp(max=n - 1))
        lo_idx = torch.arange(n, device=a.device) - r - 1
        lo = c.index_select(dim, lo_idx.clamp(min=0))
        shape = [1] * a.dim()
        shape[dim] = n
        return hi - torch.where((lo_idx >= 0).reshape(shape), lo, 0.0)

    return along(along(x, -1), -2)


def _static_shift(padded, su: float, sv: float, pad: int, h: int, w: int):
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
    total_c = box_sum(diffs.sum(dim=0), window)
    total_n = box_sum(oks.sum(dim=0), window)
    fused = total_c / torch.clamp_min(total_n, 1.0)
    return torch.where(total_n > 0, fused, _BIG), total_n > 0


def refine(reference, aux, bl, disparity, mask, radius: int, step: float, window: int,
           subpixel: bool, max_disparity: float) -> torch.Tensor:
    """One refinement pass over the static candidate stack: every integer
    step along each view's epipolar line is one uniform shift of the view;
    the candidates blend two stack entries; the box-filtered absolute
    difference fused over the in-view views scores them; WTA and a parabola
    over the offsets give the new disparity."""
    h, w = reference.shape
    num = 2 * radius + 1
    offsets = (np.arange(num, dtype=np.float64) - radius) * step
    off_hi = abs(radius * step)
    v_iota = torch.arange(h, dtype=reference.dtype, device=reference.device)[:, None].expand(h, w)
    u_iota = torch.arange(w, dtype=reference.dtype, device=reference.device)[None, :].expand(h, w)
    stacks = []
    for v in range(aux.shape[0]):
        bu, bv = float(bl[v, 0]), float(bl[v, 1])
        blen = float(np.hypot(bu, bv))
        if blen < 1e-12:
            ux = uy = 0.0
            s_lo = s_hi = 0
        else:
            ux, uy = bu / blen, bv / blen
            s_lo = int(np.floor(-off_hi * blen))
            s_hi = int(np.ceil((max_disparity + off_hi) * blen))
        pad_v = int(np.ceil(max(abs(s_lo), abs(s_hi)) * max(abs(ux), abs(uy)))) + 2
        padded = torch.nn.functional.pad(aux[v], (pad_v,) * 4)
        stack = torch.stack([_static_shift(padded, s * ux, s * uy, pad_v, h, w)
                             for s in range(s_lo, s_hi + 1)])
        stacks.append((stack, s_lo, s_hi, blen, bu, bv))

    def ok_mask(delta, bu, bv):
        d_new = disparity + delta
        return ((u_iota + d_new * bu >= 0.0) & (u_iota + d_new * bu <= w - 1.0)
                & (v_iota + d_new * bv >= 0.0) & (v_iota + d_new * bv <= h - 1.0)
                & (d_new > 0.0))

    def at(stack, s_lo, s_hi, j):
        return torch.gather(stack, 0, (j.clamp(s_lo, s_hi) - s_lo)[None])[0]

    q_ints = [int(round(step * b[3])) for b in stacks]
    per = []
    if all(abs(step * b[3] - q) < 1e-9 for b, q in zip(stacks, q_ints)):
        warped_all = []
        for (stack, s_lo, s_hi, blen, _, _), q in zip(stacks, q_ints):
            t0 = (disparity - radius * step) * blen
            i0f = torch.floor(t0)
            f = t0 - i0f
            i0 = i0f.to(torch.int64)
            warped_all.append([(1.0 - f) * at(stack, s_lo, s_hi, i0 + o * q)
                               + f * at(stack, s_lo, s_hi, i0 + o * q + 1) for o in range(num)])
        for o, delta in enumerate(offsets):
            oks = [ok_mask(float(delta), b[4], b[5]) for b in stacks]
            diffs = [torch.where(ok, (reference - wv[o]).abs(), 0.0)
                     for ok, wv in zip(oks, warped_all)]
            per.append(_fuse(torch.stack(diffs), torch.stack(oks).to(reference.dtype), window))
    else:
        for delta in offsets:
            diffs, oks = [], []
            for stack, s_lo, s_hi, blen, bu, bv in stacks:
                t = ((disparity + float(delta)) * blen).clamp(s_lo, s_hi)
                s0 = torch.floor(t)
                w0 = torch.clamp_min(1.0 - (t - s0).abs(), 0.0)
                w1 = torch.clamp_min(1.0 - (t - (s0 + 1.0)).abs(), 0.0)
                j = s0.to(torch.int64)
                warped = w0 * at(stack, s_lo, s_hi, j) + w1 * at(stack, s_lo, s_hi, j + 1)
                ok = ok_mask(float(delta), bu, bv)
                diffs.append(torch.where(ok, (reference - warped).abs(), 0.0))
                oks.append(ok)
            per.append(_fuse(torch.stack(diffs), torch.stack(oks).to(reference.dtype), window))
    costs = torch.stack([p[0] for p in per])
    any_valid = torch.stack([p[1] for p in per])

    best_cost, best = torch.min(costs, dim=0)

    def pick(vol, idx):
        return torch.gather(vol, 0, idx[None])[0]

    valid = pick(any_valid, best)
    delta = (best.to(costs.dtype) - (num - 1) / 2.0) * step
    if subpixel and num >= 3:
        bm = best.clamp(1, num - 2)
        cm1, c0, cp1 = pick(costs, bm - 1), pick(costs, bm), pick(costs, bm + 1)
        denom = cm1 - 2.0 * c0 + cp1
        nonflat = denom.abs() > 1e-9
        frac = torch.where(nonflat, 0.5 * (cm1 - cp1) / torch.where(nonflat, denom, 1.0), 0.0)
        frac = frac.clamp(-0.5, 0.5)
        interior = (best >= 1) & (best <= num - 2)
        delta = delta + torch.where(interior, frac, 0.0) * step
    apply = valid & mask
    return torch.clamp_min(torch.where(apply, disparity + delta, disparity), 0.0)


def _guarded_inverse(x: torch.Tensor, scale: float, eps: float) -> torch.Tensor:
    ok = x > eps
    bf = torch.tensor(scale, dtype=x.dtype)
    return torch.where(ok, bf / torch.where(ok, x, 1.0), 0.0)


# ------------------------------------------------------------ the pipeline
def depth(images: torch.Tensor, rig: Dict[str, np.ndarray], cfg: Dict,
          refine_dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
    """Depth of the grid-centre view from an (N, H, W) frame-set: the sweep's
    depth, the refined depth and the validity. ``cfg`` is the ``engine``
    group of a configuration file (camera, plane_sweep, sgm, refine)."""
    ps, sgm, rf, cam = cfg["plane_sweep"], cfg["sgm"], cfg["refine"], cfg["camera"]
    images = images.to(torch.float32)
    n, h, w = images.shape
    ref_i, src = reference_and_sources(cam["rows"], cam["cols"], ps["topology"])
    if ps["cost"] != "census":
        raise ValueError("the reference sweeps census costs only")
    depths = inverse_depth_samples(ps["z_near"], ps["z_far"], ps["num_planes"])
    sh = torch.from_numpy(shifts(rig, ref_i, src, depths)).to(images.device)
    sh = sh.to(torch.float32).transpose(0, 1).contiguous()
    ref = images[ref_i].contiguous()
    src_images = torch.stack([images[i] for i in src])
    vol, nv = sweep_volume(ref, src_images, sh, ps["patch"], ps["fusion"], ps["topk"])

    # quantized plane volume -> integer SGM over the planes -> extraction
    D = vol.shape[-1]
    ceiling = float(ps["patch"] * ps["patch"] - 1)
    pens = (sgm["p1"], sgm["p2"], sgm["p2_min"])
    scale = PLANE_COST_SCALE
    if not (all(round(p * scale) >= 1 for p in pens if p > 0)
            and 8 * (ceiling + max(pens)) * scale < 30000):
        raise ValueError("the reference quantizes the plane volume; these penalties do not")
    q = torch.round(vol * scale).to(torch.int8 if round(ceiling * scale) <= 127 else torch.int16)
    p2_y, p2_x = plain.p2_maps(ref, round(sgm["p2"] * scale), round(sgm["p2_min"] * scale),
                               sgm["adaptive_p2"])
    total = plain.sgm_total(q, p2_y, p2_x, round(sgm["p1"] * scale), sgm["num_paths"])
    maps = plain.extract_maps(total, True, 0.0, 0.0)
    k = maps.disparity
    k_int = torch.round(k).to(torch.int32).clamp(0, D - 1)
    inv_near, inv_far = 1.0 / ps["z_near"], 1.0 / ps["z_far"]
    inv_depth = k * ((inv_far - inv_near) / max(ps["num_planes"] - 1, 1)) + inv_near
    sweep_depth = torch.reciprocal(inv_depth.clamp_min(1e-9))
    valid = torch.gather(nv, -1, k_int.to(torch.int64)[..., None])[..., 0] >= 2
    sweep_depth = torch.where(valid, sweep_depth, 0.0)

    # refinement in disparity space, from the rig's baselines
    bl, b0 = baselines(rig, ref_i, src)
    f_px = float(rig["fx"][ref_i])
    disparity = _guarded_inverse(sweep_depth, b0 * f_px, 1e-9)
    d_ceiling = f_px * b0 / ps["z_near"] + (
        abs(rf["radius"] * rf["step"]) + 0.5 * abs(rf["step"])) * max(rf["iterations"], 1)
    ref_img = images[ref_i].to(refine_dtype)
    aux = torch.stack([images[i] for i in src]).to(refine_dtype)
    refined = disparity.to(refine_dtype)
    for _ in range(max(rf["iterations"], 0)):
        refined = refine(ref_img, aux, bl, refined, valid, rf["radius"], rf["step"],
                         rf["window"], rf["subpixel"], d_ceiling)
    refined = refined.to(torch.float32)
    refined_depth = torch.where(valid, _guarded_inverse(refined, b0 * f_px, 1e-6), 0.0)
    return {"depth": sweep_depth, "refined_depth": refined_depth, "valid": valid}

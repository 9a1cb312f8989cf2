"""N-view plane-sweep depth over the camera array (twin of
``stereovisionarray_tpu/models/plane_sweep.py``).

The sweep builds an (H, W, D) cost volume over D fronto-parallel planes
uniform in inverse depth, fusing every source view's cost per plane; SGM over
the plane index, WTA and a parabola then give a fractional plane per pixel.

Routes, as in the reference:

 - census cost, mean or top-k fusion, translation-only rig (``shift_pad >
   0``): the fused sweep K8 (``ops/sweep_cuda.py``; the kernel on a CUDA
   tensor, its plain twin on the CPU or with ``backend="torch"``; the chain
   below with ``backend="xla"``);
 - any other translation-rig sweep (``fusion="min"``, SAD or ZNCC costs):
   the per-plane chain of shift warp, per-view cost and fusion, plain
   PyTorch on every device (the reference runs it in XLA);
 - a general rig (``shift_pad == 0``): the same chain over plane
   homographies.

:func:`_volume_to_maps` follows the reference's Pallas branch. It quantizes
the fused volume (``round(vol * 4)``, int8 when the scaled ceiling fits, else
int16; ``round(vol * 512)`` for ZNCC) and runs the SGM path scans K2/K3 and
the extraction maps K4. Penalties that do not quantize (ZNCC under the default
SGM: 8 * (2 + 96) * 512 > 30000) run float SGM (K7, the ``wdh`` order of the
reference's ``sgm_extract_fused_wdh``) and the standalone extraction K6;
``sgm_cfg=None`` runs K6 alone (raw WTA) on the quantized volume. With
``backend="xla"`` the volume comes from the per-plane chain and the maps from
the plain twin of the reference's XLA branch (float SGM, WTA, parabola).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from stereovisionarray_tpu_torch.config import PlaneSweepConfig, SGMConfig
from stereovisionarray_tpu_torch.backend import host_to_device, resolve_backend
from stereovisionarray_tpu_torch.geometry.camera import CameraArray
from stereovisionarray_tpu_torch.geometry.epipolar import inverse_depth_samples
from stereovisionarray_tpu_torch.ops.census import census_transform, hamming_distance
from stereovisionarray_tpu_torch.ops.confidence import confidence_from_volume, pkrn_confidence
from stereovisionarray_tpu_torch.ops.extract_cuda import extract_disparity_maps, extract_maps
from stereovisionarray_tpu_torch.ops.sgm import p2_maps, sgm_aggregate, sum_dtype
from stereovisionarray_tpu_torch.ops.sgm_cuda import sgm_aggregate_float, sgm_aggregate_paths
from stereovisionarray_tpu_torch.ops.sweep_cuda import plane_sweep_census, reciprocal_f32
from stereovisionarray_tpu_torch.ops.warp import homography_warp
from stereovisionarray_tpu_torch.ops.wta import subpixel_refine, winner_take_all

__all__ = [
    "PlaneSweepOutput",
    "plane_sweep_depth",
    "plane_sweep_volume",
    "translation_shifts",
]

# fixed-point scale of the quantized plane volume: 4 for census and SAD
# whatever the storage dtype (the two-view int8 costs use scale 1; this does not)
PLANE_COST_SCALE = 4
ZNCC_COST_SCALE = 512
CEILINGS = {"sad": 255.0, "zncc": 2.0}


class PlaneSweepOutput(NamedTuple):
    depth: torch.Tensor  # (H, W) float32 fused depth, 0 where invalid
    plane: torch.Tensor  # (H, W) float32 fractional winning plane index
    cost: torch.Tensor  # (H, W) winning fused cost
    valid: torch.Tensor  # (H, W) bool
    num_views: torch.Tensor  # (H, W) int32 in-view sources at the winning plane
    confidence: Optional[torch.Tensor] = None  # (H, W) PKRN in [0, 1), 0 invalid


def translation_shifts(cameras: CameraArray, ref_index: int, src, depths) -> np.ndarray:
    """(S, D, 2) float32 per-view, per-plane pixel shifts (su, sv) of the
    translation-only rig, on the host:

        su(d) = fx_s * (t_s - t_ref).x / d + (cx_s - cx_ref)   (sv alike)

    in the reference's float32 operation order; `depths` is (D,) numpy."""
    return shifts_at_inverse_depths(cameras, ref_index, src,
                                    np.float32(1.0) / depths.astype(np.float32))


def shifts_at_inverse_depths(cameras: CameraArray, ref_index: int, src, inv_d) -> np.ndarray:
    """:func:`translation_shifts` at (D,) float32 inverse depths ``1 / d``."""
    host = cameras.host()
    src = np.atleast_1d(np.asarray(src, dtype=np.int64))
    n = host.t.shape[0]
    fx, fy, cx, cy = (np.broadcast_to(a, (n,)) for a in (host.fx, host.fy, host.cx, host.cy))
    t_rel = host.t[src] - host.t[ref_index]
    su = fx[src][:, None] * t_rel[:, 0:1] * inv_d[None, :] + (cx[src] - cx[ref_index])[:, None]
    sv = fy[src][:, None] * t_rel[:, 1:2] * inv_d[None, :] + (cy[src] - cy[ref_index])[:, None]
    return np.stack([su, sv], axis=-1).astype(np.float32)


def _box_filter(x: torch.Tensor, k: int) -> torch.Tensor:
    """(..., H, W) k x k mean filter over an edge-padded image, by two
    separable cumulative sums."""
    if k <= 1:
        return x
    p = k // 2

    def along(a, dim):
        n = a.shape[dim]
        idx = torch.arange(-(p + 1), n + p, device=a.device).clamp(0, n - 1)
        c = torch.cumsum(a.index_select(dim, idx), dim=dim)
        return (c.narrow(dim, k, n) - c.narrow(dim, 0, n)) / k

    return along(along(x, -1), -2)


def _view_cost(ref, ref_census, warped, valid, cfg: PlaneSweepConfig):
    """Per-view photoconsistency cost, the ceiling where the view is out of
    view."""
    if cfg.cost == "census":
        c = hamming_distance(ref_census, census_transform(warped, (cfg.patch, cfg.patch)))
        ceiling = float(cfg.patch * cfg.patch - 1)
    elif cfg.cost == "sad":
        c = _box_filter((ref - warped).abs(), cfg.patch)
        ceiling = CEILINGS["sad"]
    elif cfg.cost == "zncc":
        mu_r = _box_filter(ref, cfg.patch)
        mu_w = _box_filter(warped, cfg.patch)
        var_r = _box_filter(ref * ref, cfg.patch) - mu_r * mu_r
        var_w = _box_filter(warped * warped, cfg.patch) - mu_w * mu_w
        cov = _box_filter(ref * warped, cfg.patch) - mu_r * mu_w
        ncc = cov * torch.rsqrt(torch.clamp_min(var_r * var_w, 1e-6))
        c = 1.0 - ncc.clamp(-1.0, 1.0)
        ceiling = CEILINGS["zncc"]
    else:
        raise ValueError(f"unknown plane-sweep cost {cfg.cost!r}")
    return torch.where(valid, c, ceiling)


def _fuse_views(costs, valids, cfg: PlaneSweepConfig) -> torch.Tensor:
    """Fuse (..., S, H, W) per-view costs over the view axis."""
    if cfg.fusion == "min":
        return costs.amin(dim=-3)
    if cfg.fusion == "mean":
        n = valids.sum(dim=-3).clamp_min(1)
        return torch.where(valids, costs, 0.0).sum(dim=-3) / n
    if cfg.fusion == "topk_mean":
        k = min(cfg.topk, costs.shape[-3])
        if k < costs.shape[-3]:
            costs = torch.topk(costs, k, dim=-3, largest=False).values
        return costs.sum(dim=-3) * reciprocal_f32(k)  # the reference's compiled mean
    raise ValueError(f"unknown fusion {cfg.fusion!r}")


def _shift_warp(padded: torch.Tensor, shifts: torch.Tensor, h: int, w: int,
                pad: int) -> torch.Tensor:
    """Sample `pad`-padded sources (S, H+2p, W+2p) at uniform subpixel shifts
    (DC, S, 2): ``out[y, x] = src[y + sv, x + su]``, bilinear. Each corner is
    a window whose start is clamped into the padded image, as a dynamic
    slice's is."""
    S = padded.shape[0]
    dev = padded.device
    su, sv = shifts[..., 0], shifts[..., 1]
    j0, i0 = torch.floor(sv), torch.floor(su)
    fv, fu = (sv - j0)[..., None, None], (su - i0)[..., None, None]
    y0, x0 = (pad + j0).to(torch.int64), (pad + i0).to(torch.int64)
    s_idx = torch.arange(S, device=dev)[None, :, None, None]
    ys, xs = torch.arange(h, device=dev), torch.arange(w, device=dev)

    def sl(dy, dx):
        r = (y0 + dy).clamp(0, 2 * pad)[..., None] + ys
        c = (x0 + dx).clamp(0, 2 * pad)[..., None] + xs
        return padded[s_idx, r[..., :, None], c[..., None, :]]

    top = sl(0, 0) * (1.0 - fu) + sl(0, 1) * fu
    bot = sl(1, 0) * (1.0 - fu) + sl(1, 1) * fu
    return top * (1.0 - fv) + bot * fv


def _shift_chain_volume(ref, src_images, shifts, cfg: PlaneSweepConfig, shift_pad: int):
    """The per-plane chain over uniform shifts (D, S, 2): shift warp (the
    warped image edge-clamped for the census), per-view cost, fusion.
    Returns (fused (H, W, D), nviews (H, W, D) int32)."""
    S, h, w = src_images.shape
    dev = ref.device
    pad = shift_pad + 1
    padded = torch.nn.functional.pad(src_images, (pad, pad, pad, pad))
    ref_census = census_transform(ref, (cfg.patch, cfg.patch)) if cfg.cost == "census" else None
    v = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    u = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    chunk = max(1, cfg.plane_chunk)
    fused, nviews = [], []
    for i in range(0, shifts.shape[0], chunk):
        sh = shifts[i: i + chunk]
        warped = _shift_warp(padded, sh, h, w, pad)
        su, sv = sh[..., 0, None, None], sh[..., 1, None, None]
        ok = (u + su >= 0.0) & (u + su <= w - 1.0) & (v + sv >= 0.0) & (v + sv <= h - 1.0)
        fused.append(_fuse_views(_view_cost(ref, ref_census, warped, ok, cfg), ok, cfg))
        nviews.append(ok.sum(dim=1, dtype=torch.int32))
    return (torch.cat(fused).permute(1, 2, 0).contiguous(),
            torch.cat(nviews).permute(1, 2, 0).contiguous())


def _homography_volume(ref, src_images, cameras, ref_index, src, depths,
                       cfg: PlaneSweepConfig):
    """The per-plane chain over the fronto-plane homographies of a general rig.
    The (S, D, 3, 3) homographies are computed from the rig's host copy on
    the CPU and handed to the images' device (pinned, ``non_blocking``): a
    calibrated rig on the card is never read back."""
    host = CameraArray(*(torch.from_numpy(a) for a in cameras.host()))
    H_all = host_to_device(host.fronto_plane_homography(ref_index, src, depths), ref.device)
    ref_census = census_transform(ref, (cfg.patch, cfg.patch)) if cfg.cost == "census" else None
    fused, nviews = [], []
    for d in range(H_all.shape[1]):
        pairs = [homography_warp(img, H_all[s, d]) for s, img in enumerate(src_images)]
        warped = torch.stack([p[0] for p in pairs])
        ok = torch.stack([p[1] for p in pairs])
        fused.append(_fuse_views(_view_cost(ref, ref_census, warped, ok, cfg), ok, cfg))
        nviews.append(ok.sum(dim=0, dtype=torch.int32))
    return torch.stack(fused, dim=-1), torch.stack(nviews, dim=-1)


def plane_sweep_volume(
    images: torch.Tensor,
    cameras: CameraArray,
    ref_index: int,
    src_indices: tuple,
    cfg: PlaneSweepConfig = PlaneSweepConfig(),
    shift_pad: int = 0,
    depths=None,
    backend: str = "auto",
    shifts=None,
):
    """The fused (H, W, D) plane-sweep cost volume, the (H, W, D) int32 count
    of in-view sources, and the (D,) plane depths.

    images: (N, H, W); src_indices: source view ids. shift_pad > 0 selects
    the translation-only path and must bound the largest |shift|.
    depths: explicit (D,) float32 plane depths (numpy or tensor) in place of
    the config's inverse-depth samples. shifts: explicit (S, D, 2) per-view,
    per-plane pixel shifts (su, sv) in place of :func:`translation_shifts`,
    on the translation path only (the cascade's fine pass sweeps residual
    shifts that no camera geometry describes; ``cameras`` is unused then)."""
    images = images.to(torch.float32)
    ref = images[ref_index].contiguous()
    src = [int(s) for s in src_indices]
    if depths is None:
        depths = inverse_depth_samples(cfg.z_near, cfg.z_far, cfg.num_planes)
    elif isinstance(depths, torch.Tensor):
        depths = depths.detach().cpu().numpy()
    depths = np.asarray(depths, dtype=np.float32)
    depths_t = host_to_device(depths, images.device).clone()  # returned: the caller's own
    src_images = torch.stack([images[i] for i in src])  # a list index would be copied to the card
    xla = resolve_backend(images, backend) == "xla"  # also validates against the device
    if shifts is not None and shift_pad <= 0:
        raise ValueError("explicit shifts require the translation fast path (shift_pad > 0)")

    if shift_pad <= 0:
        vol, nv = _homography_volume(ref, src_images, cameras, ref_index, src, depths, cfg)
        return vol, nv, depths_t

    if shifts is None:
        shifts = translation_shifts(cameras, ref_index, src, depths)
    if not isinstance(shifts, torch.Tensor):
        shifts = np.asarray(shifts, dtype=np.float32)
    shifts = host_to_device(shifts, images.device).to(torch.float32).transpose(0, 1).contiguous()
    S = len(src)
    mean_fusion = cfg.fusion == "mean" or (cfg.fusion == "topk_mean" and cfg.topk >= S)
    kernel_topk = (int(cfg.topk) if cfg.fusion == "topk_mean" and 1 <= cfg.topk < S else None)
    if cfg.cost == "census" and (mean_fusion or kernel_topk is not None) and not xla:
        vol, nv = plane_sweep_census(ref, src_images, shifts, patch=cfg.patch,
                                     valid_mean=cfg.fusion == "mean", topk=kernel_topk,
                                     backend=backend)
    else:
        vol, nv = _shift_chain_volume(ref, src_images, shifts, cfg, shift_pad)
    return vol, nv, depths_t


def _volume_to_maps(vol: torch.Tensor, ref_image: torch.Tensor, cfg: PlaneSweepConfig,
                    sgm_cfg: Optional[SGMConfig], backend: str):
    """(H, W, D) fused cost volume -> (k fractional plane, cost, PKRN
    confidence, k_int), each (H, W), as the reference's Pallas branch
    (or, with ``backend="xla"``, its XLA branch) computes them."""
    D = vol.shape[-1]
    if resolve_backend(vol, backend) == "xla":
        if sgm_cfg is not None:
            vol = sgm_aggregate(vol, sgm_cfg.p1, sgm_cfg.p2, sgm_cfg.num_paths, ref_image,
                                sgm_cfg.adaptive_p2, sgm_cfg.p2_min)
        k_int, cost = winner_take_all(vol)
        return subpixel_refine(vol, k_int), cost, confidence_from_volume(vol, k_int), k_int

    scale = ZNCC_COST_SCALE if cfg.cost == "zncc" else PLANE_COST_SCALE
    ceiling = float(cfg.patch * cfg.patch - 1) if cfg.cost == "census" else CEILINGS[cfg.cost]
    pens = (sgm_cfg.p1, sgm_cfg.p2, sgm_cfg.p2_min) if sgm_cfg is not None else ()
    quantize = all(round(p * scale) >= 1 for p in pens if p > 0) and (
        8 * (ceiling + max(pens, default=0.0)) * scale < 30000)
    if quantize:
        pen = lambda v: round(v * scale)  # noqa: E731  (Python round: half to even)
        vol_dtype = torch.int8 if round(ceiling * scale) <= 127 else torch.int16
        q = torch.round(vol * scale).to(vol_dtype)
    else:
        scale = 1
        pen = lambda v: v  # noqa: E731
        q = vol.to(torch.float32).contiguous()
    if sgm_cfg is None:  # raw WTA over the (quantized) volume: K6
        maps = extract_disparity_maps(q, True, 0.0, 0.0, backend)
    else:
        h, w = ref_image.shape
        p2_y, p2_x = p2_maps((h, w), pen(sgm_cfg.p2), sum_dtype(q.dtype), vol.device, ref_image,
                             sgm_cfg.adaptive_p2, pen(sgm_cfg.p2_min))
        if quantize:  # integer total (K2/K3): K4
            total = sgm_aggregate_paths(q, p2_y, p2_x, pen(sgm_cfg.p1), sgm_cfg.num_paths,
                                        backend)
            maps = extract_maps(total, True, 0.0, backend, right=False)  # nothing reads it
        else:  # float total (K7, wdh order): K6
            total = sgm_aggregate_float(q, p2_y, p2_x, sgm_cfg.p1, sgm_cfg.num_paths,
                                        order="wdh", backend=backend)
            maps = extract_disparity_maps(total, True, 0.0, 0.0, backend)
    k = maps.disparity
    k_int = torch.round(k).to(torch.int32).clamp(0, D - 1)
    return k, maps.cost / scale, pkrn_confidence(maps.cost, maps.second), k_int


def plane_sweep_depth(
    images: torch.Tensor,
    cameras: CameraArray,
    ref_index: int,
    src_indices: tuple,
    cfg: PlaneSweepConfig = PlaneSweepConfig(),
    sgm_cfg: Optional[SGMConfig] = SGMConfig(lr_max_diff=0.0),
    min_views: int = 2,
    mask: Optional[torch.Tensor] = None,
    backend: str = "auto",
    shift_pad: int = 0,
) -> PlaneSweepOutput:
    """Fused N-view depth of the reference view: plane sweep, SGM over the
    plane index, WTA + parabola in inverse depth; pixels seen by fewer than
    `min_views` sources at their winning plane are invalid.

    backend: "auto" (kernels for CUDA tensors, plain PyTorch for CPU
    tensors), "cuda" (kernels, CUDA tensors only) or "torch" (plain PyTorch)."""
    images = images.to(torch.float32)
    vol, nv, _ = plane_sweep_volume(images, cameras, ref_index, src_indices, cfg,
                                    shift_pad=shift_pad, backend=backend)
    k, cost, conf, k_int = _volume_to_maps(vol, images[ref_index].contiguous(), cfg, sgm_cfg,
                                           backend)
    inv_near = 1.0 / cfg.z_near
    inv_far = 1.0 / cfg.z_far
    step = (inv_far - inv_near) / max(cfg.num_planes - 1, 1)
    inv_depth = k * step + inv_near
    depth = torch.reciprocal(inv_depth.clamp_min(1e-9))
    views_at_win = torch.gather(nv, -1, k_int.to(torch.int64)[..., None])[..., 0]
    valid = views_at_win >= min_views
    if mask is not None:
        valid = valid & mask
    return PlaneSweepOutput(
        depth=torch.where(valid, depth, 0.0), plane=k, cost=cost, valid=valid,
        num_views=views_at_win, confidence=torch.where(valid, conf, 0.0),
    )

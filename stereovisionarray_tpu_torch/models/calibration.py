"""Array calibration: images -> features -> matches -> tracks -> BA (twin of
``stereovisionarray_tpu/models/calibration.py``).

The rig is measured from its own images, starting from a coarse guess of
its extrinsics (the intrinsics are trusted). Tracks are anchored on the
reference view: every view is matched against it, and a track is one
reference feature with its matches, so the observation table has the fixed
shape (views, max_features). Every stage runs on the images' device without
reading it on the host; the result's cameras carry their numpy copy
(``host_fields``), made by the one copy back at the end, so the array
pipeline never reads a calibrated rig back from the card.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from stereovisionarray_tpu_torch.backend import host_to_device
from stereovisionarray_tpu_torch.config import SfMConfig
from stereovisionarray_tpu_torch.geometry.camera import CameraArray, HostCameras
from stereovisionarray_tpu_torch.geometry.distortion import Distortion, undistort_points
from stereovisionarray_tpu_torch.sfm.ba import BAProblem, BAState, _at, bundle_adjust
from stereovisionarray_tpu_torch.sfm.features import describe_patches, detect_features
from stereovisionarray_tpu_torch.sfm.matching import match_descriptors
from stereovisionarray_tpu_torch.sfm.refine import lk_refine
from stereovisionarray_tpu_torch.sfm.segments import Segments
from stereovisionarray_tpu_torch.sfm.triangulate import reprojection_errors, triangulate_midpoint

__all__ = ["CalibrationResult", "build_tracks", "calibrate_array"]


class CalibrationResult(NamedTuple):
    cameras: CameraArray  # refined cameras, with their host copy
    points: torch.Tensor  # (F, 3) triangulated and refined track points
    point_valid: torch.Tensor  # (F,) bool
    cost: torch.Tensor  # BA cost trajectory of the last round
    num_obs: torch.Tensor  # 0-dim: valid observations used
    mean_reproj: torch.Tensor  # 0-dim: mean reprojection error (px) after BA
    # a tukey BA zero-weights gross outliers, so the quality number of record
    # is the mean over the inliers; the cut and the outlier share beside it
    inlier_reproj: torch.Tensor
    inlier_threshold_px: torch.Tensor
    outlier_fraction: torch.Tensor
    distortion: Optional[tuple] = None  # (k1, k2) when estimate_distortion


def build_tracks(images: torch.Tensor, ref_index: int, cfg: SfMConfig = SfMConfig()):
    """Detect and describe on every view, match every view to the reference,
    align each match to its reference patch (LK).

    images (N, H, W). Returns (uv (N, F, 2), valid (N, F) bool): column f
    across the views is the track of reference feature f, the reference
    view's own observation included."""
    images = images.to(torch.float32)
    n = images.shape[0]
    uv_all, _, ok_all = detect_features(images, max_features=cfg.max_features, k=cfg.harris_k,
                                        nms_radius=cfg.nms_radius)
    desc_all = describe_patches(images, uv_all, patch=cfg.descriptor_patch)
    ref_uv, ref_ok = uv_all[ref_index], ok_all[ref_index]
    m = match_descriptors(desc_all[ref_index], desc_all, ref_ok, ok_all, ratio=cfg.match_ratio)
    obs_uv = torch.gather(uv_all, 1, m.idx_b.to(torch.int64)[..., None].expand(-1, -1, 2))
    # LK alignment against the reference patch removes per-view detection
    # bias (millimetres of pose error otherwise)
    uv_lk, lk_ok = lk_refine(images[ref_index], ref_uv, images, obs_uv)
    is_ref = (torch.arange(n, device=images.device) == ref_index)[:, None]
    return (torch.where(is_ref[..., None], ref_uv, uv_lk),
            torch.where(is_ref, ref_ok, m.valid & lk_ok))


def _weighted_median(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The lower median of x over the entries with w > 0."""
    xf = torch.where(w > 0, x, float("inf")).reshape(-1)
    n_valid = torch.sum((w > 0).to(torch.int64))
    i = torch.clamp(torch.div(n_valid - 1, 2, rounding_mode="floor"), 0, xf.shape[0] - 1)
    return _at(torch.sort(xf).values, i)


def _radial_from_vertical_parallax(obs_uv, obs_ok, cameras: CameraArray, iterations: int = 2):
    """Closed-form (k1, k2) from the component of matched flow perpendicular
    to each pair's baseline (translation-only rigs with shared intrinsics).

    The ideal flow between two such views is parallel to their baseline for
    any scene, so the perpendicular component of the observed (distorted)
    flow is lens signal alone, linear in (k1, k2): a 2x2 weighted normal
    solve over every track and view pair, re-evaluated at the corrected
    coordinates ``iterations`` times, each with 3 tukey IRLS passes. Each
    pair's baseline axis is the principal axis of its own flow, and the
    axis error is solved out of the fit as a per-pair nuisance.

    obs_uv (N, F, 2) pixels, obs_ok (N, F); returns 0-dim (k1, k2)."""
    n = obs_uv.shape[0]
    c = torch.stack([cameras.cx, cameras.cy], dim=-1)[:, None, :]
    f = torch.stack([cameras.fx, cameras.fy], dim=-1)[:, None, :]
    xn_d = (obs_uv - c) / f
    ii, jj = (host_to_device(a.astype(np.int64), obs_uv.device)
              for a in np.triu_indices(n, k=1))
    ok_pair = obs_ok[ii] & obs_ok[jj]
    flow = xn_d[ii] - xn_d[jj]
    wf = ok_pair.to(torch.float32)
    m_xx = torch.sum(wf * flow[..., 0] * flow[..., 0], dim=1)
    m_xy = torch.sum(wf * flow[..., 0] * flow[..., 1], dim=1)
    m_yy = torch.sum(wf * flow[..., 1] * flow[..., 1], dim=1)
    theta = 0.5 * torch.arctan2(2.0 * m_xy, m_xx - m_yy)
    nonzero = (m_xx + m_yy) > 1e-12
    nperp = torch.stack([-torch.sin(theta), torch.cos(theta)], dim=-1)[:, None, :]
    uax = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)[:, None, :]
    e = torch.sum(nperp * flow, dim=-1)  # (P, F) perpendicular flow
    s = torch.sum(uax * flow, dim=-1)  # (P, F) parallel flow
    # gross-mismatch guard: true distortion parallax is well under this
    w_pair = (ok_pair & nonzero[:, None]).to(torch.float32) * (torch.abs(e) < 0.05)

    def partial_out(v, w):
        """v without each pair's best-fit multiple of s (the axis-error nuisance)."""
        num = torch.sum(w * s * v, dim=1, keepdim=True)
        den = torch.clamp(torch.sum(w * s * s, dim=1, keepdim=True), min=1e-12)
        return v - s * (num / den)

    k1 = torch.zeros((), dtype=torch.float32, device=obs_uv.device)
    k2 = torch.zeros_like(k1)
    for _ in range(iterations):
        xc = undistort_points(xn_d, Distortion(k1=k1, k2=k2))
        xci, xcj = xc[ii], xc[jj]
        r2i = torch.sum(xci * xci, dim=-1, keepdim=True)
        r2j = torch.sum(xcj * xcj, dim=-1, keepdim=True)
        g1 = torch.sum(nperp * (xci * r2i - xcj * r2j), dim=-1)
        g2 = torch.sum(nperp * (xci * r2i ** 2 - xcj * r2j ** 2), dim=-1)
        for _irls in range(3):  # tukey on the fit residual: mismatches dwarf the lens signal
            resid = e - k1 * g1 - k2 * g2
            scale = torch.clamp(1.4826 * _weighted_median(torch.abs(resid), w_pair), min=1e-6)
            t = resid / (4.685 * scale)
            w = w_pair * torch.where(torch.abs(t) < 1.0, (1.0 - t * t) ** 2, 0.0)
            ep, g1p, g2p = partial_out(e, w), partial_out(g1, w), partial_out(g2, w)
            a00, a01, a11 = torch.sum(w * g1p * g1p), torch.sum(w * g1p * g2p), torch.sum(w * g2p * g2p)
            b0, b1 = torch.sum(w * g1p * ep), torch.sum(w * g2p * ep)
            det = a00 * a11 - a01 * a01
            safe = torch.abs(det) > 1e-20
            det_s = torch.where(safe, det, 1.0)
            k1 = torch.where(safe, (b0 * a11 - b1 * a01) / det_s, 0.0)
            k2 = torch.where(safe, (b1 * a00 - b0 * a01) / det_s, 0.0)
    return k1, k2


def _with_host_copy(cams: CameraArray) -> CameraArray:
    """The rig with its float32 numpy copy: every field in one copy back."""
    fields = [cams.fx, cams.fy, cams.cx, cams.cy, cams.R, cams.t]
    flat = torch.cat([a.reshape(-1) for a in fields]).cpu().numpy()
    parts = np.split(flat, np.cumsum([a.numel() for a in fields])[:-1])
    host = HostCameras(*(p.reshape(tuple(a.shape)) for p, a in zip(parts, fields)))
    return CameraArray(*fields, host_fields=host)


def calibrate_array(images: torch.Tensor, init_cameras: CameraArray, ref_index: int,
                    cfg: SfMConfig = SfMConfig(), min_track_views: int = 3, rounds: int = 2,
                    estimate_distortion: bool = False) -> CalibrationResult:
    """Calibrate an array from images (N, H, W) and a coarse pose guess (the
    intrinsics are trusted); everything runs on the images' device.

    Tracks seen by fewer than ``min_track_views`` views leave the BA.
    ``rounds`` alternates triangulation and BA: re-triangulating through the
    refined cameras drops the structure bias of the coarse guess (a 1 cm
    error needs 2 rounds). Observations past 25x the kernel scale are
    dropped between rounds; the inlier metrics use 3x.

    estimate_distortion: solve radial (k1, k2) from vertical parallax before
    any BA (translation-only rigs, shared intrinsics), undistort the
    observations once, and report (k1, k2)."""
    n = images.shape[0]
    device = images.device
    cams = init_cameras.to(device)
    obs_uv, obs_ok = build_tracks(images, ref_index, cfg)
    F = obs_uv.shape[1]
    cam_idx = np.repeat(np.arange(n), F)
    pt_idx = np.tile(np.arange(F), n)
    ci = host_to_device(cam_idx, device)
    uv_flat = obs_uv.reshape(-1, 2)
    track_ok = torch.sum(obs_ok.to(torch.int32), dim=0) >= min_track_views
    ok_flat0 = obs_ok.reshape(-1) & track_ok.repeat(n)
    c_vec = torch.stack([cams.cx[ci], cams.cy[ci]], dim=-1)
    f_vec = torch.stack([cams.fx[ci], cams.fy[ci]], dim=-1)

    uv_work = uv_flat
    k1 = k2 = None
    if estimate_distortion:
        k1, k2 = _radial_from_vertical_parallax(obs_uv, obs_ok, cams)
        und = undistort_points((uv_flat - c_vec) / f_vec, Distortion(k1=k1, k2=k2))
        uv_work = und * f_vec + c_vec

    # two thresholds, far apart: gross mismatches leave between rounds; the
    # inlier cut of the metrics of record
    reject_px = 25.0 * cfg.huber_delta
    metric_px = 3.0 * cfg.huber_delta
    pt_segments = Segments(pt_idx, F, device)
    ok_keep = torch.ones_like(ok_flat0)
    state: BAState = None
    for _ in range(rounds):
        ok_base = ok_flat0 & ok_keep
        X0, tri_ok = triangulate_midpoint(cams, cam_idx, uv_work, ok_base, F, pt_idx,
                                          point_segments=pt_segments)
        ok_flat = ok_base & (track_ok & tri_ok).repeat(n)
        problem = BAProblem(cam_idx=cam_idx, pt_idx=pt_idx, uv=uv_work - c_vec, valid=ok_flat)
        state = bundle_adjust(cams, X0, problem, iterations=cfg.ba_iterations,
                              damping=cfg.ba_damping, huber=cfg.huber_delta, kernel="tukey")
        cams = state.cameras
        r = reprojection_errors(cams, state.points, cam_idx, pt_idx, uv_work)
        err = torch.sqrt(torch.sum(r * r, dim=-1))
        ok_keep = ok_keep & (err <= reject_px)

    w = ok_flat.to(err.dtype)
    mean_reproj = torch.sum(err * w) / torch.clamp(torch.sum(w), min=1.0)
    wi = (ok_flat & (err <= metric_px)).to(err.dtype)
    inlier_reproj = torch.sum(err * wi) / torch.clamp(torch.sum(wi), min=1.0)
    outlier_fraction = 1.0 - torch.sum(wi) / torch.clamp(torch.sum(w), min=1.0)
    return CalibrationResult(
        cameras=_with_host_copy(cams), points=state.points, point_valid=track_ok,
        cost=state.cost, num_obs=torch.sum(ok_flat.to(torch.int32)), mean_reproj=mean_reproj,
        inlier_reproj=inlier_reproj,
        inlier_threshold_px=torch.full((), metric_px, dtype=err.dtype, device=device),
        outlier_fraction=outlier_fraction,
        distortion=(k1, k2) if estimate_distortion else None)

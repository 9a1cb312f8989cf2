"""Planar stereo rectification of a general calibrated pair (twin of
``stereovisionarray_tpu/geometry/rectify.py``).

Fusiello-Trucco-Verri: the new shared rotation takes the baseline as its x
axis, y orthogonal to the baseline and the old left optical axis, z
completing the frame; both views share the mean intrinsic matrix; each
homography is the inverse of ``K_new R_new R_old^T K_old^-1``. Afterwards
``models.two_view.two_view_disparity`` applies directly. The 3x3 products are
elementwise (no TF32 GEMM) and the inverses ``inv_ex`` (no host read on the
card).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from stereovisionarray_tpu_torch.geometry.camera import CameraArray
from stereovisionarray_tpu_torch.geometry.lie import matmul3, matvec3
from stereovisionarray_tpu_torch.ops.warp import homography_warp

__all__ = ["RectifiedPair", "rectified_disparity_to_depth", "rectify_images", "rectify_pair"]


class RectifiedPair(NamedTuple):
    H_left: torch.Tensor  # (3, 3) maps NEW left pixels -> OLD left pixels
    H_right: torch.Tensor  # (3, 3) the same for the right view
    K_new: torch.Tensor  # (3, 3) shared rectified intrinsics
    baseline: torch.Tensor  # 0-dim metric baseline along the new x axis
    R_new: torch.Tensor  # (3, 3) shared rectified world-to-camera rotation


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v * v))


def rectify_pair(cameras: CameraArray, left: int, right: int) -> RectifiedPair:
    """Rectifying homographies of views (left, right) of a calibrated rig, in
    the rectified-pixels -> source-pixels direction that
    ``ops.warp.homography_warp`` consumes: the warped pair is row-aligned
    with disparity along +x."""
    K = cameras.K
    K_l, K_r = K[left], K[right]
    R_l, R_r = cameras.R[left], cameras.R[right]
    c_l = -matvec3(R_l.T, cameras.t[left])
    c_r = -matvec3(R_r.T, cameras.t[right])
    b = c_r - c_l
    baseline = _norm(b)
    x_new = b / torch.clamp(baseline, min=1e-12)
    y_new = torch.linalg.cross(R_l[2], x_new)  # orthogonal to x and the old left optical axis
    y_new = y_new / torch.clamp(_norm(y_new), min=1e-12)
    z_new = torch.linalg.cross(x_new, y_new)
    R_new = torch.stack([x_new, y_new, z_new])
    K_new = 0.5 * (K_l + K_r)

    def new_to_old(K_old, R_old):
        H_on = matmul3(matmul3(matmul3(K_new, R_new), R_old.T), torch.linalg.inv_ex(K_old)[0])
        return torch.linalg.inv_ex(H_on)[0]

    return RectifiedPair(H_left=new_to_old(K_l, R_l), H_right=new_to_old(K_r, R_r),
                         K_new=K_new, baseline=baseline, R_new=R_new)


def rectify_images(left_img: torch.Tensor, right_img: torch.Tensor, rect: RectifiedPair,
                   out_shape: Optional[Tuple[int, int]] = None):
    """Both images warped into the rectified frame:
    (left_rect, left_valid, right_rect, right_valid)."""
    lw, lv = homography_warp(left_img, rect.H_left, out_shape)
    rw, rv = homography_warp(right_img, rect.H_right, out_shape)
    return lw, lv, rw, rv


def rectified_disparity_to_depth(disparity: torch.Tensor, rect: RectifiedPair,
                                 invalid_fill: float = 0.0) -> torch.Tensor:
    """Depth along the rectified z axis, f_x,new * B / d; `invalid_fill`
    where d <= 1e-6."""
    ok = disparity > 1e-6
    depth = rect.K_new[0, 0] * rect.baseline / torch.where(ok, disparity, 1.0)
    return torch.where(ok, depth, invalid_fill)

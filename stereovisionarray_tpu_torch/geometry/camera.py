"""Batched pinhole camera model (twin of
``stereovisionarray_tpu/geometry/camera.py``).

Conventions as in the reference: world-to-camera ``x_cam = R @ X + t``,
camera centre ``C = -R^T t``, pixels ``u = fx * x/z + cx``, ``v = fy * y/z +
cy`` (u = column, v = row). Every field is a float32 tensor; the rig is the
system's state, so :func:`camera_array_from_numpy` builds it from the same
numpy arrays the reference's ``CameraArray`` holds. Host-side static
computations (shifts, pads, baselines) read :meth:`CameraArray.host`.
"""

from __future__ import annotations

from dataclasses import dataclass, fields
from typing import NamedTuple, Tuple

import numpy as np
import torch

__all__ = [
    "CameraArray",
    "camera_array_from_numpy",
    "make_camera_array",
    "translation_only_array",
]


class HostCameras(NamedTuple):
    """float32 numpy copies of a rig's fields."""

    fx: np.ndarray
    fy: np.ndarray
    cx: np.ndarray
    cy: np.ndarray
    R: np.ndarray
    t: np.ndarray


@dataclass
class CameraArray:
    """N pinhole cameras as a struct of float32 tensors: fx, fy, cx, cy (N,),
    R (N, 3, 3) world-to-camera rotation, t (N, 3) translation."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor

    def __len__(self) -> int:
        return self.fx.shape[0]

    def __getitem__(self, idx) -> "CameraArray":
        """Index every field (an int drops the camera axis)."""
        return CameraArray(*(getattr(self, f.name)[idx] for f in fields(self)))

    def to(self, device) -> "CameraArray":
        return CameraArray(*(getattr(self, f.name).to(device) for f in fields(self)))

    def host(self) -> HostCameras:
        return HostCameras(*(getattr(self, f.name).detach().cpu().numpy() for f in fields(self)))

    @property
    def centers(self) -> torch.Tensor:
        """(N, 3) camera centres, C = -R^T t."""
        return -torch.einsum("...ji,...j->...i", self.R, self.t)

    @property
    def K(self) -> torch.Tensor:
        """(N, 3, 3) intrinsics matrices."""
        z = torch.zeros_like(self.fx)
        o = torch.ones_like(self.fx)
        return torch.stack([
            torch.stack([self.fx, z, self.cx], dim=-1),
            torch.stack([z, self.fy, self.cy], dim=-1),
            torch.stack([z, z, o], dim=-1),
        ], dim=-2)

    def world_to_cam(self, points: torch.Tensor) -> torch.Tensor:
        """(..., 3) world points -> camera frame; a batched rig broadcasts
        against points shaped (N, ..., 3)."""
        if self.R.dim() == 2:
            return torch.einsum("ij,...j->...i", self.R, points) + self.t
        rotated = torch.einsum("...ij,...j->...i", self.R[..., None, :, :], points)
        return rotated + self.t[..., None, :]

    def cam_to_world(self, points_cam: torch.Tensor) -> torch.Tensor:
        """Inverse of :meth:`world_to_cam`."""
        if self.R.dim() == 2:
            return torch.einsum("ji,...j->...i", self.R, points_cam - self.t)
        return torch.einsum("...ji,...j->...i", self.R[..., None, :, :],
                            points_cam - self.t[..., None, :])

    def project(self, points: torch.Tensor, eps: float = 1e-9) -> Tuple[torch.Tensor, torch.Tensor]:
        """World points -> (uv (..., 2) pixel coords, camera-frame depth (...))."""
        pc = self.world_to_cam(points)
        z = pc[..., 2]
        small = torch.where(z < 0, -eps, eps).to(z.dtype)
        inv_z = 1.0 / torch.where(z.abs() < eps, small, z)
        fx, fy, cx, cy = self._bcast_intrinsics(z)
        u = fx * pc[..., 0] * inv_z + cx
        v = fy * pc[..., 1] * inv_z + cy
        return torch.stack([u, v], dim=-1), z

    def backproject(self, uv: torch.Tensor, depth: torch.Tensor) -> torch.Tensor:
        """Pixel coords (..., 2) + camera-frame z (...) -> world points (..., 3)."""
        fx, fy, cx, cy = self._bcast_intrinsics(uv[..., 0])
        x = (uv[..., 0] - cx) / fx * depth
        y = (uv[..., 1] - cy) / fy * depth
        return self.cam_to_world(torch.stack([x, y, depth], dim=-1))

    def _bcast_intrinsics(self, like: torch.Tensor):
        if self.fx.dim() == 0:
            return self.fx, self.fy, self.cx, self.cy
        shape = tuple(self.fx.shape) + (1,) * (like.dim() - self.fx.dim())
        return (self.fx.reshape(shape), self.fy.reshape(shape), self.cx.reshape(shape),
                self.cy.reshape(shape))

    def fronto_plane_homography(self, ref: int, src, depth) -> torch.Tensor:
        """(S, D, 3, 3) homographies mapping reference pixels to source pixels
        for the fronto-parallel planes z_ref = depth:
        ``H(d) = K_s (R_rel + t_rel n^T / d) K_r^{-1}``, n = (0, 0, 1)."""
        src = torch.atleast_1d(torch.as_tensor(src, device=self.fx.device))
        depth = torch.atleast_1d(torch.as_tensor(depth, dtype=self.fx.dtype,
                                                 device=self.fx.device))
        R_ref, t_ref = self.R[ref], self.t[ref]
        R_rel = torch.einsum("sik,jk->sij", self.R[src], R_ref)
        t_rel = self.t[src] - torch.einsum("sij,j->si", R_rel, t_ref)
        K_ref_inv = torch.linalg.inv(self.K[ref])
        n = torch.zeros(3, dtype=self.fx.dtype, device=self.fx.device)
        n[2] = 1.0  # a fill on the device: no host-to-device copy waits for the stream
        tnT = torch.einsum("si,j->sij", t_rel, n)
        mid = R_rel[:, None] + tnT[:, None] / depth[None, :, None, None]
        return torch.einsum("sij,sdjk,kl->sdil", self.K[src], mid, K_ref_inv)


def camera_array_from_numpy(fx, fy, cx, cy, R, t, device=None) -> CameraArray:
    """A rig from the reference ``CameraArray``'s fields as numpy arrays (or
    anything array-like), cast to float32, on `device`."""
    f32 = lambda x: torch.as_tensor(np.array(x, dtype=np.float32), device=device)  # noqa: E731
    return CameraArray(f32(fx), f32(fy), f32(cx), f32(cy), f32(R), f32(t))


def make_camera_array(fx, fy, cx, cy, R, t) -> CameraArray:
    """Build a CameraArray from raw arrays, cast to float32 (reference name)."""
    return camera_array_from_numpy(fx, fy, cx, cy, R, t)


def translation_only_array(focal_length: float, positions, pixel_size: float,
                           resolution: Tuple[int, int] = (0, 0), device=None) -> CameraArray:
    """Identical rotation-free cameras at `positions` (N, 3) world centres;
    the principal point sits at the image centre of `resolution` (H, W)."""
    pos = np.asarray(positions, dtype=np.float32)
    n = pos.shape[0]
    h, w = resolution
    full = lambda v: np.full((n,), v, dtype=np.float32)  # noqa: E731
    f_pix = full(focal_length / pixel_size)
    R = np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3))
    return camera_array_from_numpy(f_pix, f_pix, full(w / 2.0), full(h / 2.0), R, -pos,
                                   device=device)

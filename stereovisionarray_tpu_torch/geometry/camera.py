"""Batched pinhole camera model (twin of
``stereovisionarray_tpu/geometry/camera.py``).

Conventions as in the reference: world-to-camera ``x_cam = R @ X + t``,
camera centre ``C = -R^T t``, pixels ``u = fx * x/z + cx``, ``v = fy * y/z +
cy`` (u = column, v = row). Every field is a float32 tensor; the rig is the
system's state, so :func:`camera_array_from_numpy` builds it from the same
numpy arrays the reference's ``CameraArray`` holds. Host-side static
computations (shifts, pads, baselines) read :meth:`CameraArray.host`: a rig
built from numpy carries its float32 numpy fields beside the tensors, so a rig
on the card answers them without a copy back, which would wait for the stream.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from stereovisionarray_tpu_torch.geometry.lie import matmul3, matvec3

__all__ = [
    "CameraArray",
    "camera_array_from_numpy",
    "look_at_rotation",
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


_FIELDS = HostCameras._fields


@dataclass
class CameraArray:
    """N pinhole cameras as a struct of float32 tensors: fx, fy, cx, cy (N,),
    R (N, 3, 3) world-to-camera rotation, t (N, 3) translation. `host_fields`
    is the same rig as float32 numpy (None: :meth:`host` copies the tensors)."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    R: torch.Tensor
    t: torch.Tensor
    host_fields: Optional[HostCameras] = field(default=None, repr=False, compare=False)

    def __len__(self) -> int:
        return self.fx.shape[0]

    def _tensors(self):
        return (getattr(self, name) for name in _FIELDS)

    def __getitem__(self, idx) -> "CameraArray":
        """Index every field (an int drops the camera axis); the host copy
        follows an index the host can read (an int, a slice, a list, numpy or
        a CPU tensor)."""
        host = None
        if self.host_fields is not None and not (isinstance(idx, torch.Tensor) and idx.is_cuda):
            hidx = idx.numpy() if isinstance(idx, torch.Tensor) else idx
            host = HostCameras(*(a[hidx] for a in self.host_fields))
        return CameraArray(*(a[idx] for a in self._tensors()), host_fields=host)

    def to(self, device) -> "CameraArray":
        return CameraArray(*(a.to(device) for a in self._tensors()), host_fields=self.host_fields)

    def host(self) -> HostCameras:
        """The fields as float32 numpy: the carried copy, else a copy of the
        tensors (which waits for a CUDA stream)."""
        if self.host_fields is not None:
            return self.host_fields
        return HostCameras(*(a.detach().cpu().numpy() for a in self._tensors()))

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

    # the SfM helpers below write their 3x3 products out elementwise
    # (geometry.lie.matvec3 / matmul3): no TF32 GEMM can reach them
    def pixel_rays(self, uv: torch.Tensor) -> torch.Tensor:
        """Unit world-frame ray directions of pixels (..., 2)."""
        fx, fy, cx, cy = self._bcast_intrinsics(uv[..., 0])
        d = torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy,
                         torch.ones_like(uv[..., 0])], dim=-1)
        d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
        Rt = self.R.transpose(-1, -2)
        if self.R.dim() == 3:  # (N, 3, 3) against (N, ..., 3) rays
            Rt = Rt.reshape(Rt.shape[0], *[1] * (d.dim() - 2), 3, 3)
        return matvec3(Rt, d)

    # one point per camera (the observation lists of sfm/)
    def world_to_cam_each(self, points: torch.Tensor) -> torch.Tensor:
        """points (N, 3), one per camera of this (N,) rig -> camera frame (N, 3)."""
        return matvec3(self.R, points) + self.t

    def project_each(self, points: torch.Tensor, eps: float = 1e-9):
        """points (N, 3), one per camera -> (uv (N, 2), depth (N,))."""
        pc = self.world_to_cam_each(points)
        z = pc[..., 2]
        small = torch.where(z < 0, -eps, eps).to(z.dtype)
        inv_z = 1.0 / torch.where(z.abs() < eps, small, z)
        u = self.fx * pc[..., 0] * inv_z + self.cx
        v = self.fy * pc[..., 1] * inv_z + self.cy
        return torch.stack([u, v], dim=-1), z

    def rays_each(self, uv: torch.Tensor) -> torch.Tensor:
        """uv (N, 2), one per camera -> unit world rays (N, 3)."""
        d = torch.stack([(uv[..., 0] - self.cx) / self.fx, (uv[..., 1] - self.cy) / self.fy,
                         torch.ones_like(uv[..., 0])], dim=-1)
        d = d / torch.sqrt(torch.sum(d * d, dim=-1, keepdim=True))
        return matvec3(self.R.transpose(-1, -2), d)

    def relative_pose(self, i, j) -> Tuple[torch.Tensor, torch.Tensor]:
        """Pose of camera j relative to camera i: x_j = R_rel @ x_i + t_rel."""
        R_rel = matmul3(self.R[j], self.R[i].transpose(-1, -2))
        return R_rel, self.t[j] - matvec3(R_rel, self.t[i])

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
    host = HostCameras(*(np.array(x, dtype=np.float32) for x in (fx, fy, cx, cy, R, t)))
    return CameraArray(*(torch.as_tensor(a, device=device) for a in host), host_fields=host)


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


def look_at_rotation(eye, target, up=(0.0, 1.0, 0.0), device=None) -> torch.Tensor:
    """World-to-camera rotation (3, 3) float32 of a camera at `eye` looking at
    `target`: camera +z towards the target, +y roughly along `up`."""
    eye, target, up = (torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)
                       for a in (eye, target, up))
    fwd = target - eye
    fwd = fwd / torch.sqrt(torch.sum(fwd * fwd))
    right = torch.linalg.cross(up, fwd)
    right = right / torch.sqrt(torch.sum(right * right))
    new_up = torch.linalg.cross(fwd, right)
    return torch.stack([right, new_up, fwd])  # rows: the camera axes in world coordinates

"""Procedural synthetic camera-array scenes (numpy copy of
``stereovisionarray_tpu/datasets/synthetic.py``).

An analytic scene (background plane, raised rectangular patches, slanted
patches, a sphere) rendered by closed-form ray intersection, textured with
multi-octave value noise: every view's image and exact depth come from host
numpy. The card has no JAX, so the port carries its own renderer; its images
equal the reference's bit for bit for the same rig.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np

from stereovisionarray_tpu_torch.geometry.camera import CameraArray, translation_only_array
from stereovisionarray_tpu_torch.geometry.topology import grid_positions

__all__ = ["SceneSpec", "large_range_pair", "reference_rig", "render_camera_array",
           "render_view"]


@dataclass(frozen=True)
class SceneSpec:
    """Analytic scene: background plane at z = background_z, plus raised
    rectangular patches (world x/y extents, each at its own depth) and an
    optional sphere. All depths are in world units in front of the array
    (the reference rig looks down +z from z = -0.75)."""

    background_z: float = 0.25
    # each patch: (x0, x1, y0, y1, z)
    patches: Tuple[Tuple[float, float, float, float, float], ...] = (
        (-0.06, 0.02, -0.05, 0.04, 0.10),
        (0.03, 0.09, -0.02, 0.06, 0.16),
    )
    sphere_center: Tuple[float, float, float] = (0.0, 0.0, 0.18)
    sphere_radius: float = 0.045
    texture_octaves: int = 5
    texture_seed: int = 7
    # slanted planar patches: (x0, x1, y0, y1, z0, dzdx, dzdy) — the
    # surface z = z0 + dzdx*(x-x0) + dzdy*(y-y0) clipped to the rect
    # (fronto-parallel sweep bias fixtures, EVAL_SCENES_r05)
    slants: Tuple[Tuple[float, float, float, float, float, float, float], ...] = ()
    # textureless rectangles: (x0, x1, y0, y1, contrast) — texture
    # contrast scaled toward mid-gray inside (0 = perfectly flat wall)
    textureless: Tuple[Tuple[float, float, float, float, float], ...] = ()


def _value_noise(x: np.ndarray, y: np.ndarray, octaves: int, seed: int) -> np.ndarray:
    """Multi-octave value noise sampled at world coords (vectorized, smooth).
    Deterministic in (coords, seed); range approx [0, 255]."""
    rng = np.random.default_rng(seed)
    out = np.zeros_like(x, dtype=np.float64)
    amp = 1.0
    total = 0.0
    freq = 24.0
    for _ in range(octaves):
        # hash lattice corners to pseudo-random values via sin-free integer mix
        xi = np.floor(x * freq).astype(np.int64)
        yi = np.floor(y * freq).astype(np.int64)
        fx = x * freq - xi
        fy = y * freq - yi
        fx = fx * fx * (3 - 2 * fx)  # smoothstep
        fy = fy * fy * (3 - 2 * fy)
        salt = int(rng.integers(1, 2**31 - 1))

        def corner(ix, iy):
            h = (ix * 374761393 + iy * 668265263) ^ salt
            h = (h ^ (h >> 13)) * 1274126177
            h = h ^ (h >> 16)
            return (h & 0xFFFF).astype(np.float64) / 65535.0

        v00 = corner(xi, yi)
        v10 = corner(xi + 1, yi)
        v01 = corner(xi, yi + 1)
        v11 = corner(xi + 1, yi + 1)
        v = (v00 * (1 - fx) + v10 * fx) * (1 - fy) + (v01 * (1 - fx) + v11 * fx) * fy
        out += amp * v
        total += amp
        amp *= 0.55
        freq *= 2.1
    return (out / total * 255.0).astype(np.float32)


def reference_rig(
    rows: int = 5,
    cols: int = 5,
    spacing: float = 0.05,
    origin: Tuple[float, float] = (-0.1, -0.1),
    z: float = -0.75,
    focal_length: float = 0.05,
    sensor_width: float = 0.036,
    resolution: Tuple[int, int] = (270, 360),
    device=None,
) -> CameraArray:
    """The reference 5x5 rig (0.05 m spacing, z = -0.75, f = 0.05 m, 36 mm
    sensor) as a CameraArray; resolution defaults to the 0.5x downscale."""
    pos = grid_positions(rows, cols, spacing, origin=origin, z=z)
    return translation_only_array(
        focal_length, pos, sensor_width / resolution[1], resolution=resolution, device=device
    )


def _ray_scene_depth(
    origin: np.ndarray, dirs: np.ndarray, scene: SceneSpec
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Closed-form nearest intersection of rays with the scene.

    origin: (3,) camera center; dirs: (H, W, 3) unit rays (world frame).
    Returns (depth_z (H,W), hit_x (H,W), hit_y (H,W)) where depth_z is the
    z-distance from the camera plane (the depth-map convention)."""
    big = np.float32(1e9)
    dz = dirs[..., 2]
    dz = np.where(np.abs(dz) < 1e-9, 1e-9, dz)

    def plane_t(z_plane):
        return (z_plane - origin[2]) / dz

    # background plane
    t_best = plane_t(scene.background_z)
    # raised patches: nearer planes only count inside their rect
    for (x0, x1, y0, y1, zp) in scene.patches:
        t = plane_t(zp)
        hx = origin[0] + t * dirs[..., 0]
        hy = origin[1] + t * dirs[..., 1]
        inside = (hx >= x0) & (hx < x1) & (hy >= y0) & (hy < y1) & (t > 0)
        t_best = np.where(inside & (t < t_best), t, t_best)
    # slanted planar patches: solve O_z + t d_z = z0 + a(px-x0) + b(py-y0)
    for (x0, x1, y0, y1, z0, az, bz) in scene.slants:
        denom = dz - az * dirs[..., 0] - bz * dirs[..., 1]
        denom = np.where(np.abs(denom) < 1e-9, 1e-9, denom)
        t = (z0 - origin[2] + az * (origin[0] - x0) + bz * (origin[1] - y0)) / denom
        hx = origin[0] + t * dirs[..., 0]
        hy = origin[1] + t * dirs[..., 1]
        inside = (hx >= x0) & (hx < x1) & (hy >= y0) & (hy < y1) & (t > 0)
        t_best = np.where(inside & (t < t_best), t, t_best)
    # sphere
    c = np.asarray(scene.sphere_center, dtype=np.float64)
    r = scene.sphere_radius
    if r > 0:
        oc = origin - c
        b = np.einsum("hwc,c->hw", dirs, oc)
        disc = b * b - (np.dot(oc, oc) - r * r)
        hit = disc > 0
        t = -b - np.sqrt(np.maximum(disc, 0.0))
        t_best = np.where(hit & (t > 0) & (t < t_best), t, t_best)

    t_best = np.where(t_best > 0, t_best, big)
    hx = origin[0] + t_best * dirs[..., 0]
    hy = origin[1] + t_best * dirs[..., 1]
    depth_z = t_best * dz  # z-component distance
    return depth_z.astype(np.float32), hx, hy


def render_view(
    cameras: CameraArray, index: int, resolution: Tuple[int, int], scene: SceneSpec
) -> Tuple[np.ndarray, np.ndarray]:
    """Render one camera: (image (H, W) float32 in [0, 255], depth (H, W))."""
    h, w = resolution
    host = cameras.host()
    fx, fy = float(host.fx[index]), float(host.fy[index])
    cx, cy = float(host.cx[index]), float(host.cy[index])
    R = host.R[index].astype(np.float64)
    # C = -R^T t in float32, as the reference's camera centres
    C = (-np.einsum("ji,j->i", host.R[index], host.t[index])).astype(np.float64)
    v, u = np.mgrid[0:h, 0:w].astype(np.float64)
    d_cam = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1)
    d_cam /= np.linalg.norm(d_cam, axis=-1, keepdims=True)
    dirs = d_cam @ R  # R^T @ d, batched: (H, W, 3) world-frame rays
    depth, hx, hy = _ray_scene_depth(C, dirs, scene)
    # depth is z in the camera frame: t * (R_row2 . dir)
    t = depth / np.where(np.abs(dirs[..., 2]) < 1e-9, 1e-9, dirs[..., 2])
    depth = (t * (dirs @ R[2])).astype(np.float32)
    img = _value_noise(hx, hy, scene.texture_octaves, scene.texture_seed)
    for (x0, x1, y0, y1, contrast) in scene.textureless:
        inside = (hx >= x0) & (hx < x1) & (hy >= y0) & (hy < y1)
        img = np.where(inside, 128.0 + contrast * (img - 128.0), img)
    # slight depth-dependent shading so surfaces are distinguishable
    shade = 1.0 - 0.15 * np.clip((depth - depth.min()) / max(1e-6, np.ptp(depth)), 0, 1)
    return (img * shade).astype(np.float32), depth


def render_camera_array(
    cameras: CameraArray, resolution: Tuple[int, int], scene: SceneSpec | None = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Render every camera of the rig: (images (N, H, W), depths (N, H, W)),
    both float32 numpy, exact ground-truth depth for every view."""
    scene = scene or SceneSpec()
    views = [render_view(cameras, i, resolution, scene) for i in range(len(cameras))]
    return np.stack([v[0] for v in views]), np.stack([v[1] for v in views])


def large_range_pair(rng: np.random.Generator, h: int, w: int, margin: int = 48):
    """A rectified pair over a large disparity range (copy of
    ``scripts/perf_cascade.py::make_scene``): a slanted plane plus a smooth
    bump, d in about [24, 232] with |dd/dx| < 1, textured by smoothed noise
    and inverse-mapped exactly into the right view. Returns (left, right,
    gt_disparity, eval_mask): float32 maps and the bool mask of the interior
    pixels whose match is visible, past a `margin`-pixel border strip."""
    x = np.arange(w, dtype=np.float64)
    y = np.arange(h, dtype=np.float64)[:, None]
    d = (24.0 + 160.0 * (x[None, :] / (w - 1))
         + 48.0 * np.exp(-(((x[None, :] - 0.55 * w) / (0.18 * w)) ** 2
                           + ((y - 0.5 * h) / (0.3 * h)) ** 2)))
    t = rng.uniform(0.0, 255.0, (h, w)).astype(np.float64)
    for _ in range(2):
        t = (t + np.roll(t, 1, 0) + np.roll(t, -1, 0)) / 3.0
        t = (t + np.roll(t, 1, 1) + np.roll(t, -1, 1)) / 3.0
    left = t
    right = np.zeros_like(left)
    for yy in range(h):
        u_of_x = x - d[yy]  # strictly increasing: invert by interpolation
        right[yy] = np.interp(np.interp(x, u_of_x, x), x, left[yy])
        right[yy, x < u_of_x[0]] = left[yy, 0]  # never seen by the left view
    mask = np.zeros((h, w), bool)
    mask[8:-8, :] = True
    mask &= x[None, :] >= d + margin
    mask[:, -8:] = False
    return left.astype(np.float32), right.astype(np.float32), d.astype(np.float32), mask

"""Seeded inputs of the benchmark's cells.

- :func:`large_range_pair`: a rectified pair over a large disparity range
  (a slanted plane and a smooth bump, d in about [24, 232]), textured by
  smoothed noise and inverse-mapped exactly into the right view; a copy of
  ``stereovisionarray_tpu_torch.datasets.synthetic.large_range_pair``, in
  numpy.
- :func:`render_rig`: every view of a translation-only camera grid looking
  at the analytic scene of ``datasets/synthetic.py`` (a background plane,
  two raised patches and a sphere, textured by multi-octave value noise),
  rendered by closed-form ray intersection in float64 torch, on the card
  in a run.
- :func:`grid_rig`: the rig's pinhole fields (fx, fy, cx, cy, R, t) as
  float32 numpy, principal point at the image centre.

Every size and draw comes from the arguments, so a seed gives the same
inputs on every run and every seed gives the same sizes.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# the analytic scene: background depth, raised patches (x0, x1, y0, y1, z), sphere
BACKGROUND_Z = 0.25
PATCHES = ((-0.06, 0.02, -0.05, 0.04, 0.10), (0.03, 0.09, -0.02, 0.06, 0.16))
SPHERE = ((0.0, 0.0, 0.18), 0.045)
OCTAVES = 5
# views rendered together: at 270x360 the render's temporaries stay near
# 150 MB, under the array pipeline's own peak, in some 20 ms on an H100
VIEWS_AT_ONCE = 5


def to_uint8(img):
    """Round to the nearest integer and clip to [0, 255], as a decoder's
    8-bit frame (a numpy array or a tensor)."""
    if isinstance(img, torch.Tensor):
        return torch.round(img).clamp(0, 255).to(torch.uint8)
    return np.clip(np.rint(img), 0, 255).astype(np.uint8)


def large_range_pair(rng: np.random.Generator, h: int, w: int) -> Tuple[np.ndarray, np.ndarray]:
    """(left, right) float32 in [0, 255] with ``right[x - d(x)] = left[x]``."""
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
    return left.astype(np.float32), right.astype(np.float32)


def grid_rig(rig: Dict) -> Dict[str, np.ndarray]:
    """Pinhole fields of a rows x cols grid of identical rotation-free
    cameras: ``spacing`` apart from ``origin`` at height ``z``, focal length
    and sensor width in metres, ``resolution`` (H, W)."""
    rows, cols, spacing = rig["rows"], rig["cols"], rig["spacing"]
    ys, xs = np.mgrid[0:rows, 0:cols].astype(np.float64)
    pos = np.stack([rig["origin"][0] + xs * spacing, rig["origin"][1] + ys * spacing,
                    np.full_like(xs, rig["z"])], axis=-1).reshape(-1, 3).astype(np.float32)
    n = pos.shape[0]
    h, w = rig["resolution"]
    f_pix = np.full((n,), rig["focal_length"] / (rig["sensor_width"] / w), dtype=np.float32)
    return {"fx": f_pix, "fy": f_pix.copy(), "cx": np.full((n,), w / 2.0, dtype=np.float32),
            "cy": np.full((n,), h / 2.0, dtype=np.float32),
            "R": np.broadcast_to(np.eye(3, dtype=np.float32), (n, 3, 3)).copy(), "t": -pos}


def _value_noise(x, y, seed: int):
    """Multi-octave value noise at world coordinates (float64 tensors), about [0, 255]."""
    rng = np.random.default_rng(seed)
    out = torch.zeros_like(x)
    amp, total, freq = 1.0, 0.0, 24.0
    for _ in range(OCTAVES):
        xf, yf = torch.floor(x * freq), torch.floor(y * freq)
        fx, fy = x * freq - xf, y * freq - yf
        fx, fy = fx * fx * (3 - 2 * fx), fy * fy * (3 - 2 * fy)
        xi, yi = xf.to(torch.int64), yf.to(torch.int64)
        salt = int(rng.integers(1, 2**31 - 1))

        def corner(ix, iy):
            h = (ix * 374761393 + iy * 668265263) ^ salt
            h = (h ^ (h >> 13)) * 1274126177
            h = h ^ (h >> 16)
            return (h & 0xFFFF).to(torch.float64) / 65535.0

        v = ((corner(xi, yi) * (1 - fx) + corner(xi + 1, yi) * fx) * (1 - fy)
             + (corner(xi, yi + 1) * (1 - fx) + corner(xi + 1, yi + 1) * fx) * fy)
        out += amp * v
        total += amp
        amp *= 0.55
        freq *= 2.1
    return out / total * 255.0


def _render_views(cam: Dict[str, np.ndarray], views: slice, u, v, seed: int):
    """(k, H, W) images of the analytic scene from the rotation-free cameras
    `views`, from the pixel grid `u`, `v` (float64 tensors)."""

    def per_view(a):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)[views], device=u.device)[:, None, None]

    ox, oy, oz = (per_view(-cam["t"][:, j]) for j in range(3))
    dx = (u - per_view(cam["cx"])) / per_view(cam["fx"])
    dy = (v - per_view(cam["cy"])) / per_view(cam["fy"])
    norm = torch.sqrt(dx * dx + dy * dy + 1.0)
    dx, dy, dz = dx / norm, dy / norm, 1.0 / norm
    dz = torch.where(dz.abs() < 1e-9, 1e-9, dz)
    t_best = (BACKGROUND_Z - oz) / dz
    for (x0, x1, y0, y1, zp) in PATCHES:
        t = (zp - oz) / dz
        hx, hy = ox + t * dx, oy + t * dy
        inside = (hx >= x0) & (hx < x1) & (hy >= y0) & (hy < y1) & (t > 0)
        t_best = torch.where(inside & (t < t_best), t, t_best)
    (cx, cy, cz), r = SPHERE
    ocx, ocy, ocz = ox - cx, oy - cy, oz - cz
    b = dx * ocx + dy * ocy + dz * ocz
    disc = b * b - (ocx * ocx + ocy * ocy + ocz * ocz - r * r)
    t = -b - torch.sqrt(disc.clamp_min(0.0))
    t_best = torch.where((disc > 0) & (t > 0) & (t < t_best), t, t_best)
    hx, hy = ox + t_best * dx, oy + t_best * dy
    depth = t_best * dz
    img = _value_noise(hx, hy, seed)
    lo = depth.amin((-2, -1), keepdim=True)
    span = (depth.amax((-2, -1), keepdim=True) - lo).clamp_min(1e-6)
    return img * (1.0 - 0.15 * ((depth - lo) / span).clamp(0, 1))


def render_rig(cam: Dict[str, np.ndarray], h: int, w: int, seed: int, device="cpu"):
    """(N, H, W) float64 images of every camera on `device`, the texture drawn
    from `seed`, :data:`VIEWS_AT_ONCE` views at a time."""
    v, u = torch.meshgrid(torch.arange(h, dtype=torch.float64, device=device),
                          torch.arange(w, dtype=torch.float64, device=device), indexing="ij")
    n = cam["fx"].shape[0]
    return torch.cat([_render_views(cam, slice(i, i + VIEWS_AT_ONCE), u, v, seed)
                      for i in range(0, n, VIEWS_AT_ONCE)])

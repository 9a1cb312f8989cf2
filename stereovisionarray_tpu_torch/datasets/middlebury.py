"""Middlebury stereo pair loading: PFM ground truth + calib.txt (the port's
copy of ``stereovisionarray_tpu/datasets/middlebury.py``, numpy-only, with
PNG decoding from ``datasets/io.py`` instead of imageio)."""

from __future__ import annotations

import os
import re
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from stereovisionarray_tpu_torch.datasets.io import read_png


def read_pfm(path: str) -> np.ndarray:
    """Read a PFM file -> float32 (H, W) or (H, W, 3), top row first."""
    with open(path, "rb") as f:
        header = f.readline().decode("latin-1").strip()
        if header not in ("PF", "Pf"):
            raise ValueError(f"not a PFM file: {path!r} (header {header!r})")
        color = header == "PF"
        dims = f.readline().decode("latin-1").strip()
        while dims.startswith("#"):  # comments
            dims = f.readline().decode("latin-1").strip()
        m = re.match(r"^(\d+)\s+(\d+)$", dims)
        if not m:
            raise ValueError(f"bad PFM dims line: {dims!r}")
        w, h = int(m.group(1)), int(m.group(2))
        scale = float(f.readline().decode("latin-1").strip())
        count = w * h * (3 if color else 1)
        data = np.frombuffer(f.read(count * 4), dtype="<f4" if scale < 0 else ">f4")
        if data.size != count:
            raise ValueError(f"truncated PFM: {path!r}")
    img = data.reshape((h, w, 3) if color else (h, w))
    return np.ascontiguousarray(img[::-1]).astype(np.float32)  # bottom-up -> top-down


def parse_calib(text: str) -> Dict[str, object]:
    """Parse a Middlebury ``calib.txt``: ``cam0=[f 0 cx; 0 f cy; 0 0 1]``
    matrices plus scalar fields (doffs, baseline, width, height, ndisp...)."""
    out: Dict[str, object] = {}
    for line in text.splitlines():
        line = line.strip()
        if not line or "=" not in line:
            continue
        key, val = (s.strip() for s in line.split("=", 1))
        if val.startswith("["):
            rows = [[float(x) for x in row.split()]
                    for row in val.strip("[]").split(";") if row.strip()]
            out[key] = np.asarray(rows, dtype=np.float32)
            continue
        for cast in (int, float):
            try:
                out[key] = cast(val)
                break
            except ValueError:
                pass
        else:
            out[key] = val
    return out


@dataclass
class MiddleburyPair:
    left: np.ndarray  # (H, W) float32 grayscale
    right: np.ndarray
    gt_disparity: Optional[np.ndarray]  # (H, W) float32, inf/0 = unknown
    calib: Dict[str, object]

    @property
    def ndisp(self) -> int:
        return int(self.calib.get("ndisp", 256))

    @property
    def valid_gt(self) -> Optional[np.ndarray]:
        if self.gt_disparity is None:
            return None
        return np.isfinite(self.gt_disparity) & (self.gt_disparity > 0)


def _to_gray(img: np.ndarray) -> np.ndarray:
    img = np.asarray(img, dtype=np.float32)
    if img.ndim == 3:
        img = img[..., :3] @ np.asarray([0.299, 0.587, 0.114], dtype=np.float32)
    return img


def load_middlebury_pair(folder: str, half_res: bool = False) -> MiddleburyPair:
    """Load a Middlebury scene directory (im0.png, im1.png, disp0.pfm,
    calib.txt); `half_res` decimates image and disparity together."""
    left = _to_gray(read_png(os.path.join(folder, "im0.png")))
    right = _to_gray(read_png(os.path.join(folder, "im1.png")))
    gt = None
    disp_path = os.path.join(folder, "disp0.pfm")
    if os.path.exists(disp_path):
        gt = read_pfm(disp_path)
        if gt.ndim == 3:
            gt = gt[..., 0]
    calib: Dict[str, object] = {}
    calib_path = os.path.join(folder, "calib.txt")
    if os.path.exists(calib_path):
        with open(calib_path) as f:
            calib = parse_calib(f.read())
    if half_res:
        left, right = left[::2, ::2], right[::2, ::2]
        if gt is not None:
            gt = gt[::2, ::2] * 0.5
        if "ndisp" in calib:
            calib["ndisp"] = int(np.ceil(int(calib["ndisp"]) / 2))
    return MiddleburyPair(left=left, right=right, gt_disparity=gt, calib=calib)

"""Image and artifact I/O (twin of ``stereovisionarray_tpu/datasets/io.py``).

The reference reads and writes images through its C++ codec and falls back
to imageio, which the machines this port runs on need not have. The port
decodes through its own build of the same codec (``datasets/native_loader``)
and otherwise with :func:`read_png`, a standard-library (zlib) decoder of the
PNGs the datasets here use: 8-bit, non-interlaced grayscale, RGB or RGBA, any
of the five scanline filters (anything else raises); :func:`write_png` is its
encoder. Both routes give the same pixels: the gray conversion is the codec's
``0.299 r + 0.587 g + 0.114 b`` in float32, summed left to right.
:func:`native_available` says which route ran. Directory listings are sorted,
unlike the reference's directory walk.

Artifacts are the reference's files, byte for byte where the format allows:
named arrays with JSON metadata in one ``.npz`` (:func:`save_array`), and
binary little-endian PLY point clouds (:func:`save_ply`), so either package
reads what the other wrote. These functions take numpy arrays: copy tensors
on the card to the host first.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

from stereovisionarray_tpu_torch.datasets import native_loader

__all__ = ["list_images_sorted", "load_array", "load_image_gray", "load_image_stack",
           "load_ply", "native_available", "read_png", "save_array", "save_png", "save_ply",
           "write_png"]

_IMAGE_EXTS = (".png", ".jpg", ".jpeg", ".bmp", ".tif", ".tiff", ".pgm", ".ppm")

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # PNG colour type -> samples per pixel


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(ftype: int, line: np.ndarray, prev: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one scanline's filter (PNG spec section 9); `prev` is the
    previous decoded scanline (zeros above the first)."""
    if ftype == 0:  # None
        return line
    if ftype == 1:  # Sub: cumulative sum per sample phase, modulo 256
        return (np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0) % 256
                ).astype(np.uint8).reshape(-1)
    if ftype == 2:  # Up
        return line + prev  # uint8 arithmetic wraps modulo 256
    if ftype not in (3, 4):
        raise ValueError(f"unknown PNG filter type {ftype}")
    raw, up = line.tolist(), prev.tolist()
    out = [0] * len(raw)
    for i, v in enumerate(raw):
        a = out[i - bpp] if i >= bpp else 0
        if ftype == 3:  # Average
            out[i] = (v + (a + up[i]) // 2) & 0xFF
        else:  # Paeth
            c = up[i - bpp] if i >= bpp else 0
            out[i] = (v + _paeth(a, up[i], c)) & 0xFF
    return np.asarray(out, dtype=np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode an 8-bit non-interlaced PNG -> uint8 (H, W) or (H, W, C)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _SIGNATURE:
        raise ValueError(f"not a PNG file: {path!r}")
    header, idat, pos = None, [], 8
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos : pos + 8])
        body = data[pos + 8 : pos + 8 + length]
        if len(body) != length:
            raise ValueError(f"truncated PNG chunk {ctype!r} in {path!r}")
        if ctype == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            break
        pos += 12 + length  # length, type, body, CRC
    if header is None:
        raise ValueError(f"PNG without IHDR: {path!r}")
    w, h, depth, color, compression, filtering, interlace = header
    if depth != 8 or color not in _CHANNELS or interlace != 0 or compression != 0 or filtering != 0:
        raise ValueError(
            f"unsupported PNG {path!r}: bit depth {depth}, colour type {color}, "
            f"interlace {interlace} (8-bit non-interlaced gray/RGB/RGBA only)")
    ch = _CHANNELS[color]
    stride = w * ch
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), dtype=np.uint8)
    if raw.size != h * (stride + 1):
        raise ValueError(f"PNG image data of {path!r} has {raw.size} bytes, "
                         f"expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    out = np.empty((h, stride), dtype=np.uint8)
    prev = np.zeros(stride, dtype=np.uint8)
    for y in range(h):
        out[y] = _unfilter(int(rows[y, 0]), rows[y, 1:], prev, ch)
        prev = out[y]
    return out.reshape(h, w, ch) if ch > 1 else out.reshape(h, w)


def write_png(path: str, array: np.ndarray) -> None:
    """Encode an 8-bit (H, W) gray or (H, W, 3 / 4) RGB(A) array as a PNG:
    filter 0 on every row, one zlib IDAT chunk."""
    a = np.ascontiguousarray(array, dtype=np.uint8)
    if a.ndim == 2:
        color = 0
    elif a.ndim == 3 and a.shape[2] in (3, 4):
        color = {3: 2, 4: 6}[a.shape[2]]
    else:
        raise ValueError(f"write_png expects (H, W) or (H, W, 3|4) uint8, got {a.shape}")
    h, w = a.shape[:2]
    rows = np.concatenate([np.zeros((h, 1), np.uint8), a.reshape(h, -1)], axis=1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def native_available() -> bool:
    """True when images decode through the C++ codec, False when through
    :func:`read_png`."""
    return native_loader.native_available()


def list_images_sorted(folder: str) -> List[str]:
    """Sorted paths of the image files in `folder`."""
    return [os.path.join(folder, f) for f in sorted(os.listdir(folder))
            if f.lower().endswith(_IMAGE_EXTS)]


def _gray(img: np.ndarray) -> np.ndarray:
    """float32 luma of a decoded uint8 image, as the C++ codec computes it."""
    if img.ndim == 2:
        return img.astype(np.float32)
    r, g, b = (img[..., i].astype(np.float32) for i in range(3))
    return np.float32(0.299) * r + np.float32(0.587) * g + np.float32(0.114) * b


def load_image_gray(path: str, half_res: bool = False) -> np.ndarray:
    """An image as float32 grayscale (H, W) in [0, 255], with `half_res`
    every second row and column of (H // 2, W // 2): the C++ codec where it
    is built and covers the format, else :func:`read_png`. (The reference's
    imageio fallback keeps the odd last row and column.)"""
    if native_loader.native_available():
        try:
            return native_loader.decode_image(path, gray=True, half_res=half_res)
        except ValueError:
            pass  # a format the codec does not cover (e.g. jpeg)
    img = _gray(read_png(path))
    if half_res:  # the codec's top-left pick: odd sizes drop their last row / column
        h, w = img.shape
        img = img[:h - h % 2:2, :w - w % 2:2]
    return img


def load_image_stack(paths, half_res: bool = False, threads: int = 4) -> np.ndarray:
    """Same-shape images as one (N, H, W) float32 stack, decoded on the
    codec's worker threads where it is built."""
    if native_loader.native_available():
        try:
            return native_loader.load_stack(list(paths), threads=threads, half_res=half_res)
        except ValueError:
            pass
    return np.stack([load_image_gray(p, half_res=half_res) for p in paths])


def save_png(path: str, array: np.ndarray, vmin: Optional[float] = None,
             vmax: Optional[float] = None) -> None:
    """Save a float array as an 8-bit PNG, normalised to [vmin, vmax] (the
    array's range by default): gray through the C++ encoder where it is
    built, else :func:`write_png`."""
    if not path.lower().endswith(".png"):
        raise ValueError(f"save_png writes PNG files only: {path!r}")
    a = np.asarray(array, dtype=np.float32)
    lo = float(np.nanmin(a)) if vmin is None else vmin
    hi = float(np.nanmax(a)) if vmax is None else vmax
    scale = 255.0 / max(hi - lo, 1e-12)
    u8 = np.clip((a - lo) * scale, 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    if u8.ndim == 2 and native_loader.native_available():
        native_loader.encode_png_gray(path, u8)
    else:
        write_png(path, u8)


def save_array(path: str, arrays: Dict[str, np.ndarray], metadata: Optional[Dict] = None) -> None:
    """Named arrays and JSON metadata (``{"version": 1, **metadata}``, stored
    as the uint8 array ``__meta__``) in one compressed ``.npz``."""
    payload = {k: np.asarray(v) for k, v in arrays.items()}
    payload["__meta__"] = np.frombuffer(
        json.dumps({"version": 1, **(metadata or {})}).encode(), dtype=np.uint8
    )
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.savez_compressed(path, **payload)


def load_array(path: str) -> Tuple[Dict[str, np.ndarray], Dict]:
    """Inverse of :func:`save_array` -> (arrays, metadata)."""
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode()) if "__meta__" in z.files else {}
    return arrays, meta


def save_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    valid: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    quality: Optional[np.ndarray] = None,
) -> int:
    """Write a binary little-endian PLY point cloud; returns the number of
    points written.

    Args:
      points: (..., 3) float positions (flattened).
      colors: optional (..., 3) uint8 RGB per point.
      valid: optional (...) boolean filter.
      normals: optional (..., 3) float unit normals (nx, ny, nz).
      quality: optional (...) float per-point scalar (e.g. fusion
        confidence), the standard `quality` property.
    """
    pts = np.asarray(points, dtype=np.float32).reshape(-1, 3)
    col = None if colors is None else np.asarray(colors, dtype=np.uint8).reshape(-1, 3)
    nrm = None if normals is None else np.asarray(normals, dtype=np.float32).reshape(-1, 3)
    qual = None if quality is None else np.asarray(quality, dtype=np.float32).reshape(-1)
    if valid is not None:
        keep = np.asarray(valid).reshape(-1)
        pts = pts[keep]
        col = col[keep] if col is not None else None
        nrm = nrm[keep] if nrm is not None else None
        qual = qual[keep] if qual is not None else None
    n = pts.shape[0]
    header = ["ply", "format binary_little_endian 1.0", f"element vertex {n}",
              "property float x", "property float y", "property float z"]
    fields = [("xyz", "<f4", 3)]
    if nrm is not None:
        header += ["property float nx", "property float ny", "property float nz"]
        fields += [("normal", "<f4", 3)]
    if col is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        fields += [("rgb", "u1", 3)]
    if qual is not None:
        header += ["property float quality"]
        fields += [("quality", "<f4")]
    header += ["end_header"]
    rec = np.zeros(n, dtype=fields)
    rec["xyz"] = pts
    if nrm is not None:
        rec["normal"] = nrm
    if col is not None:
        rec["rgb"] = col
    if qual is not None:
        rec["quality"] = qual
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        f.write(rec.tobytes())
    return n


_PLY_TYPES = {"float": "<f4", "uchar": "u1", "int": "<i4", "double": "<f8", "short": "<i2",
              "ushort": "<u2"}


def load_ply(path: str) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Read a binary PLY as :func:`save_ply` writes it -> (points (N, 3)
    float32, colors (N, 3) uint8 or None). The property list is parsed
    generically, so files with normals and quality load too (those channels
    are skipped)."""
    with open(path, "rb") as f:
        n = 0
        props = []  # (name, numpy type) in file order
        while True:
            line = f.readline().decode("ascii").strip()
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            elif line.startswith("property"):
                _, ptype, name = line.split()
                props.append((name, _PLY_TYPES[ptype]))
            elif line == "end_header":
                break
        rec = np.frombuffer(f.read(), dtype=props, count=n)
    pts = np.stack([rec["x"], rec["y"], rec["z"]], axis=-1).astype(np.float32)
    col = None
    if {"red", "green", "blue"} <= {name for name, _ in props}:
        col = np.stack([rec["red"], rec["green"], rec["blue"]], axis=-1).astype(np.uint8)
    return pts, col

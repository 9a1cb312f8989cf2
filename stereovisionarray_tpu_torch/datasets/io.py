"""PNG decoding with the standard library (zlib) and numpy.

The reference loader reads images through imageio
(``stereovisionarray_tpu/datasets/middlebury.py``), which the machines this
port runs on need not have. This decoder covers the PNGs the datasets here
use: 8-bit, non-interlaced grayscale, RGB or RGBA, any of the five scanline
filters. Anything else raises.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

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

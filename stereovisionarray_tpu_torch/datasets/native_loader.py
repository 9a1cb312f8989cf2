"""ctypes binding of the repo's C++ image codec and prefetch loader (a copy
of ``stereovisionarray_tpu/datasets/native_loader.py`` for the port).

``native/image_codec.cpp`` and ``native/loader.cpp`` are built with g++ (zlib
for PNG) into a library of the port's own under
``stereovisionarray_tpu_torch/build/``, never into ``native/build/``. The
build is safe under concurrent processes: one holds an ``fcntl`` lock while it
compiles to a temporary name and moves the library into place with
``os.replace``; the others wait for the lock and load what it built.
:func:`decode_image` decodes one file, :class:`PrefetchLoader` a list in
order on worker threads. Without a toolchain ``native_available()`` is False
and ``datasets.io`` decodes PNGs with its own :func:`~.io.read_png`.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from typing import Iterator, List, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_NATIVE_DIR = os.path.join(_REPO_ROOT, "native")
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libsvt_io.so")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _sources() -> List[str]:
    return [os.path.join(_NATIVE_DIR, f) for f in ("image_codec.cpp", "loader.cpp")]


def _needs_build() -> bool:
    if not os.path.exists(_LIB_PATH):
        return True
    lib_mtime = os.path.getmtime(_LIB_PATH)
    return any(os.path.getmtime(s) > lib_mtime for s in _sources() if os.path.exists(s))


def _build() -> None:
    """Build the library unless a current one is in place, under a file lock
    shared by every process; the library appears whole or not at all."""
    os.makedirs(_BUILD_DIR, exist_ok=True)
    with open(os.path.join(_BUILD_DIR, "libsvt_io.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not _needs_build():
            return
        tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
        cmd = ["g++", "-O2", "-std=c++17", "-fPIC", "-shared", "-pthread",
               *_sources(), "-lz", "-o", tmp]
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
            if proc.returncode != 0:
                raise RuntimeError(f"native build failed:\n{proc.stderr}")
            os.replace(tmp, _LIB_PATH)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.svt_last_error.restype = ctypes.c_char_p
    lib.svt_decode.restype = ctypes.c_void_p
    lib.svt_decode.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.svt_image_copy.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.svt_image_free.argtypes = [ctypes.c_void_p]
    lib.svt_loader_create.restype = ctypes.c_void_p
    lib.svt_loader_create.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.svt_loader_next.restype = ctypes.c_int
    lib.svt_loader_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_void_p),
    ]
    lib.svt_loader_destroy.argtypes = [ctypes.c_void_p]
    lib.svt_encode_png_gray.restype = ctypes.c_int
    lib.svt_encode_png_gray.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int,
    ]
    return lib


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        try:
            _build()
            _lib = _bind(ctypes.CDLL(_LIB_PATH))
        except (OSError, RuntimeError, subprocess.SubprocessError) as e:  # no toolchain, ...
            _build_error = str(e)
            return None
        return _lib


def native_available() -> bool:
    return _get_lib() is not None


def native_build_error() -> Optional[str]:
    _get_lib()
    return _build_error


def _fetch(lib, handle, w, h, c) -> np.ndarray:
    shape = (h, w) if c == 1 else (h, w, c)
    out = np.empty(shape, dtype=np.float32)
    lib.svt_image_copy(handle, out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    lib.svt_image_free(handle)
    return out


def decode_image(path: str, gray: bool = True, half_res: bool = False) -> np.ndarray:
    """Decode one image natively -> float32 (H, W) gray (0..255) or
    (H, W, 3) RGB. Raises on unsupported/corrupt files."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_build_error}")
    w = ctypes.c_int()
    h = ctypes.c_int()
    c = ctypes.c_int()
    handle = lib.svt_decode(
        path.encode(), int(gray), int(half_res),
        ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
    )
    if not handle:
        raise ValueError(f"decode failed for {path}: {lib.svt_last_error().decode()}")
    return _fetch(lib, handle, w.value, h.value, c.value)


class PrefetchLoader:
    """In-order multi-threaded prefetching iterator over an image path list.

    >>> for frame in PrefetchLoader(paths, threads=4):  # doctest: +SKIP
    ...     device_frame = torch.from_numpy(frame).cuda()

    Frames arrive in the order of `paths` regardless of decode timing
    (deterministic), with up to `capacity` frames decoded ahead.
    """

    def __init__(self, paths: List[str], threads: int = 4, capacity: int = 8,
                 gray: bool = True, half_res: bool = False) -> None:
        lib = _get_lib()
        if lib is None:
            raise RuntimeError(f"native loader unavailable: {_build_error}")
        self._lib = lib
        self._paths = list(paths)
        arr = (ctypes.c_char_p * len(self._paths))(
            *[p.encode() for p in self._paths]
        )
        self._handle = lib.svt_loader_create(
            arr, len(self._paths), threads, capacity, int(gray), int(half_res)
        )
        self._closed = False

    def __iter__(self) -> Iterator[np.ndarray]:
        w = ctypes.c_int()
        h = ctypes.c_int()
        c = ctypes.c_int()
        img = ctypes.c_void_p()
        while True:
            rc = self._lib.svt_loader_next(
                self._handle, ctypes.byref(w), ctypes.byref(h), ctypes.byref(c),
                ctypes.byref(img),
            )
            if rc == -1:
                return
            if rc == 0:
                raise ValueError(
                    f"decode failed: {self._lib.svt_last_error().decode()}"
                )
            yield _fetch(self._lib, img.value, w.value, h.value, c.value)

    def close(self) -> None:
        if not self._closed:
            self._lib.svt_loader_destroy(self._handle)
            self._closed = True

    def __enter__(self) -> "PrefetchLoader":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self) -> None:  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


def encode_png_gray(path: str, array: np.ndarray) -> None:
    """Write an (H, W) uint8 array as a grayscale PNG via the native encoder
    (the write-side of the C++ codec; raises if the toolchain is absent)."""
    lib = _get_lib()
    if lib is None:
        raise RuntimeError(f"native codec unavailable: {_build_error}")
    a = np.ascontiguousarray(array, dtype=np.uint8)
    if a.ndim != 2:
        raise ValueError("encode_png_gray expects (H, W) uint8")
    ok = lib.svt_encode_png_gray(
        path.encode(), a.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        a.shape[1], a.shape[0],
    )
    if not ok:
        raise ValueError(f"png encode failed: {lib.svt_last_error().decode()}")


def load_stack(paths: List[str], threads: int = 4, gray: bool = True,
               half_res: bool = False) -> np.ndarray:
    """Decode a whole list into one (N, H, W[, C]) stack via the prefetch
    pool (shapes must match)."""
    with PrefetchLoader(paths, threads=threads, gray=gray, half_res=half_res) as ld:
        frames = list(ld)
    return np.stack(frames)

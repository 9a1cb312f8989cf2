"""Build and load the hand-written CUDA kernels under ``csrc/``.

All ``csrc/*.cu`` files compile, with nvcc and a plain C interface, into one
shared library under ``build/`` (listed in ``.gitignore``) at first use, and
again whenever a source is newer than the library. The library is loaded with
``ctypes``: every pointer and the stream pass as ``c_void_p``, and every entry
point returns ``cudaGetLastError()``, which :func:`launch` turns into an
exception. Nothing here runs at import time; the CPU tests import every module
of the package on a machine with neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"
LIB_PATH = BUILD_DIR / "libsvt_kernels.so"

# sm_90a: Hopper. -fmad=false keeps `a + b * c` two roundings, as the
# reference computes it (the costs and the parabola must match bit for bit);
# no --use_fast_math for the same reason (IEEE division, no flush to zero).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argument types, the trailing stream included
_SIGNATURES = {
    # left, right, out, out_bytes, h, w, n_disp, win_h, win_w,
    # bt_weight, bt_clip, worst, scale, stream
    "svt_cost_volume": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _P),
    # cost, cost_bytes, p2_y, p2_x, total32, h, w, n_disp, p1, num_paths, stream
    "svt_sgm_paths": (_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # total, h, w, n_disp, subpixel, uniqueness,
    # disp_l, cost, valid, second, disp_r, stream
    "svt_extract_maps": (_P, _I, _I, _I, _I, _F, _P, _P, _P, _P, _P, _P),
    # disp_l, disp_r, at, h, w, n_disp, stream
    "svt_lr_gather": (_P, _P, _P, _I, _I, _I, _P),
}

_lib = None


def sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
            "kernels of stereovisionarray_tpu_torch need the CUDA toolkit"
        )
    return found


def is_stale() -> bool:
    if not LIB_PATH.exists():
        return True
    built = LIB_PATH.stat().st_mtime
    return any(src.stat().st_mtime > built for src in sources())


def build(force: bool = False) -> None:
    """Compile ``csrc/*.cu`` into ``build/libsvt_kernels.so`` if stale (or
    ``force``). The library is written under a temporary name and renamed
    into place, so concurrent builds never load a half-written file."""
    if not (force or is_stale()):
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix="libsvt_", suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cus = [str(s) for s in sources() if s.suffix == ".cu"]
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *cus]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(
            f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, LIB_PATH)


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    if _lib is None:
        build()
        lib = ctypes.CDLL(str(LIB_PATH))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.svt_error_string.argtypes = (_I,)
        lib.svt_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def timed_build() -> float:
    """Force a fresh build and load; returns the seconds it took."""
    t0 = time.perf_counter()
    build(force=True)
    library()
    return time.perf_counter() - t0


def launch(name: str, device: torch.device, *args) -> None:
    """Call C entry point `name` on `device`'s current stream; raise on any
    CUDA error the launch reports."""
    lib = library()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, name)(*args, stream)
    if err != 0:
        msg = lib.svt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Validate a tensor handed to a kernel: CUDA, dtype, shape, contiguous."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")

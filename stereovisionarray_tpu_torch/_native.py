"""Build and load the hand-written CUDA kernels under ``csrc/``.

All ``csrc/*.cu`` files compile, with nvcc and a plain C interface (one nvcc
per file, in parallel), into one shared library under ``build/`` (listed in
``.gitignore``) at first use, and again whenever a source is newer than the
library. The library is loaded with
``ctypes``: every pointer and the stream pass as ``c_void_p``, and every entry
point returns ``cudaGetLastError()``, which :func:`launch` turns into an
exception. Nothing here runs at import time; the CPU tests import every module
of the package on a machine with neither nvcc nor a card.

The launch path is lean because the port's small kernels (the hat sampler,
the LR gather: a few microseconds of device time) spend most of a wrapper
call on the host. Each entry point's ctypes function is resolved once, at
load; :func:`launch` takes the raw handle of the device's current stream and
enters a ``torch.cuda.device`` context only when the tensor's device is not
the current one; :func:`check` tests the accepted case in one expression and
builds its message only on a refusal.
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
    "-fmad=false", "-Xcompiler", "-fPIC",
)

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# entry point -> argument types, the trailing stream included
_SIGNATURES = {
    # left, right, out, out_bytes, h, w, n_disp, win_h, win_w,
    # bt_weight, bt_clip, worst, scale, tile, stream
    "svt_cost_volume": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _F, _F, _F, _I, _P),
    # cost, cost_bytes, p2_y, p2_x, total, scratch, h, w, n_disp, p1, num_paths, stream
    "svt_sgm_paths": (_P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # cost, p2_y, p2_x, partial, h, w, n_disp, p1, path_mask, stream
    "svt_sgm_paths_f32": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # partial, out, h, w, n_disp, path_mask, num_paths, sweep_mask, order, stream
    "svt_sgm_combine_f32": (_P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # cost, p2_y, p2_x, out, p2_buf, p3_buf, a_buf, ring, h, w, n_disp, p1,
    # num_paths, order, strip_rows, stream
    "svt_sgm_float_strips": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _I, _I, _I, _P),
    # total, total_bytes, h, w, n_disp, subpixel, uniqueness, lr_max_diff,
    # tile, stride_words, disp_l, cost, valid, second, disp_r, stream
    "svt_extract_maps": (_P, _I, _I, _I, _I, _I, _F, _F, _I, _I, _P, _P, _P, _P, _P, _P),
    # disp_l, disp_r, at, h, w, n_disp, stream
    "svt_lr_gather": (_P, _P, _P, _I, _I, _I, _P),
    # ref, src, shifts, fused, nviews, n_src, h, w, n_planes, patch, mode, topk, stream
    "svt_plane_sweep": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
    # values, t, aux, out, aux_out, batch, h, w, k0, k1, along_rows, stream
    "svt_hat_sample": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    # values, t_rows, t_cols, out, batch, h, w, k0, k1, stream
    "svt_hat_sample_2d": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
}

_lib = None
_FNS: dict = {}  # entry point -> its ctypes function, filled at load


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


def _run_all(cmds) -> None:
    """Run the commands in parallel; raise with nvcc's output on any failure."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                    text=True)) for cmd in cmds]
    failed = []
    for cmd, proc in procs:
        out = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed with exit code {proc.returncode}:\n{' '.join(cmd)}\n{out}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build(force: bool = False) -> None:
    """Compile ``csrc/*.cu`` into ``build/libsvt_kernels.so`` if stale (or
    ``force``): one nvcc per source, all started together, then one link.
    The library is written under a temporary name and renamed into place, so
    concurrent builds never load a half-written file."""
    if not (force or is_stale()):
        return
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="svt_obj_", dir=BUILD_DIR) as obj_dir:
        cus = [s for s in sources() if s.suffix == ".cu"]
        objs = [str(Path(obj_dir) / (s.stem + ".o")) for s in cus]
        _run_all([[nvcc_path(), *NVCC_FLAGS, "-c", "-o", o, str(s)] for s, o in zip(cus, objs)])
        tmp = str(Path(obj_dir) / LIB_PATH.name)
        _run_all([[nvcc_path(), *NVCC_FLAGS, "-shared", "-o", tmp, *objs]])
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
            _FNS[name] = fn
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
    CUDA error the launch reports. `device` is a CUDA tensor's device (its
    index is set)."""
    if not _FNS:
        library()
    index = device.index
    if torch._C._cuda_getDevice() == index:
        err = _FNS[name](*args, torch._C._cuda_getCurrentRawStream(index))
    else:  # a kernel runs on the current device: switch to the tensor's
        with torch.cuda.device(index):
            err = _FNS[name](*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        msg = _lib.svt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple) -> None:
    """Validate a tensor handed to a kernel: CUDA, dtype, shape (a tuple),
    contiguous."""
    if t.is_cuda and t.dtype == dtype and t.shape == shape and t.is_contiguous():
        return
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got device {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.shape != shape:
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    raise ValueError(f"{name} must be contiguous")

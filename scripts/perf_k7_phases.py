#!/usr/bin/env python3
"""Where K7's strip route spends its time on an NVIDIA GPU.

    python3 scripts/perf_k7_phases.py

Builds instrumented copies of ``csrc/sgm_paths.cu`` (text-patched: a mask
that skips launches, and a mode that skips the walks or the combines inside
the cooperative passes) into ``stereovisionarray_tpu_torch/build/k7_phases/``
and times, behind a GPU spin (``chip_smoke.device_ms``), at 540x768x64 (k7
order) and 270x360x128 (wdh), 8 paths:

 - the whole route, launch 1 (the horizontal walks) alone, each pass alone;
 - each pass with only its walks, only its combines, or neither (its grid
   barriers and launch);
 - the strip heights S = 8, 16 (the plan's) and 32, and 4 paths at S = 16;
 - three variants of the design: 8 values a lane (two float4, L = D / 8
   lanes a line) instead of 4 up to D = 128, blocks of 4 warps instead of
   16 in the passes, and 2 warps a block instead of 1 in launch 1.

Every timed configuration is first held bit-exact to the plain twin. Prints
one JSON line per configuration and writes them to
``chiprun_out/perf_k7_phases.json``. Needs a CUDA device.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402


def patch(text: str, old: str, new: str) -> str:
    if old not in text:
        raise SystemExit(f"perf_k7_phases: csrc/sgm_paths.cu no longer holds {old!r}")
    return text.replace(old, new)


def instrumented(src: str) -> str:
    """The route with a launch mask (1 launch 1, 2 the down pass, 4 the up
    pass) and a pass mode (1 walks, 2 combines), set by svt_probe_set; the
    strip height is taken as given."""
    s = patch(src, "  int h, w, n_disp, paths, order, up, strip_rows;",
              "  int h, w, n_disp, paths, order, up, strip_rows, mode;")
    s = patch(s, "      for (int item = rank; item < walkers; item += warps) {",
              "      for (int item = rank; (a.mode & 1) && item < walkers; item += warps) {")
    s = patch(s, "      if (crank >= 0)\n        combine_strip",
              "      if ((a.mode & 2) && crank >= 0)\n        combine_strip")
    s = patch(s, "  sgm_rows_f32_kernel<L, V><<<", "  if (g_mask & 1) sgm_rows_f32_kernel<L, V><<<")
    s = patch(s, "    a.up = up;\n",
              "    a.up = up;\n    a.mode = g_mode;\n    if (!(g_mask & (2 << up))) continue;\n")
    s = patch(s, "struct StripArgs {", "int g_mask = 7, g_mode = 3;\nstruct StripArgs {")
    s = patch(s, "      strip_rows != strip_rows_for(w, n_disp) ||", "")
    return s + ("\nSVT_API void svt_probe_set(int mask, int mode) {\n"
                "  g_mask = mask;\n  g_mode = mode;\n}\n")


def variants(src: str) -> dict:
    base = instrumented(src)
    eight = patch(base, "  if (n_disp > 128) return SVT_STRIPS(32, 8);",
                  "  if (n_disp > 0) {\n    const int l8 = n_disp / 8;\n"
                  "    if (l8 <= 8) return SVT_STRIPS(8, 8);\n"
                  "    if (l8 <= 16) return SVT_STRIPS(16, 8);\n    return SVT_STRIPS(32, 8);\n  }")
    small = patch(base, "constexpr int kStripWarps = 16;", "constexpr int kStripWarps = 4;")
    rows2 = patch(base, "constexpr int kRowWarps = 1;", "constexpr int kRowWarps = 2;")
    return {"as_built": base, "eight_values_a_lane": eight, "four_warp_blocks": small,
            "two_warp_row_blocks": rows2}


def build(out_dir: Path, sources: dict) -> dict:
    from stereovisionarray_tpu_torch import _native

    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "common.cuh").write_text((_native.CSRC_DIR / "common.cuh").read_text())
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_native.nvcc_path(), *_native.NVCC_FLAGS, "-shared", "-o", str(out_dir / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"perf_k7_phases: nvcc failed on {name}:\n{out[-4000:]}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        fn = lib.svt_sgm_float_strips
        fn.argtypes = _native._SIGNATURES["svt_sgm_float_strips"]
        fn.restype = ctypes.c_int
        lib.svt_probe_set.argtypes = (ctypes.c_int, ctypes.c_int)
        libs[name] = (fn, lib.svt_probe_set)
    return libs


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("perf_k7_phases: needs a CUDA device")
    from stereovisionarray_tpu_torch import _native
    from stereovisionarray_tpu_torch.ops.cost_cuda import fused_cost_volume_cuda
    from stereovisionarray_tpu_torch.ops.sgm import ORDERS, p2_maps
    from stereovisionarray_tpu_torch.ops.sgm_cuda import sgm_aggregate_float

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    libs = build(_native.BUILD_DIR / "k7_phases",
                 variants((_native.CSRC_DIR / "sgm_paths.cu").read_text()))
    timings = (("full", 7, 3), ("rows", 1, 3), ("down", 2, 3), ("up", 4, 3),
               ("down_walk", 2, 1), ("down_combine", 2, 2), ("down_barriers", 2, 0),
               ("up_walk", 4, 1), ("up_combine", 4, 2), ("up_barriers", 4, 0))
    lines = []
    for (h, w, D), order in ((chip_smoke.BENCH_SHAPE, "k7"), ((270, 360, 128), "wdh")):
        left, right = chip_smoke.stereo_pair(torch, h, w, seed=1)
        vol = fused_cost_volume_cuda(left, right, D, (7, 9), 0.25, 32.0, "float32")
        p2_y, p2_x = p2_maps((h, w), 96.0, torch.float32, left.device, left, True, 24.0)
        plain = {n: sgm_aggregate_float(vol, p2_y, p2_x, 8.0, n, order=order, backend="torch")
                 for n in (4, 8)}
        runs = [("as_built", S, 8) for S in (8, 16, 32)] + [("as_built", 16, 4)] + [
            (name, 16, 8) for name in libs if name != "as_built"]
        for name, S, num_paths in runs:
            fn, setter = libs[name]
            out = torch.empty_like(vol)
            scratch = torch.empty((3, h, w, D), device=vol.device)
            ring = torch.empty((2, 3 if num_paths == 8 else 1, S, w, D), device=vol.device)
            args = (vol.data_ptr(), p2_y.data_ptr(), p2_x.data_ptr(), out.data_ptr(),
                    scratch[0].data_ptr(), scratch[1].data_ptr(), scratch[2].data_ptr(),
                    ring.data_ptr(), h, w, D, 8.0, num_paths, ORDERS.index(order), S)

            def call():
                err = fn(*args, torch._C._cuda_getCurrentRawStream(vol.device.index))
                if err:
                    raise SystemExit(f"perf_k7_phases: svt_sgm_float_strips returned {err}")

            setter(7, 3)
            call()
            torch.cuda.synchronize()
            if not torch.equal(out, plain[num_paths]):
                raise SystemExit(f"perf_k7_phases: {name} S={S} differs from the plain twin")
            row = {"shape": [h, w, D], "order": order, "num_paths": num_paths, "variant": name,
                   "strip_rows": S, "bit_exact": True, "card": card}
            for key, mask, mode in timings:
                setter(mask, mode)
                row[f"{key}_ms"] = chip_smoke.device_ms(torch, call, 20)
            setter(7, 3)
            lines.append(row)
            print(json.dumps(row), flush=True)
            del out, scratch, ring
        del vol, plain
        torch.cuda.empty_cache()
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "perf_k7_phases.json").write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()

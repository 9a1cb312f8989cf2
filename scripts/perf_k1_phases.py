#!/usr/bin/env python3
"""Where K1, the census + BT cost volume, spends its time on an NVIDIA GPU.

    python3 scripts/perf_k1_phases.py [--package-root DIR --tag NAME]

Builds text-patched copies of ``csrc/cost_volume.cu`` into
``stereovisionarray_tpu_torch/build/k1_phases/`` and times them behind a GPU
spin (``chip_smoke.device_ms``, 20 launches), each launched with the
arguments the wrapper ``fused_cost_volume_cuda`` hands the real kernel:

 - the whole kernel at every ``chip_smoke.K1_ROWS`` shape but the generic
   one (first held bit-exact to the plain twin ``fused_cost_volume``);
 - at 540x768x64 (int8, int16, float32) and 540x768x256 int8, the phases
   apart. For the untiled kernel (the form before the tiled one, and the
   generic form since): phase 1 only (the census and BT bounds built from
   device memory, the sweep skipped), phase 2 only (the census skipped: the
   sweep reads stale shared memory) and phase 2 without its BT arithmetic.
   For the tiled kernel: the staging only; the staging and the census / BT
   build; the sweep only (on stale shared memory); the whole kernel without
   its global stores (the out buffers still written) and without its BT
   arithmetic; the knobs measured and not kept: the exact magic-number
   conversions (the float of a popcount from its bits, round half to even
   from the low bits of v + 1.5 * 2^23) in place of I2F and F2I.rn, four
   staged loads in flight before their stores, the 7x9 census window read at
   run time instead of unrolled, out chunks capped at 64 and 32 bytes; and
   the whole kernel at tiles of 128 and 64 pixels (held bit-exact first).

``--package-root DIR`` reads the kernel and the package from another
checkout (an unpacked older commit), so that two versions compare within one
call. Prints one JSON line per configuration and writes them to
``chiprun_out/perf_k1_phases[_TAG].json``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import chip_smoke  # noqa: E402

# text patches of each kernel form: variant -> [(old, new)]
UNTILED = {
    "phase1_only": [("  __syncthreads();\n\n  OutT* out_row",
                     "  __syncthreads();\n  if (h > 0) return;\n  OutT* out_row")],
    "phase2_only": [("  for (int i = threadIdx.x; i < kTile + n_right; i += blockDim.x) {",
                     "  for (int i = threadIdx.x; h < 0 && i < kTile + n_right; i += blockDim.x) {")],
    "phase2_no_bt": [("      if (use_bt) {\n        const float lt",
                      "      if (h < 0) {\n        const float lt")],
}
TILED = {
    "stage_only": [("  __syncthreads();  // the rows are staged\n",
                    "  __syncthreads();  // the rows are staged\n  if (h > 0) return;\n")],
    "stage_build": [("  __syncthreads();  // the codes are built\n",
                     "  __syncthreads();  // the codes are built\n  if (h > 0) return;\n")],
    "sweep_only": [("item < n_items; item += tile)", "h < 0 && item < n_items; item += tile)"),
                   ("  for (int i = threadIdx.x; i < s.n_px; i += tile) {",
                    "  for (int i = threadIdx.x; h < 0 && i < s.n_px; i += tile) {")],
    # the write-out's loads and global stores never taken; the out buffers are written
    "no_store": [("      if (p < n_valid)\n", "      if (p < n_valid && n_disp < 0)\n")],
    "no_bt": [("  if (use_bt)\n    sweep_warp<", "  if (h < 0)\n    sweep_warp<")],
    # the exact magic-number conversions (the float of a popcount: its bits
    # OR'd into 2^23, less 2^23; round half to even: the low bits of
    # v + 1.5 * 2^23) in place of I2F and F2I.rn
    "magic_conversion": [
        ("namespace {\n", "#define __float2int_rn(v) __float_as_int((v) + 12582912.0f)\n"
                          "namespace {\n"),
        ("float cost = static_cast<float>(ham);",
         "float cost = __int_as_float(0x4B000000 | ham) - 8388608.0f;")],
    # the staging with four float4 loads in flight before the stores
    "stage_batch_4": [(
        "  for (int item = threadIdx.x; item < n_items; item += tile)\n"
        "    tile_smem[item] = staged_item(left, right, h, w, y - ph, row_items, left_items, "
        "xs_left,\n                                  xs_right, vec_ok, item);\n",
        "  for (int base = threadIdx.x; base < n_items; base += 4 * tile) {\n"
        "    float4 v[4];\n#pragma unroll\n    for (int b = 0; b < 4; ++b)\n"
        "      if (base + b * tile < n_items)\n"
        "        v[b] = staged_item(left, right, h, w, y - ph, row_items, left_items, xs_left,\n"
        "                           xs_right, vec_ok, base + b * tile);\n"
        "#pragma unroll\n    for (int b = 0; b < 4; ++b)\n"
        "      if (base + b * tile < n_items) tile_smem[base + b * tile] = v[b];\n  }\n")],
    # the census window read at run time (7x9 is unrolled at compile time)
    "runtime_window": [("  if (win_h == 7 && win_w == 9)\n",
                        "  if (h < 0 && win_h == 7 && win_w == 9)\n")],
    # the out chunk's cap
    "chunk_64": [("constexpr int kChunkMax = 128;", "constexpr int kChunkMax = 64;")],
    "chunk_32": [("constexpr int kChunkMax = 128;", "constexpr int kChunkMax = 32;")],
}
# the whole tiled kernel launched at another tile width than the plan's
TILE_WIDTHS = {"tile_128": 128, "tile_64": 64}

# the rows whose phases are timed apart
PHASE_ROWS = ("two_view_bench_int8", "two_view_bench_int16", "two_view_bench_float32",
              "two_view_flat_d256")


def patched(src: str, patches) -> str:
    for old, new in patches:
        if src.count(old) != 1:
            raise SystemExit(f"perf_k1_phases: cost_volume.cu holds {old!r} "
                             f"{src.count(old)} times, not once")
        src = src.replace(old, new)
    return src


def build(out_dir: Path, csrc: Path, sources: dict, nvcc: str, flags) -> dict:
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "common.cuh").write_text((csrc / "common.cuh").read_text())
    procs = {}
    for name, text in sources.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [nvcc, *flags, "-shared", "-o", str(out_dir / f"{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        out = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"perf_k1_phases: nvcc failed on {name}:\n{out[-4000:]}")
        fns[name] = ctypes.CDLL(str(out_dir / f"{name}.so")).svt_cost_volume
    return fns


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", type=Path, default=REPO,
                    help="checkout whose csrc/cost_volume.cu and package to time")
    ap.add_argument("--tag", default="", help="suffix of the output file and label of each line")
    args = ap.parse_args()
    root = args.package_root.resolve()
    sys.path.insert(0, str(root))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("perf_k1_phases: needs a CUDA device")
    from stereovisionarray_tpu_torch import _native
    from stereovisionarray_tpu_torch.ops.cost_cuda import fused_cost_volume_cuda
    from stereovisionarray_tpu_torch.ops.cost_volume import fused_cost_volume

    card = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()
    print(card, flush=True)
    csrc = root / "stereovisionarray_tpu_torch" / "csrc"
    src = (csrc / "cost_volume.cu").read_text()
    form = "tiled" if "cost_volume_tiled_kernel" in src else "untiled"
    variants = {"whole": src, **{n: patched(src, p)
                                for n, p in (TILED if form == "tiled" else UNTILED).items()}}
    fns = build(_native.BUILD_DIR / f"k1_phases{'_' + args.tag if args.tag else ''}", csrc,
                variants, _native.nvcc_path(), _native.NVCC_FLAGS)
    for fn in fns.values():
        fn.argtypes = _native._SIGNATURES["svt_cost_volume"]
        fn.restype = ctypes.c_int

    real_launch = _native.launch
    lines = []
    for row, (h, w, D), window, dtype in chip_smoke.K1_ROWS:
        if row.startswith("generic"):
            continue
        left, right = chip_smoke.stereo_pair(torch, h, w, seed=h + D, integer=dtype == "int8")
        seen = []
        _native.launch = lambda name, device, *a: seen.append(a)  # noqa: E731
        try:  # the wrapper's allocation and arguments, without its launch
            out = fused_cost_volume_cuda(left, right, D, window, 0.25, 32.0, dtype)
        finally:
            _native.launch = real_launch
        (kargs,) = seen
        stream = torch._C._cuda_getCurrentRawStream(left.device.index)

        def call(fn):
            err = fn(*kargs, stream)
            if err:
                raise SystemExit(f"perf_k1_phases: svt_cost_volume returned {err}")

        call(fns["whole"])
        torch.cuda.synchronize()
        want = fused_cost_volume(left, right, D, window, 0.25, 32.0, dtype)
        if not torch.equal(out, want):
            raise SystemExit(f"perf_k1_phases: {row} differs from the plain twin")
        names = list(fns) if row in PHASE_ROWS else ["whole"]
        line = {"row": row, "shape": [h, w, D], "window": list(window), "dtype": dtype,
                "form": form, "bit_exact": True, "tag": args.tag, "card": card}
        for name in names:
            line[f"{name}_ms"] = chip_smoke.device_ms(torch, lambda: call(fns[name]), 20)
        if form == "tiled" and row in PHASE_ROWS:
            plan_tile = kargs[13]
            for name, tile in TILE_WIDTHS.items():
                kargs = (*kargs[:13], tile)
                call(fns["whole"])
                torch.cuda.synchronize()
                if not torch.equal(out, want):
                    raise SystemExit(f"perf_k1_phases: {row} at tile {tile} differs")
                line[f"{name}_ms"] = chip_smoke.device_ms(torch, lambda: call(fns["whole"]), 20)
            kargs = (*kargs[:13], plan_tile)
        lines.append(line)
        print(json.dumps(line), flush=True)
        del out, want
        torch.cuda.empty_cache()
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    name = f"perf_k1_phases_{args.tag}.json" if args.tag else "perf_k1_phases.json"
    (out_dir / name).write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()

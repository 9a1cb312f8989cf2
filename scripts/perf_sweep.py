#!/usr/bin/env python3
"""K8, the plane sweep, on an NVIDIA GPU: device time, its share of the
roofline, SM cycles a pixel-view, and what the compiler made of it.

    python3 scripts/perf_sweep.py [--package-root DIR --tag NAME] [--iters N] [--sass]

For the two array cells' K8 shapes (270x360, 128 planes, census 5x5 over
the 5x5 rig's translation shifts: CROSS, 4 sources, the ceiling-padded mean;
to_center, 24 sources, the mean of the 6 best), one JSON line each with:
the kernel's device ms (CUDA events around launches queued behind a GPU
spin, ``perf_kernels.device_ms``), whether its outputs equal the plain twin's
bit for bit, ``benchmark/rooflines.plane_sweep``'s bound and the share,
pixel-views (pixels x planes x sources) a second, and SM cycles a
pixel-view at the SM clock ``nvidia-smi`` reads while the kernel runs
(132 SMs). Before them: the card, and ptxas's registers, spills and shared
memory of every plane_sweep kernel (``-Xptxas -v``). ``--sass`` adds the
SASS of the specialised kernel (``cuobjdump -sass``): for each
instantiation, the opcodes of its innermost loop (one plane and source) by
class and in full, and of the whole kernel; the listing goes to
``chiprun_out/perf_sweep_sass[_TAG].txt``.

``--package-root DIR`` times the kernel of another checkout (an unpacked
older commit), so that two versions compare within one call. Every line is
also written to ``chiprun_out/perf_sweep[_TAG].json``. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import subprocess
import sys
import threading
from collections import Counter
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
OUT = REPO / "chiprun_out"
N_SMS = 132
# (cell, config overrides): the array cells' K8 calls (benchmark/configs/array5x5_*.json)
CASES = (("array_cross_live", {"plane_sweep.topology": "CROSS"}),
         ("array_tocenter_live", {}))
# SASS opcode classes counted apart; everything else counts as "rest"
CLASSES = {
    "FSETP": ("FSETP",), "LOP3/SEL": ("LOP3", "SEL", "FSEL"), "SHF/PRMT": ("SHF", "PRMT"),
    "FMNMX/IMNMX/VIMNMX": ("FMNMX", "IMNMX", "VIMNMX"), "FADD/FMUL/FFMA": ("FADD", "FMUL", "FFMA"),
    "SHFL": ("SHFL",), "LDG": ("LDG",), "LDS/STS": ("LDS", "STS"), "POPC": ("POPC",),
    "I2F/F2I": ("I2F", "F2I", "I2FP", "F2IP", "FRND"), "IMAD/IADD3/LEA": ("IMAD", "IADD3", "LEA"),
    "ISETP": ("ISETP",),
}


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip()


def sm_clock_mhz() -> float:
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    return float(out)


def kernel_label(mangled: str) -> str:
    """plane_sweep_fast_kernel<5,true,...> from a mangled name."""
    m = re.search(r"(plane_sweep(?:_[a-z]+)*_kernel)(I\w*?E)?E", mangled)
    if not m:
        return mangled
    args = re.findall(r"L([ib])(\d+)E", m.group(2) or "")
    vals = [("true" if v == "1" else "false") if k == "b" else v for k, v in args]
    return m.group(1) + (f"<{','.join(vals)}>" if vals else "")


def ptxas_report(nvcc: str, flags, source: Path, obj: Path) -> dict:
    """Registers, spills and shared memory of each plane_sweep kernel."""
    r = subprocess.run([nvcc, *flags, "-Xptxas", "-v", "-c", "-o", str(obj), str(source)],
                       capture_output=True, text=True)
    if r.returncode:
        raise SystemExit(f"perf_sweep: nvcc failed:\n{(r.stdout + r.stderr)[-4000:]}")
    report, name = {}, None
    for line in (r.stdout + r.stderr).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line) or \
            re.search(r"Function properties for (\S+)", line)
        if m:
            name = kernel_label(m.group(1))
            report.setdefault(name, {})
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and name:
            report[name].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            report[name]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            report[name]["smem"] = int(m.group(1)) if m else 0
    return {k: v for k, v in report.items() if "plane_sweep" in k}


def opcode_classes(ops) -> dict:
    counts = Counter(op.split(".")[0] for op in ops)
    out = {cls: sum(counts[o] for o in names) for cls, names in CLASSES.items()}
    out["rest"] = sum(counts.values()) - sum(out.values())
    out["total"] = sum(counts.values())
    return out


def loop_paths(insns, start, end, limit=8):
    """The opcodes issued along each way from the loop's head to its back
    branch: a predicated forward branch forks, an unconditional one jumps."""
    at = {a: i for i, (a, *_) in enumerate(insns)}
    paths, todo = [], [(at[start], [])]
    while todo and len(paths) < limit:
        i, ops = todo.pop()
        while True:
            a, op, target, predicated = insns[i]
            ops = ops + [op]
            if a >= end:
                paths.append(ops)
                break
            if target is not None and a < target <= end:
                if not predicated:
                    i = at[target]
                    continue
                todo.append((at[target], ops))
            i += 1
    return sorted(paths, key=len)


def sass_report(cuobjdump: str, obj: Path, listing: Path) -> dict:
    """For each specialised kernel: its innermost loop's opcodes by class,
    the opcodes issued along each way through one iteration, and the whole
    kernel's by class."""
    text = subprocess.run([cuobjdump, "-sass", str(obj)], capture_output=True, text=True,
                          check=True).stdout
    listing.write_text(text)
    report = {}
    for block in re.split(r"\n\s*Function : ", text)[1:]:
        name = kernel_label(block.split()[0])
        if "plane_sweep_fast" not in name:
            continue
        insns = []  # (address, opcode, branch target or None, predicated)
        for m in re.finditer(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);",
                             block):
            addr, op, rest = int(m.group(1), 16), m.group(3), m.group(4)
            t = re.search(r"0x([0-9a-f]+)", rest) if op.startswith("BRA") else None
            insns.append((addr, op, int(t.group(1), 16) if t else None, m.group(2) is not None))
        loops = [(t, a) for a, _, t, _ in insns if t is not None and t <= a]
        # innermost: a backward branch whose range holds no other backward branch's range
        inner = [(s, e) for s, e in loops
                 if not any((s2, e2) != (s, e) and s <= s2 and e2 <= e for s2, e2 in loops)]
        entry = {"whole": opcode_classes([op for _, op, _, _ in insns])}
        if inner:
            s, e = max(inner, key=lambda r: r[1] - r[0])
            entry["loop"] = {"range": [hex(s), hex(e)],
                             **opcode_classes([op for a, op, _, _ in insns if s <= a <= e])}
            for i, path in enumerate(loop_paths(insns, s, e)):
                entry[f"path{i}"] = {**opcode_classes(path),
                                     "opcodes": dict(Counter(o.split(".")[0] for o in path).most_common())}
        report[name] = entry
    return report


class ClockSampler:
    """nvidia-smi's SM clock, sampled in a thread while the kernel runs."""

    def __init__(self):
        self.mhz, self._stop = [], threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self._stop.is_set():
            self.mhz.append(sm_clock_mhz())

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package-root", type=Path, default=REPO,
                    help="checkout whose stereovisionarray_tpu_torch to time")
    ap.add_argument("--tag", default="", help="suffix of the output files and label of each line")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sass", action="store_true")
    args = ap.parse_args()
    root = args.package_root.resolve()
    sys.path.insert(0, str(root))
    sys.path.insert(1, str(REPO))

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("perf_sweep: needs a CUDA device")
    from benchmark import rooflines
    from perf_kernels import device_ms
    from stereovisionarray_tpu_torch import _native, config
    from stereovisionarray_tpu_torch.datasets.synthetic import reference_rig, render_camera_array
    from stereovisionarray_tpu_torch.geometry import inverse_depth_samples
    from stereovisionarray_tpu_torch.models.array_pipeline import reference_and_sources
    from stereovisionarray_tpu_torch.models.plane_sweep import translation_shifts
    from stereovisionarray_tpu_torch.ops.sweep_cuda import plane_sweep_census

    suffix = f"_{args.tag}" if args.tag else ""
    OUT.mkdir(exist_ok=True)
    lines = [{"card": card_line(), "device": torch.cuda.get_device_name(0),
              "torch": torch.__version__, "cuda": torch.version.cuda, "package": str(root),
              "tag": args.tag}]
    print(json.dumps(lines[-1]), flush=True)

    build = _native.BUILD_DIR / f"perf_sweep{suffix}"
    build.mkdir(parents=True, exist_ok=True)
    obj = build / "plane_sweep.o"
    nvcc = _native.nvcc_path()
    lines.append({"ptxas": ptxas_report(nvcc, _native.NVCC_FLAGS,
                                        _native.CSRC_DIR / "plane_sweep.cu", obj), "tag": args.tag})
    print(json.dumps(lines[-1]), flush=True)
    if args.sass:
        cuobjdump = str(Path(nvcc).parent / "cuobjdump")
        for name, entry in sass_report(cuobjdump, obj, OUT / f"perf_sweep_sass{suffix}.txt").items():
            lines.append({"sass": name, **entry, "tag": args.tag})
            print(json.dumps(lines[-1]), flush=True)

    h, w, D = 270, 360, 128
    cams = reference_rig(rows=5, cols=5, spacing=0.05, resolution=(h, w))
    images = torch.from_numpy(np.round(render_camera_array(cams, (h, w))[0])).float().cuda()
    for cell, over in CASES:
        cfg = config.EngineConfig().override(**{"camera.rows": 5, "camera.cols": 5,
                                                "plane_sweep.num_planes": D, **over})
        ps = cfg.plane_sweep
        ref_index, src = reference_and_sources(cfg, images.shape[0])
        depths = inverse_depth_samples(ps.z_near, ps.z_far, ps.num_planes)
        shifts = torch.from_numpy(np.ascontiguousarray(
            translation_shifts(cams, ref_index, src, depths).swapaxes(0, 1))).cuda()
        topk = ps.topk if ps.fusion == "topk_mean" and ps.topk < len(src) else None
        ref, srcs = images[ref_index].contiguous(), images[list(src)].contiguous()
        call = lambda b="auto": plane_sweep_census(ref, srcs, shifts, ps.patch,  # noqa: E731
                                                   ps.fusion == "mean", topk, b)
        got, want = call(), call("torch")
        exact = all(torch.equal(a, b) for a, b in zip(got, want))
        with ClockSampler() as clock:  # ~1 s of back-to-back launches under the sampler
            ms = [device_ms(torch, call, args.iters) for _ in range(5)]
            n_more = max(1, int(1000 / max(ms)))
            for _ in range(n_more):
                call()
            torch.cuda.synchronize()
        dev = statistics.median(ms)
        mhz = statistics.median(clock.mhz) if clock.mhz else None
        bound, by = rooflines.bound_ms(*rooflines.plane_sweep(h, w, D, len(src)))
        pv = h * w * D * len(src)
        lines.append({
            "cell": cell, "shape": [h, w, D], "sources": len(src), "patch": ps.patch,
            "topk": topk, "bit_exact": exact, "device_ms": dev, "device_ms_runs": ms,
            "bound_ms": bound, "bound_by": by, "roofline_pct": 100.0 * bound / dev,
            "pixel_views": pv, "gpv_per_s": pv / dev / 1e6, "sm_clock_mhz": mhz,
            "sm_clock_samples": len(clock.mhz),
            "sm_cycles_per_pv": None if mhz is None else dev * 1e-3 * mhz * 1e6 * N_SMS / pv,
            "tag": args.tag})
        print(json.dumps(lines[-1]), flush=True)
        if not exact:
            raise SystemExit(f"perf_sweep: {cell} differs from the plain twin")
    (OUT / f"perf_sweep{suffix}.json").write_text(json.dumps(lines, indent=1))


if __name__ == "__main__":
    main()

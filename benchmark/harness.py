"""One run of one cell: set-up, the measured window, the readers, the check.

Everything a cell is made of is found by name (``benchmark/parts.py``):
the workload names its configuration file and its traffic
(``traffic/<name>.json``); the configuration names its pipeline kind
(``pipelines/<kind>.py``) and its reference, the traffic its loop
(``loops/<loop>.py``); every metric is read by ``metrics/<name>.py``, a
module with ``read(run) -> float | None``. A later cell, loop, kind or
metric is a new file and a new entry; no file here changes for it.

The run prints, on standard output, a line splitting the set-up and a line
of facts about the window, then the result line, last; on standard error,
last, each number the check compared with its limit.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Dict, List, Optional

import numpy as np

from benchmark import loops, parts, pipelines
from benchmark.parts import HERE, ROOT, load_json
from benchmark.trace import Recorder, Trace, port_kernel_names

FORBIDDEN = ("jax", "jaxlib", "flax", "stereovisionarray_tpu")
UNITS_PER_S_CAP = 5000  # the most units a second any loop could hand over


def cell(spec: Dict, workload: str, base: Path = HERE) -> SimpleNamespace:
    """A workload's entry, configuration, traffic and the metrics it reports
    (``end_to_end`` and ``per_layer``, each as BENCHMARK.json lists them)."""
    entry = next((w for w in spec["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise SystemExit(f"benchmark: no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in spec["configs"] if c["name"] == entry["config"])

    def here(m):
        return "workloads" not in m or workload in m["workloads"]

    return SimpleNamespace(
        entry=entry, config=load_json(ROOT / conf["file"]),
        traffic=load_json(base / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if here(m)],
        per_layer=[m for m in spec["per_layer"] if here(m)])


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def run_cell(spec: Dict, workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", t_origin: Optional[float] = None, base: Path = HERE) -> Dict:
    """Run one cell once and return its result (the last line's object, with
    ``setup`` and ``window`` facts beside it under keys of their own).
    `t_origin` is the process's start on the ``time.perf_counter`` clock."""
    t_start = time.perf_counter() if t_origin is None else t_origin
    seed %= 2**63  # numpy's generators take non-negative seeds
    import torch

    c = cell(spec, workload, base)
    tr = c.traffic
    pipe = pipelines.make(torch, device, c.config, base)
    t0 = time.perf_counter()
    pipe.load()
    t_load = time.perf_counter()
    pool = pipe.make_pool(seed, int(tr["pool"]))
    t_inputs = time.perf_counter()
    loop = loops.make(torch, pipe, pool, tr, seed, base)
    loop.run(float("inf"), int(tr["warmup_units"]))
    pipe.synchronize()
    t_ready = time.perf_counter()
    setup = {"process_s": t0 - t_start, "kernel_load_s": t_load - t0,
             "inputs_s": t_inputs - t_load, "warmup_s": t_ready - t_inputs,
             "setup_s": t_ready - t_start}

    on_card = device == "cuda"
    needs_device_time = any(m["source"] == "device_trace" for m in c.end_to_end)
    window_s = min(seconds, float(tr["trace_seconds"])) if trace else seconds
    n_max = int(window_s * UNITS_PER_S_CAP) + 1000
    rec = None
    if on_card and (trace or needs_device_time):
        rec = Recorder(torch, host=trace)
        from torch.profiler import record_function

        with rec:
            win = loop.run(window_s, n_max, spans=record_function if trace else None)
    else:
        win = loop.run(window_s, n_max)
    memory_peak = torch.cuda.max_memory_allocated(pipe.device) if on_card else 0
    t_closed = time.perf_counter()
    tr_obj = rec.trace() if rec is not None else Trace([])
    t_read = time.perf_counter()

    run = SimpleNamespace(config=c.config, traffic=tr, units=win.units, window_s=win.seconds,
                          latencies=win.latencies, setup_s=setup["setup_s"], trace=tr_obj,
                          port_kernels=port_kernel_names() if on_card else ())
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        value = parts.find(base, "metrics", m["name"], "read")(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(pipe.device) if on_card else "cpu",
           "count": int(c.entry["chips"]), "memory_peak_bytes": int(memory_peak)}
    result = {"correct": False, "attempted": win.units, "failed": 0, "metrics": metrics,
              "device": dev}
    if trace and on_card:
        dev["busy_s"] = tr_obj.busy_s()
        dev["window_s"] = win.seconds
        result["breakdown"] = {"device_ops": tr_obj.top_device_ops(),
                               "idle_gaps": tr_obj.idle_gaps()}

    # the check, once the window has closed and the peak has been read: the
    # program's state goes, the sampled outputs stay
    samples = [s for s in win.samples if s is not None]
    del loop, win, rec, tr_obj
    if on_card:
        torch.cuda.empty_cache()
    checks = check(torch, pipe, pool, samples, c.config)
    t_checked = time.perf_counter()
    missing = min(int(tr["check"]), result["attempted"]) - len(samples)
    result["failed"] = max(missing, 0)
    result["correct"] = bool(samples) and missing <= 0 and all(
        v["value"] <= v["limit"] for v in checks.values())
    result["checks"] = checks
    result["setup"] = setup
    result["window"] = {"seconds": run.window_s, "units": run.units,
                        "ms_per_unit": 1e3 * run.window_s / max(run.units, 1),
                        "trace_read_s": t_read - t_closed, "check_s": t_checked - t_read}
    if run.latencies is not None and len(run.latencies):
        q = np.percentile(run.latencies, [5, 50, 95, 99]) * 1e3
        result["window"]["latency_ms_p5_p50_p95_p99"] = [float(x) for x in q]
    return result


def check(torch, pipe, pool, samples, config: Dict) -> Dict:
    """Pixels of the sampled units' maps (and of their host copies, where
    the loop fetched them) that differ from the plain reference's, per map,
    summed over the samples, each with the configuration's limit."""
    counts: Dict[str, int] = {}
    for p, out, host in samples:
        want = pipe.reference(pool[p])
        got = pipe.maps(out)
        for k, v in pipelines.mismatches(torch, got, want, got.keys()).items():
            counts[f"{k}_px"] = counts.get(f"{k}_px", 0) + v
        if host is not None:
            for k, v in pipelines.mismatches(torch, host, want, host.keys()).items():
                counts[f"host_{k}_px"] = counts.get(f"host_{k}_px", 0) + v
        del want, got
    limits = config["limits"]
    return {k: {"value": v, "limit": limits[k.removeprefix("host_")]} for k, v in counts.items()}


def nvidia_smi() -> Optional[str]:
    try:
        return subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip() or None
    except (OSError, subprocess.SubprocessError):
        return None


def emit(result: Dict) -> None:
    """Print a run: the set-up split and the window's facts, then the result
    line with the compared numbers last; those numbers, last, on stderr."""
    result = dict(result)
    checks = result.pop("checks")
    print(json.dumps({"setup": result.pop("setup"), "card": nvidia_smi()}), flush=True)
    print(json.dumps({"window": result.pop("window")}), flush=True)
    result["checks"] = checks
    print(json.dumps(result), flush=True)
    for k, v in checks.items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=sys.stderr)
    print(f"check correct: {result['correct']}", file=sys.stderr, flush=True)


def main(argv=None, t_origin: Optional[float] = None) -> int:
    import argparse

    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = load_json(ROOT / "BENCHMARK.json")
    chips = int(cell(spec, args.workload).entry["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                      t_origin=t_origin)
    found = forbidden_modules()
    if found:
        print(f"benchmark: loaded {', '.join(found)}; the benchmark runs the port alone",
              file=sys.stderr)
        return 3
    emit(result)
    return 0

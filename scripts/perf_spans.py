"""The program's stage spans (``svt.*``, ``utils.profiling.span``) on the
card, cell by cell of the benchmark (``BENCHMARK.json``):

- the cell's units a second in a traced window (the host's activity too,
  the harness's ``bench.*`` spans open), then in one under the CUDA-only
  profiler the end-to-end device time uses, then in one with no profiler;
- the traced window by span name: host ms, card-idle ms and kernel launches
  (``cudaLaunchKernel*`` / ``cuLaunchKernel*``) a unit inside each span, and
  the same for all ``svt.*`` spans together and for the harness's spans;
- where the pipeline has them, the two clocks against each other: each
  pair's K1 kernel (``cost_volume*``) must start after its
  ``svt.two_view.cost`` span opens and its K4 kernel (``extract_maps*``)
  after its ``svt.two_view.extract`` span opens, and each before the next
  pair's span opens;
- a span's own cost on this host: the gated helper with no profiler and
  inside one, a bare ``record_function`` with no profiler.

    python3 scripts/perf_spans.py [--cell NAME] [--seed N] [--seconds S]

Without ``--cell`` every cell runs, each in a process of its own: a second
profiler session in one process has put the card's timestamps milliseconds
off the host's, so the traced window is each process's first session.
Prints the card's name and power limit, then one JSON line a cell and one
for the span's cost. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark import harness, loops, pipelines, spans  # noqa: E402
from benchmark.parts import load_json  # noqa: E402
from benchmark.trace import Recorder  # noqa: E402


def by_span(tr, units: int, prefixes) -> dict:
    """{span: [host ms, idle ms, launches] a unit} for each prefix."""
    return {p: [1e3 * float(np.diff(spans.union(tr, p), axis=1).sum()) / 1e9 / units,
                1e3 * spans.idle_covered_s(tr, p) / units,
                spans.launches_in(tr, p) / units] for p in prefixes}


def clock_order(tr, span_name: str, kernel: str) -> dict:
    """Each unit's `kernel` against its `span_name` span: started after it
    opened, and before the next unit's span opened."""
    opened = np.sort(tr.host_start[[i for i, n in enumerate(tr.host_names) if n == span_name]])
    ran = np.sort(tr.dev_start[tr.kernel_mask(kernel)])
    n = min(len(opened), len(ran))
    lead = ran[:n] - opened[:n]
    before_next = ran[:n - 1] < opened[1:n] if n > 1 else np.zeros(0, dtype=bool)
    return {"spans": int(len(opened)), "kernels": int(len(ran)),
            "after_open": int((lead >= 0).sum()), "before_next": int(before_next.sum()),
            "lead_us_min_median": ([float(lead.min()) / 1e3, float(np.median(lead)) / 1e3]
                                   if n else None)}


def cell(name: str, seed: int, seconds: float) -> dict:
    spec = load_json(ROOT / "BENCHMARK.json")
    c = harness.cell(spec, name)
    pipe = pipelines.make(torch, "cuda", c.config)
    pipe.load()
    pool = pipe.make_pool(seed, int(c.traffic["pool"]))
    loop = loops.make(torch, pipe, pool, c.traffic, seed)
    loop.run(float("inf"), int(c.traffic["warmup_units"]))
    pipe.synchronize()
    n_max = int(seconds * harness.UNITS_PER_S_CAP) + 1000
    rates = {}
    rec = Recorder(torch, host=True)
    with rec:
        traced = loop.run(seconds, n_max, spans=torch.profiler.record_function)
    rates["traced"] = traced.units / traced.seconds
    with Recorder(torch, host=False):
        win = loop.run(seconds, n_max)
    rates["cuda_only_profiler"] = win.units / win.seconds
    win = loop.run(seconds, n_max)
    rates["no_profiler"] = win.units / win.seconds
    tr, u = rec.trace(), traced.units
    names = sorted({n for n in tr.host_names if n.startswith("svt.")})
    out = {"cell": name, "seed": seed, "units_per_s": rates, "traced_units": u,
           "window_s": traced.seconds, "busy_s": tr.busy_s(),
           "idle_ms": 1e3 * (traced.seconds - tr.busy_s()) / u,
           "kernels": int(tr.kernel_mask().sum()) / u,
           "launch_calls": sum(n.startswith(spans.LAUNCHES) for n in tr.host_names) / u,
           "span_host_idle_launches": by_span(tr, u, names + ["svt.", "bench."]),
           "idle_gaps": tr.idle_gaps()}
    if "svt.two_view.cost" in names:
        out["clock_k1"] = clock_order(tr, "svt.two_view.cost", "cost_volume")
        out["clock_k4"] = clock_order(tr, "svt.two_view.extract", "extract_maps")
    return out


def span_cost(n: int = 20000) -> dict:
    from torch.profiler import ProfilerActivity, profile, record_function

    from stereovisionarray_tpu_torch.utils.profiling import span

    def per_call_us(make):
        t0 = time.perf_counter()
        for _ in range(n):
            with make("svt.x"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    off = per_call_us(span)
    bare = per_call_us(record_function)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        on = per_call_us(span)
    return {"span_us_off": off, "span_us_on": on, "record_function_us_no_profiler": bare,
            "calls": n}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", default=None, help="one cell (default: every cell in turn)")
    ap.add_argument("--seed", type=int, default=2**31 + 101)
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("perf_spans: no CUDA device", file=sys.stderr)
        return 2
    if args.cell:
        print(json.dumps(cell(args.cell, args.seed, args.seconds)), flush=True)
        return 0
    print(json.dumps({"card": harness.nvidia_smi(), "torch": torch.__version__}), flush=True)
    for i, w in enumerate(load_json(ROOT / "BENCHMARK.json")["workloads"]):
        subprocess.run([sys.executable, __file__, "--cell", w["name"], "--seed",
                        str(args.seed + i), "--seconds", str(args.seconds)], check=True)
    print(json.dumps(span_cost()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

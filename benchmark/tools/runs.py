"""Run one cell several times, one process a run, and summarise the runs:

    python3 -m benchmark.tools.runs --workload kitti_stream --seeds 11,12,13 \
        --seconds 10 [--trace 1] [--label name] [--out benchmark/.cache/runs]

Each run is ``python3 -m benchmark.run`` with its own seed, one after the
other. Every run's lines (set-up split, window facts, result) and the end
of its standard error go to ``<out>/<label>.jsonl``; the summary gives each
metric's median and its spread, the distance between the first and the
third quartile (``statistics.quantiles(values, n=4)``) over the median.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path


def spread(values):
    if len(values) < 2:
        return None
    q1, q2, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / q2 if q2 else None


def summary(runs):
    """{metric: {median, spread, values}} over the runs that printed a result."""
    out = {}
    names = sorted({k for r in runs if r.get("result") for k in r["result"]["metrics"]})
    for k in names:
        vals = [r["result"]["metrics"][k]["value"] for r in runs
                if r.get("result") and k in r["result"]["metrics"]]
        out[k] = {"median": statistics.median(vals), "spread": spread(vals), "values": vals}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds, one run each")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--label", default=None)
    ap.add_argument("--out", default="benchmark/.cache/runs")
    args = ap.parse_args(argv)
    label = args.label or f"{args.workload}_t{args.trace}"
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    runs = []
    with open(out_dir / f"{label}.jsonl", "a") as log:
        for seed in [int(s) for s in args.seeds.split(",")]:
            cmd = [sys.executable, "-m", "benchmark.run", "--workload", args.workload,
                   "--seed", str(seed), "--seconds", str(args.seconds), "--trace", str(args.trace)]
            t0 = time.perf_counter()
            p = subprocess.run(cmd, capture_output=True, text=True)
            lines = [json.loads(x) for x in p.stdout.splitlines() if x.startswith("{")]
            run = {"label": label, "seed": seed, "rc": p.returncode,
                   "wall_s": time.perf_counter() - t0,
                   "result": lines[-1] if p.returncode == 0 and lines else None,
                   "lines": lines[:-1], "stderr": p.stderr[-3000:]}
            runs.append(run)
            log.write(json.dumps(run) + "\n")
            log.flush()
            res = run["result"] or {}
            print(json.dumps({"seed": seed, "rc": p.returncode, "wall_s": round(run["wall_s"], 2),
                              "correct": res.get("correct"), "attempted": res.get("attempted"),
                              "metrics": {k: v["value"] for k, v in res.get("metrics", {}).items()},
                              "device": res.get("device"), "lines": run["lines"]}), flush=True)
            if p.returncode != 0 or not res.get("correct"):
                print(p.stderr[-2500:], file=sys.stderr, flush=True)
    print(json.dumps({"label": label, "summary": summary(runs)}), flush=True)
    return 0 if all(r["rc"] == 0 and (r["result"] or {}).get("correct") for r in runs) else 1


if __name__ == "__main__":
    sys.exit(main())

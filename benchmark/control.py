"""Readings that set a cell's limits: the program's own on many seeds, and
the control's, in one process (the benchmark's runs do not run this).

    python3 -m benchmark.control --workload kitti_stream --seeds 1,2,3 --seconds 2

For each seed the cell's traffic runs a short window at the cell's own size
and load, and the check compares the sampled units with the plain
reference, as a run does: the sound reading. The control is the step below
the precision the configuration states (its ``control`` entry):

- ``kind: "program"``: the program itself with the ``engine`` settings given
  there (the two-view cell's int8 costs for its int16), over the same
  window and compared with the reference of the configuration as stated;
- ``kind: "reference"``: the reference put in the program's place with the
  refinement computed in ``refine_dtype`` (the array's bfloat16 for its
  float32), on the same sampled units.

Each line gives a seed's readings; the last, per number, the largest sound
reading (the lower one) and the smallest control reading (the upper one).
A control that fails no number is reported as such.
"""

from __future__ import annotations

import argparse
import copy
import json
import sys
from pathlib import Path
from typing import Dict, List

from benchmark import harness, loops, pipelines


def merged(base: Dict, over: Dict) -> Dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        out[k] = merged(out[k], v) if isinstance(v, dict) and isinstance(out.get(k), dict) else v
    return out


def window_samples(torch, pipe, pool, traffic, seed, seconds, base):
    loop = loops.make(torch, pipe, pool, traffic, seed, base)
    loop.run(float("inf"), int(traffic["warmup_units"]))
    win = loop.run(seconds, int(seconds * harness.UNITS_PER_S_CAP) + 1000)
    return [s for s in win.samples if s is not None], win.units


def readings(torch, workload: str, seeds: List[int], seconds: float, device: str = "cuda",
             base: Path = harness.HERE, spec: Dict = None):
    """Yield {seed, units, sound, control} per seed."""
    spec = spec or harness.load_json(harness.ROOT / "BENCHMARK.json")
    c = harness.cell(spec, workload, base)
    ctl = c.config["control"]
    pipe = pipelines.make(torch, device, c.config, base)
    pipe.load()
    alt = None
    if ctl["kind"] == "program":
        alt = pipelines.make(torch, device, merged(c.config, {"engine": ctl["engine"]}), base)
        alt.load()
    for seed in seeds:
        pool = pipe.make_pool(seed, int(c.traffic["pool"]))
        samples, units = window_samples(torch, pipe, pool, c.traffic, seed, seconds, base)
        sound = harness.check(torch, pipe, pool, samples, c.config)
        if alt is not None:
            samples, _ = window_samples(torch, alt, pool, c.traffic, seed, seconds, base)
            control = harness.check(torch, pipe, pool, samples, c.config)
        else:  # the reference in the program's place, in the lower precision
            counts: Dict[str, int] = {}
            for p, _, _ in samples:
                got = pipe.reference(pool[p], control=True)
                for k, v in pipelines.mismatches(torch, got, pipe.reference(pool[p])).items():
                    counts[f"{k}_px"] = counts.get(f"{k}_px", 0) + v
            control = {k: {"value": v, "limit": c.config["limits"][k]} for k, v in counts.items()}
        del samples
        yield {"seed": seed, "units": units, "sound": sound, "control": control}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    import torch

    lows: Dict[str, float] = {}
    highs: Dict[str, float] = {}
    for row in readings(torch, args.workload, [int(s) for s in args.seeds.split(",")],
                        args.seconds):
        print(json.dumps(row), flush=True)
        for k, v in row["sound"].items():
            lows[k] = max(lows.get(k, 0), v["value"])
        for k, v in row["control"].items():
            highs[k] = min(highs.get(k, float("inf")), v["value"])
    print(json.dumps({"lower": lows, "upper": highs,
                      "control_fails": any(v > 0 for v in highs.values())}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

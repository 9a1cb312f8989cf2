"""A throwaway benchmark at a tiny size, written as files into a temporary
directory: the repository's readers, loops, pipeline kinds and traffic
files copied beside small copies of the two configurations, and a spec that
points at them."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from benchmark import harness

SMALL = {"kitti2015_sgm": {"image": [20, 40], "engine.cost.num_disparities": 16},
         "array5x5_cross": {"rig.resolution": [27, 36], "engine.camera.resolution": [27, 36],
                            "engine.plane_sweep.num_planes": 16}}


def set_dotted(d, key, value):
    *head, last = key.split(".")
    for k in head:
        d = d[k]
    d[last] = value


# a size a test on the card holds: half the KITTI frame at D=128, the array whole
ON_CARD = {"kitti2015_sgm": {"image": [188, 624], "engine.cost.num_disparities": 128},
           "array5x5_cross": {}}


def tiny_bench(tmp: Path, sizes=SMALL, **traffic_over):
    """(spec, base): the benchmark at the `sizes` (tiny by default) under `tmp`."""
    spec = copy.deepcopy(harness.load_json(harness.ROOT / "BENCHMARK.json"))
    for folder in ("metrics", "loops", "pipelines"):
        shutil.copytree(harness.HERE / folder, tmp / folder,
                        ignore=shutil.ignore_patterns("__pycache__"))
    (tmp / "traffic").mkdir()
    for f in (harness.HERE / "traffic").glob("*.json"):
        t = harness.load_json(f)
        t.update(pool=2, warmup_units=2, check=2, **traffic_over)
        (tmp / "traffic" / f.name).write_text(json.dumps(t))
    for conf in spec["configs"]:
        cfg = harness.load_json(harness.ROOT / conf["file"])
        for k, v in sizes[conf["name"]].items():
            set_dotted(cfg, k, v)
        path = tmp / f"{conf['name']}.json"
        path.write_text(json.dumps(cfg))
        conf["file"] = str(path)
    return spec, tmp

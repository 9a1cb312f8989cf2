"""Where the benchmark finds its parts: each is a file, found by the name
that ``BENCHMARK.json``, a configuration file or a traffic file gives it.

Under the benchmark's folder (``base``):

- ``traffic/<traffic>.json``: a traffic mix's parameters;
- ``loops/<loop>.py``: the loop a traffic file names (``loop``), a class ``Loop``;
- ``pipelines/<kind>.py``: the kind a configuration names (``pipeline``), a
  class ``Kind``;
- ``metrics/<metric>.py``: a metric's reader, a function ``read``.

Configuration files and references are named by their path from the
checkout's root: ``BENCHMARK.json``'s ``file``, a configuration's
``reference``. A later cell, loop, kind or metric is a new file and a new
entry; no file that is there changes for it.
"""

from __future__ import annotations

import importlib.util
import json
import re
import sys
from pathlib import Path
from typing import Dict

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """The Python file at `path`, run as a module of its own."""
    path = Path(path)
    name = "benchmark_part_" + re.sub(r"\W", "_", f"{path.parent.name}_{path.stem}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def find(base: Path, folder: str, name: str, attr: str):
    """The `attr` of ``<base>/<folder>/<name>.py``."""
    path = Path(base) / folder / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"benchmark: no {folder}/{name}.py for {name!r}")
    return getattr(load_module(path), attr)

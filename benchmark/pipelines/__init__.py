"""The system under test, one file a kind of configuration.

A configuration file names its ``pipeline``: ``pipelines/<kind>.py`` holds a
class ``Kind`` that subclasses :class:`Pipeline` here. It makes the cell's
inputs from the seed, calls the port's entry point on one unit of work (a
rectified pair, a frame-set) or streams units through the port's own
streaming layer, names the maps the check compares, and runs the plain
reference that the configuration names (``reference``, a path from the
checkout's root) on a unit. Only the port's public entry points are called.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

import numpy as np

from benchmark import parts

# post-filters the references do not implement: a configuration that turns
# one on is refused rather than checked against the wrong answer
_UNCHECKED_SGM = {"median_filter": False, "speckle_window": 0, "fill_holes": False}


class Pipeline:
    """What every kind provides; ``torch`` and ``device`` are the run's,
    ``ref`` the configuration's reference module."""

    fetch: Tuple[str, ...] = ()  # maps a closed-loop client copies back to the host

    def __init__(self, torch, device, config: Dict):
        self.torch = torch
        self.device = torch.device(device)
        self.config = config
        self.engine = config["engine"]
        for key, off in _UNCHECKED_SGM.items():
            if self.engine.get("sgm", {}).get(key, off) != off:
                raise ValueError(f"the reference does not check sgm.{key}")
        self.ref = parts.load_module(parts.ROOT / config["reference"])

    def load(self) -> None:
        """Import the port and load its kernels (built at the first run)."""
        from stereovisionarray_tpu_torch.config import EngineConfig

        self.cfg = EngineConfig.from_dict(self.engine)
        if self.device.type == "cuda":
            from stereovisionarray_tpu_torch import _native

            _native.library()

    def synchronize(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.current_stream(self.device).synchronize()

    def to_device(self, frame):
        from stereovisionarray_tpu_torch.parallel.streaming import to_device

        return to_device(frame, self.device)

    def maps(self, out) -> Dict:
        raise NotImplementedError

    def make_pool(self, seed: int, n: int) -> List[np.ndarray]:
        raise NotImplementedError

    def call(self, frame_dev):
        raise NotImplementedError

    def stream(self, frames: Iterable[np.ndarray], depth: int) -> Iterator[Tuple[object, object]]:
        """(output, event recorded after its work or None) per frame."""
        raise NotImplementedError

    def reference(self, frame: np.ndarray, control: bool = False) -> Dict:
        raise NotImplementedError


def make(torch, device, config: Dict, base: Path = parts.HERE) -> Pipeline:
    """The kind the configuration names, from ``<base>/pipelines/<kind>.py``."""
    return parts.find(base, "pipelines", config["pipeline"], "Kind")(torch, device, config)


def mismatches(torch, got: Dict, want: Dict, names: Optional[Iterable[str]] = None) -> Dict:
    """Pixels whose value differs between two sets of maps, per map (NaN
    equal to NaN); `got` maps may be on another device."""
    out = {}
    for k in names or want:
        a, b = got[k].to(want[k].device), want[k]
        if a.shape != b.shape or a.dtype != b.dtype:
            out[k] = int(b.numel())
            continue
        same = (a == b) | (torch.isnan(a) & torch.isnan(b)) if a.is_floating_point() else a == b
        out[k] = int((~same).sum().item())
    return out

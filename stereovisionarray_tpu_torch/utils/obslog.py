"""Structured metrics logging (twin of ``stereovisionarray_tpu/utils/obslog.py``,
a standard-library copy: the lines are the same JSON, so either package's
:func:`read_metrics` reads the other's file).

Metrics are JSON-lines events, machine-readable and append-only, each with a
wall-clock stamp; image artifacts go to PNG through ``datasets.save_png``.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Any, Dict, Optional

__all__ = ["MetricsLogger", "read_metrics"]


class MetricsLogger:
    """Append-only JSONL metrics log with wall-clock stamps. A value with
    ``__float__`` (a 0-dim tensor, a numpy scalar) is written as a float.

    >>> log = MetricsLogger("run/metrics.jsonl")  # doctest: +SKIP
    >>> log.log("two_view", bad2=0.021, mps=3.4)  # doctest: +SKIP
    """

    def __init__(self, path: Optional[str] = None, echo: bool = False) -> None:
        self.path = path
        self.echo = echo
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def log(self, event: str, **metrics: Any) -> Dict[str, Any]:
        record = {"ts": time.time(), "event": event}
        for k, v in metrics.items():
            record[k] = float(v) if hasattr(v, "__float__") else v
        line = json.dumps(record, sort_keys=True)
        if self.path:
            with open(self.path, "a") as f:
                f.write(line + "\n")
        if self.echo:
            print(line, file=sys.stderr)
        return record


def read_metrics(path: str):
    """Load a JSONL metrics file back as a list of dicts."""
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]

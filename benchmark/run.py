"""Run one cell of the benchmark once, from the root of a checkout:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (``correct``, ``attempted``,
``failed``, ``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and
``checks`` last). It exits 2, printing no result, without the CUDA devices
the cell needs, and 3 if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path


def process_age() -> float:
    """Seconds since this process started (0 where /proc cannot say)."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


def cache_env(root: Path) -> None:
    """Every build and kernel cache at a fixed path inside the checkout, and
    one host thread for the library's CPU work."""
    cache = root / "benchmark" / ".cache"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                     ("PYTORCH_KERNEL_CACHE_PATH", "torch_kernels"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    os.environ["OMP_NUM_THREADS"] = "1"


if __name__ == "__main__":
    t_origin = time.perf_counter() - process_age()
    root = Path(__file__).resolve().parents[1]
    cache_env(root)
    from benchmark import harness

    sys.exit(harness.main(t_origin=t_origin))

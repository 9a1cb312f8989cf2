"""95th percentile of every pair's latency in the window, handover to maps
on the host, ms (host clock)."""

import numpy as np


def read(run):
    if run.latencies is None or not len(run.latencies):
        return None
    return 1e3 * float(np.percentile(run.latencies, 95))

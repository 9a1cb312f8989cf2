"""Device ms a frame-set of the kernels that are not the port's own
(csrc/*.cu): the plain PyTorch refinement and glue."""

import numpy as np

from benchmark.readers import per_unit_ms


def read(run):
    t = run.trace
    if not run.port_kernels or not len(t.dev_start):
        return None
    ours = t.kernel_mask(*run.port_kernels)
    plain = t.kernel_mask() & ~ours
    return per_unit_ms(run, t.device_s(plain)) if np.any(plain) else None

"""Device kernels a frame-set in the traced window (copies and fills not
counted)."""


def read(run):
    n = int(run.trace.kernel_mask().sum())
    return n / run.units if n and run.units else None

"""Device ms a frame-set of the fused refinement's kernels (csrc/refine.cu,
named refine_*); None where the program has none."""

from benchmark.readers import kernel_ms


def read(run):
    return kernel_ms(run, "refine_")

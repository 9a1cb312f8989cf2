"""Disparity accuracy metrics."""

from stereovisionarray_tpu_torch.evaluation.metrics import (  # noqa: F401
    bad_pixel_ratio,
    end_point_error,
)

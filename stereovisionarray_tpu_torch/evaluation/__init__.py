"""Disparity and camera-array depth accuracy metrics."""

from stereovisionarray_tpu_torch.evaluation.metrics import (  # noqa: F401
    array_depth_metrics,
    bad_pixel_ratio,
    end_point_error,
)

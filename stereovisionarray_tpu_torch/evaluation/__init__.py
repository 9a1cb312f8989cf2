"""Disparity and camera-array depth accuracy metrics."""

from stereovisionarray_tpu_torch.evaluation.metrics import (  # noqa: F401
    array_depth_metrics,
    bad_pixel_ratio,
    cascade_depth_metrics,
    cascade_disparity_metrics,
    end_point_error,
)

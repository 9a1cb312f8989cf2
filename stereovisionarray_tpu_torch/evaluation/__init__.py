"""Disparity, camera-array depth and calibration accuracy metrics."""

from stereovisionarray_tpu_torch.evaluation.metrics import (  # noqa: F401
    absolute_trajectory_error,
    array_depth_metrics,
    bad_pixel_ratio,
    cascade_depth_metrics,
    cascade_disparity_metrics,
    end_point_error,
)

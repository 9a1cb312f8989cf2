"""Pipelines built from ``ops`` (the two-view SGM slice so far)."""

from stereovisionarray_tpu_torch.models.two_view import (  # noqa: F401
    TwoViewOutput,
    depth_to_disparity,
    disparity_to_depth,
    scaled_penalties,
    two_view_disparity,
)

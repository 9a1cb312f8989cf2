"""Pipelines built from ``ops``: two-view SGM, the array plane sweep, the
camera-array depth pipeline, the coarse-to-fine cascades of both, the
temporal filter, multi-view fusion and the streaming serve loop."""

from stereovisionarray_tpu_torch.models.array_pipeline import (  # noqa: F401
    ArrayPipelineOutput,
    array_baselines,
    array_depth_pipeline,
    reference_and_sources,
)
from stereovisionarray_tpu_torch.models.cascade import (  # noqa: F401
    SMOOTH_R,
    CascadeOutput,
    cascade_two_view_disparity,
)
from stereovisionarray_tpu_torch.models.cascade_sweep import (  # noqa: F401
    cascade_plane_sweep_depth,
    cascade_static_params,
)
from stereovisionarray_tpu_torch.models.plane_sweep import (  # noqa: F401
    PlaneSweepOutput,
    plane_sweep_depth,
    plane_sweep_volume,
    translation_shifts,
)
from stereovisionarray_tpu_torch.models.two_view import (  # noqa: F401
    TwoViewOutput,
    depth_to_disparity,
    disparity_to_depth,
    scaled_penalties,
    two_view_disparity,
)
from stereovisionarray_tpu_torch.models.fusion import (  # noqa: F401
    FusionResult,
    depth_normals,
    fuse_depth_maps,
    fused_point_cloud,
    reconstruct_array,
)
from stereovisionarray_tpu_torch.models.serving import (  # noqa: F401
    FrameResult,
    TemporalFrameResult,
    TemporalParams,
    frame_sets_from_dirs,
    stream_depth_maps,
    stream_depth_maps_chunked,
    stream_temporal,
)
from stereovisionarray_tpu_torch.models.temporal import (  # noqa: F401
    TemporalOutput,
    TemporalState,
    temporal_filter_sequence,
    temporal_init,
    temporal_update,
)

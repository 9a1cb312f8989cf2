"""Camera model, Lie maps, pair topologies and groups, plane-depth
hypotheses and epipolar candidates, rectification, lens distortion,
point-cloud converters and the host-side cloud passes of the camera array."""

from stereovisionarray_tpu_torch.geometry.camera import (  # noqa: F401
    CameraArray,
    camera_array_from_numpy,
    look_at_rotation,
    make_camera_array,
    translation_only_array,
)
from stereovisionarray_tpu_torch.geometry.lie import (  # noqa: F401
    se3_exp,
    se3_log,
    so3_exp,
    so3_log,
)
from stereovisionarray_tpu_torch.geometry.epipolar import (  # noqa: F401
    epipolar_candidates,
    inverse_depth_samples,
    rectified_shift_candidates,
)
from stereovisionarray_tpu_torch.geometry.topology import (  # noqa: F401
    PairTopology,
    camera_pairs,
    cross_pairs_around,
    grid_positions,
    pair_groups,
)
from stereovisionarray_tpu_torch.geometry.pointcloud import (  # noqa: F401
    depth_map_to_points,
    point_cloud_colors,
    points_to_depth_map,
)
from stereovisionarray_tpu_torch.geometry.cloudops import (  # noqa: F401
    remove_outliers,
    voxel_downsample,
)
from stereovisionarray_tpu_torch.geometry.rectify import (  # noqa: F401
    RectifiedPair,
    rectified_disparity_to_depth,
    rectify_images,
    rectify_pair,
)
from stereovisionarray_tpu_torch.geometry.distortion import (  # noqa: F401
    Distortion,
    distort_image,
    distort_points,
    undistort_image,
    undistort_points,
)

"""Camera model, pair topologies, plane-depth hypotheses, point-cloud
converters and the host-side cloud passes of the camera array."""

from stereovisionarray_tpu_torch.geometry.camera import (  # noqa: F401
    CameraArray,
    camera_array_from_numpy,
    make_camera_array,
    translation_only_array,
)
from stereovisionarray_tpu_torch.geometry.epipolar import inverse_depth_samples  # noqa: F401
from stereovisionarray_tpu_torch.geometry.topology import (  # noqa: F401
    PairTopology,
    camera_pairs,
    cross_pairs_around,
    grid_positions,
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

"""Camera model, pair topologies and plane-depth hypotheses of the camera array."""

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

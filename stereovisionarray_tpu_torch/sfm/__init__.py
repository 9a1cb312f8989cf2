"""Structure from motion (twin of ``stereovisionarray_tpu/sfm``): Harris
features and patch descriptors, mutual-ratio matching, Lucas-Kanade
refinement, midpoint triangulation, Schur-complement bundle adjustment with
matrix-free CG, and pose-graph refinement. Every shape is fixed (feature
counts padded to their maxima with validity masks) and no step reads the
card on the host, so a calibration is enqueued without waiting for it."""

from stereovisionarray_tpu_torch.sfm.features import (  # noqa: F401
    Features,
    describe_patches,
    detect_features,
    extract_features,
)
from stereovisionarray_tpu_torch.sfm.matching import Matches, match_descriptors  # noqa: F401
from stereovisionarray_tpu_torch.sfm.triangulate import (  # noqa: F401
    reprojection_errors,
    triangulate_midpoint,
)
from stereovisionarray_tpu_torch.sfm.ba import (  # noqa: F401
    BAProblem,
    BAState,
    bundle_adjust,
)
from stereovisionarray_tpu_torch.sfm.refine import lk_refine  # noqa: F401
from stereovisionarray_tpu_torch.sfm.pose_graph import (  # noqa: F401
    PoseGraph,
    pose_graph_optimize,
)

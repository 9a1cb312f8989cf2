"""Plain PyTorch ops (census, cost volumes, SGM, WTA, confidence, warps,
refinement, post-filters). The CUDA kernel wrappers (``ops/*_cuda.py``,
``ops/hatsample.py``) are imported by the pipelines that launch them (the
refinement imports its own when it takes the kernels' route), never here,
so importing this package builds nothing."""

from stereovisionarray_tpu_torch.ops.census import (  # noqa: F401
    census_transform,
    hamming_distance,
)
from stereovisionarray_tpu_torch.ops.cost_volume import (  # noqa: F401
    birchfield_tomasi_volume,
    census_cost_volume,
    fused_cost_volume,
    right_from_left_volume,
)
from stereovisionarray_tpu_torch.ops.sgm import (  # noqa: F401
    sgm_aggregate,
    sgm_aggregate_reference,
)
from stereovisionarray_tpu_torch.ops.confidence import (  # noqa: F401
    confidence_from_volume,
    pkrn_confidence,
    second_best_cost,
)
from stereovisionarray_tpu_torch.ops.wta import (  # noqa: F401
    disparity_from_volume,
    left_right_check,
    subpixel_refine,
    winner_take_all,
)
from stereovisionarray_tpu_torch.ops.warp import (  # noqa: F401
    bilinear_sample,
    homography_warp,
    splat_depth,
    warp_with_disparity,
)
from stereovisionarray_tpu_torch.ops.refine import (  # noqa: F401
    RefineOutput,
    box_filter2d,
    multiview_refine,
)
from stereovisionarray_tpu_torch.ops.postfilter import (  # noqa: F401
    median3x3,
    speckle_filter,
)

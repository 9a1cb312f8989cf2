"""Numpy-only dataset readers, image and artifact I/O (the C++ codec or a
standard-library PNG decoder, no imageio), the Middlebury loader and the
synthetic camera-array renderer; no JAX."""

from stereovisionarray_tpu_torch.datasets.synthetic import (  # noqa: F401
    SceneSpec,
    render_camera_array,
    render_view,
    reference_rig,
)
from stereovisionarray_tpu_torch.datasets.middlebury import (  # noqa: F401
    MiddleburyPair,
    load_middlebury_pair,
    parse_calib,
    read_pfm,
    write_pfm,
)
from stereovisionarray_tpu_torch.datasets.io import (  # noqa: F401
    list_images_sorted,
    load_array,
    load_image_gray,
    load_image_stack,
    load_ply,
    native_available,
    read_png,
    save_array,
    save_png,
    save_ply,
    write_png,
)

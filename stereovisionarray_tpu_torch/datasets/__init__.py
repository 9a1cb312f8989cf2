"""Numpy-only dataset readers, image I/O (the C++ codec or a standard-library
PNG decoder, no imageio) and the synthetic camera-array renderer; no JAX."""

from stereovisionarray_tpu_torch.datasets.io import (  # noqa: F401
    list_images_sorted,
    load_image_gray,
    load_image_stack,
    native_available,
    read_png,
    save_png,
    write_png,
)

"""Region-of-interest (face) masks (twin of ``stereovisionarray_tpu/roi``):
the geometric masks of the reference's ``getFaceMask`` / ``getFaceCircle``
over landmarks from any detector, a landmark-free moment ellipse, and the NCC
face detector with its landmark fit. Plain PyTorch on the image's device; no
TPU kernel stands behind any of it."""

from stereovisionarray_tpu_torch.roi.detect import EllipseROI, detect_face_ellipse  # noqa: F401
from stereovisionarray_tpu_torch.roi.face import (  # noqa: F401
    FaceDetection,
    canonical_landmarks,
    detect_face,
    face_mask,
    fit_landmarks,
)
from stereovisionarray_tpu_torch.roi.mask import (  # noqa: F401
    convex_polygon_mask,
    ellipse_mask,
    face_ellipse_from_landmarks,
    face_mask_from_landmarks,
)

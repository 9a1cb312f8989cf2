"""Face detection by normalized cross-correlation with a procedural face
template, and landmark fitting (twin of ``stereovisionarray_tpu/roi/face.py``).

An image pyramid, one masked NCC correlation a level against a zero-mean
face template (eye, brow, mouth and nose blobs inside an oval), the best
peak as a face box and a canonical 68-point layout scaled into it; a second
stage checks part evidence (eyes, brows, mouth, nose) on a canonical
resampling of the box. :func:`fit_landmarks` updates the layout by a ridge
affine fit of the part matches and snaps the jaw to the strongest nearby
edge; :func:`face_mask` is the reference's ``fillConvexPoly`` recipe over the
fitted points, with the Otsu ellipse of ``roi.detect`` where no face is found.
No model weights.

Everything runs on the image's device, selections included (``torch.where``
on device scalars), so a call queues its work without waiting for the card.
The resampling follows ``jax.image.resize`` / ``scale_and_translate`` with the
linear method: per-axis triangle-kernel weight matrices (antialiased when
shrinking, zero outside the input) applied as two products in float64. The
correlations are ``F.conv2d``, with cuDNN's TF32 turned off around them.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from stereovisionarray_tpu_torch.backend import host_to_device

__all__ = [
    "FaceDetection",
    "canonical_landmarks",
    "detect_face",
    "face_mask",
    "fit_landmarks",
    "resample_linear",
]

_TH, _TW = 56, 44  # template size (rows, cols)


@functools.lru_cache(maxsize=1)
def _face_template() -> Tuple[np.ndarray, np.ndarray]:
    """((TH, TW) template, (TH, TW) support mask), both float32.

    The template's support is the face OVAL only — background pixels around
    the head get zero weight and are excluded from the patch statistics
    (masked NCC), so the detector is invariant to whether the surround is
    brighter or darker than the face (the failure mode of the Otsu
    foreground ellipse). Inside the oval: darker eye/brow/mouth blobs and a
    brighter nose ridge over uniform skin; soft (gaussian) features keep the
    response broad over ~±20% scale error between pyramid levels. The
    template is zero-mean and unit-norm OVER THE MASK."""
    h, w = _TH, _TW
    v, u = np.mgrid[0:h, 0:w].astype(np.float32)
    un, vn = u / (w - 1), v / (h - 1)  # normalized face-box coords

    def blob(cu, cv, su, sv):
        return np.exp(-0.5 * (((un - cu) / su) ** 2 + ((vn - cv) / sv) ** 2))

    oval = (((un - 0.5) / 0.46) ** 2 + ((vn - 0.52) / 0.50) ** 2 <= 1.0).astype(
        np.float32
    )
    t = np.full((h, w), 0.55, np.float32)  # skin
    t -= 0.30 * blob(0.30, 0.35, 0.11, 0.05)  # left eye
    t -= 0.30 * blob(0.70, 0.35, 0.11, 0.05)  # right eye
    t -= 0.18 * blob(0.26, 0.24, 0.13, 0.035)  # left brow
    t -= 0.18 * blob(0.74, 0.24, 0.13, 0.035)  # right brow
    t -= 0.25 * blob(0.50, 0.78, 0.16, 0.05)  # mouth
    t += 0.10 * blob(0.50, 0.48, 0.06, 0.16)  # nose ridge highlight
    t -= 0.10 * blob(0.38, 0.62, 0.05, 0.04)  # nostril shading
    t -= 0.10 * blob(0.62, 0.62, 0.05, 0.04)
    n = oval.sum()
    t = (t - (t * oval).sum() / n) * oval  # zero-mean over mask, 0 outside
    return (t / np.linalg.norm(t)).astype(np.float32), oval


@functools.lru_cache(maxsize=1)
def canonical_landmarks() -> np.ndarray:
    """(68, 2) dlib-layout landmarks in normalized face-box (u, v) coords.

    Only the subsets the reference consumes need geometric fidelity — the
    jaw contour 0-16 and brow points 19/24
    (``/root/reference/src/dlibFaceSelect.cpp:29-34``; ellipse variant uses
    0/8/16, ``:50-62``) — but all 68 are laid out plausibly."""
    pts = np.zeros((68, 2), np.float32)
    # jaw 0-16: ellipse from left ear through chin to right ear
    phi = np.linspace(-np.pi / 2, np.pi / 2, 17)
    pts[0:17, 0] = 0.5 + 0.5 * np.sin(phi)
    pts[0:17, 1] = 0.45 + 0.55 * np.cos(phi)
    # brows 17-21 (left), 22-26 (right)
    pts[17:22, 0] = np.linspace(0.13, 0.42, 5)
    pts[17:22, 1] = 0.24 - 0.04 * np.sin(np.linspace(0, np.pi, 5))
    pts[22:27, 0] = np.linspace(0.58, 0.87, 5)
    pts[22:27, 1] = 0.24 - 0.04 * np.sin(np.linspace(0, np.pi, 5))
    # nose bridge 27-30 + base 31-35
    pts[27:31, 0] = 0.5
    pts[27:31, 1] = np.linspace(0.32, 0.55, 4)
    pts[31:36, 0] = np.linspace(0.40, 0.60, 5)
    pts[31:36, 1] = 0.62
    # eyes 36-41 (left), 42-47 (right): hexagons
    ang = np.linspace(0, 2 * np.pi, 6, endpoint=False)
    pts[36:42, 0] = 0.30 + 0.09 * np.cos(ang)
    pts[36:42, 1] = 0.35 + 0.045 * np.sin(ang)
    pts[42:48, 0] = 0.70 + 0.09 * np.cos(ang)
    pts[42:48, 1] = 0.35 + 0.045 * np.sin(ang)
    # mouth: outer 48-59, inner 60-67
    ang = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    pts[48:60, 0] = 0.50 + 0.16 * np.cos(ang)
    pts[48:60, 1] = 0.78 + 0.06 * np.sin(ang)
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False)
    pts[60:68, 0] = 0.50 + 0.10 * np.cos(ang)
    pts[60:68, 1] = 0.78 + 0.035 * np.sin(ang)
    return pts



class FaceDetection(NamedTuple):
    box: torch.Tensor  # (4,) u0, v0, width, height in pixels
    landmarks: torch.Tensor  # (68, 2) pixel (u, v)
    score: torch.Tensor  # peak NCC in [-1, 1]
    found: torch.Tensor  # bool: score >= threshold


def _triangle_weights(in_size: int, out_size: int, scale, translation, device) -> torch.Tensor:
    """(in_size, out_size) linear-resampling weights of
    ``jax._src.image.scale.compute_weight_mat``: output pixel j samples input
    position ``(j + 0.5) / scale - translation / scale - 0.5`` with a triangle
    kernel widened by 1 / scale when shrinking, columns normalised, zero
    where the sample lies outside the input. `scale` and `translation` are
    Python floats or 0-dim float32 tensors."""
    f32 = torch.float32
    inv_scale = 1.0 / scale
    kernel_scale = (torch.clamp(inv_scale, min=1.0) if isinstance(inv_scale, torch.Tensor)
                    else max(inv_scale, 1.0))
    sample_f = ((torch.arange(out_size, dtype=f32, device=device) + 0.5) * inv_scale
                - translation * inv_scale - 0.5)
    x = (sample_f[None, :] - torch.arange(in_size, dtype=f32, device=device)[:, None]).abs()
    weights = torch.clamp(1.0 - (x / kernel_scale).abs(), min=0.0)
    total = weights.sum(dim=0, keepdim=True)
    weights = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                          weights / torch.where(total != 0, total, 1.0), 0.0)
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return torch.where(inside[None, :], weights, 0.0)


def resample_linear(img: torch.Tensor, shape: Tuple[int, int], scale=None,
                    translation=(0.0, 0.0)) -> torch.Tensor:
    """(h, w) float32 image resampled to `shape` as
    ``jax.image.scale_and_translate(img, shape, (0, 1), scale, translation,
    "linear")``; with `scale` None, as ``jax.image.resize(img, shape,
    "linear")`` (scale = out / in per axis, no translation). Scale and
    translation may be device scalars (a box found on the card)."""
    (h, w), (ho, wo) = img.shape, shape
    if scale is None:
        scale = (ho / h, wo / w)
    wy = _triangle_weights(h, ho, scale[0], translation[0], img.device)
    wx = _triangle_weights(w, wo, scale[1], translation[1], img.device)
    f64 = torch.float64
    return (wy.to(f64).T @ img.to(f64) @ wx.to(f64)).to(torch.float32)


def _conv_valid(img: torch.Tensor, kern: torch.Tensor) -> torch.Tensor:
    """VALID 2-D cross-correlation of one feature. cuDNN would run a float32
    convolution in TF32 by default, which moves the scores by about 1e-3."""
    with torch.backends.cudnn.flags(enabled=True, deterministic=True, allow_tf32=False):
        return F.conv2d(img[None, None], kern[None, None])[0, 0]


def _masked_ncc(img: torch.Tensor, t: torch.Tensor, m: torch.Tensor, n: float) -> torch.Tensor:
    """Masked NCC of a centred image against template t over its support m
    (n pixels): the patch variance floored at 1 intensity unit a pixel."""
    s1 = _conv_valid(img, m)
    s2 = _conv_valid(img * img, m)
    cross = _conv_valid(img, t)  # t is zero-mean over m: the patch mean cancels
    var = torch.clamp(s2 - s1 * s1 / n, min=n)
    return torch.clamp(cross / torch.sqrt(var), -1.0, 1.0)  # ||t|| == 1


def _peak(ncc: torch.Tensor):
    """(score, row, column) of the first maximum, as device scalars (indexing
    with a 0-dim device tensor would read it on the host)."""
    flat = torch.argmax(ncc).reshape(1)
    return ncc.reshape(-1).index_select(0, flat)[0], flat[0] // ncc.shape[1], flat[0] % ncc.shape[1]


def _ncc_peak(img: torch.Tensor):
    """Peak masked-NCC score and its (v, u) template top-left position on
    one pyramid level. The level is centred first: on raw [0, 255] data the
    E[x^2] - E[x]^2 form cancels catastrophically in float32."""
    t_np, m_np = _face_template()
    t, m = host_to_device(t_np, img.device), host_to_device(m_np, img.device)
    img = img - img.mean()
    score, v, u = _peak(_masked_ncc(img, t, m, float(m_np.sum())))
    return score, v, u


def detect_face(image: torch.Tensor, num_scales: int = 6, scale_step: float = 0.8,
                threshold: float = 0.30, verify_parts: bool = True,
                min_part_score: float = 0.55) -> FaceDetection:
    """Multi-scale NCC face detection on an (H, W) grayscale image. The
    pyramid shrinks the image by `scale_step` a level (the template stays),
    so detectable face widths span about [44, 44 / scale_step**(num_scales-1)]
    pixels. The best level is chosen on the device."""
    img = image.to(torch.float32)
    h, w = img.shape
    full = functools.partial(torch.full, (), dtype=torch.float32, device=img.device)
    best_score, best_u0, best_v0 = full(-2.0), full(0.0), full(0.0)
    best_bw, best_bh = full(float(_TW)), full(float(_TH))
    for k in range(num_scales):
        s = scale_step ** k
        hs, ws = int(round(h * s)), int(round(w * s))
        if hs < _TH or ws < _TW:
            break
        lvl = img if k == 0 else resample_linear(img, (hs, ws))
        score, v, u = _ncc_peak(lvl)
        take = score > best_score
        best_score = torch.where(take, score, best_score)
        best_u0 = torch.where(take, u.to(torch.float32) / s, best_u0)
        best_v0 = torch.where(take, v.to(torch.float32) / s, best_v0)
        best_bw = torch.where(take, full(_TW / s), best_bw)
        best_bh = torch.where(take, full(_TH / s), best_bh)
    box = torch.stack([best_u0, best_v0, best_bw, best_bh])
    lm = host_to_device(canonical_landmarks(), img.device)
    landmarks = torch.stack([best_u0 + lm[:, 0] * best_bw, best_v0 + lm[:, 1] * best_bh], dim=-1)
    found = best_score >= threshold
    if verify_parts:
        # a face must carry eye / brow / mouth evidence: the whole-face
        # template also peaks on featureless face-shaped content
        _, part_score = _fit_canonical(_canonical_patch(img, box))
        found = found & (part_score >= min_part_score)
    return FaceDetection(box=box, landmarks=landmarks, score=best_score, found=found)


# canonical patch: the detected BOX occupies the central (2*_TH, 2*_TW)
# region; a _MARGIN-box border on every side keeps the face's outer edge
# (chin/ears often sit just outside the NCC box) inside the patch for the
# jaw snap. 0.25 * 2 = 0.5 extra box -> patch = 1.5x the box.
_MARGIN = 0.25
_CH, _CW = 3 * _TH, 3 * _TW  # 1.5 * (2*_TH, 2*_TW)
_BY, _BX = (_CH - 2 * _TH) // 2, (_CW - 2 * _TW) // 2  # box top-left in patch

# parts: (center u, center v, half-width u, half-height v) in normalized
# face-box coordinates; crops are taken from the 2x-upscaled template
_PARTS = (
    ("eye_l", 0.30, 0.35, 0.16, 0.10),
    ("eye_r", 0.70, 0.35, 0.16, 0.10),
    ("brow_l", 0.26, 0.24, 0.17, 0.07),
    ("brow_r", 0.74, 0.24, 0.17, 0.07),
    ("mouth", 0.50, 0.78, 0.20, 0.09),
    ("nose", 0.50, 0.55, 0.13, 0.12),
)
_SEARCH = 8  # canonical-pixel search radius around each part


@functools.lru_cache(maxsize=1)
def _part_bank():
    """Static part crops of the 2x canonical template: list of
    (template (ph, pw) zero-mean unit-norm, mask, (cu, cv) canonical-pixel
    center, (y0, x0, ph, pw) crop box)."""
    t, m = _face_template()
    # nearest-exact 2x upsample keeps the analytic blobs smooth enough
    t2 = np.kron(t, np.ones((2, 2), np.float32))
    m2 = np.kron(m, np.ones((2, 2), np.float32))
    bank = []
    BH2, BW2 = 2 * _TH, 2 * _TW  # box size inside the patch
    for name, cu, cv, hu, hv in _PARTS:
        # crop in 2x-template coords, then offset into patch coords
        x0 = int(round((cu - hu) * (BW2 - 1)))
        x1 = int(round((cu + hu) * (BW2 - 1))) + 1
        y0 = int(round((cv - hv) * (BH2 - 1)))
        y1 = int(round((cv + hv) * (BH2 - 1))) + 1
        pt = t2[y0:y1, x0:x1].copy()
        pm = m2[y0:y1, x0:x1].copy()
        n = max(pm.sum(), 1.0)
        pt = (pt - (pt * pm).sum() / n) * pm
        nrm = np.linalg.norm(pt)
        pt = pt / max(nrm, 1e-6)
        y0p, x0p = y0 + _BY, x0 + _BX  # patch coords
        # the search window [y0-S, y1+S) x [x0-S, x1+S) must fit the
        # canonical patch — static geometry, assert once here
        assert y0p >= _SEARCH and x0p >= _SEARCH, (name, y0p, x0p)
        assert y1 + _BY + _SEARCH <= _CH and x1 + _BX + _SEARCH <= _CW
        bank.append((pt.astype(np.float32), pm.astype(np.float32),
                     (cu * (BW2 - 1) + _BX, cv * (BH2 - 1) + _BY),
                     (y0p, x0p)))
    return bank


def _bilinear_points(img: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of img at float points (u, v)."""
    h, w = img.shape
    u = torch.clamp(u, 0.0, w - 1.001)
    v = torch.clamp(v, 0.0, h - 1.001)
    x0, y0 = torch.floor(u).to(torch.int64), torch.floor(v).to(torch.int64)
    fu, fv = u - x0, v - y0
    p00, p01 = img[y0, x0], img[y0, x0 + 1]
    p10, p11 = img[y0 + 1, x0], img[y0 + 1, x0 + 1]
    return (p00 * (1 - fu) + p01 * fu) * (1 - fv) + (p10 * (1 - fu) + p11 * fu) * fv


def _canonical_patch(img: torch.Tensor, box: torch.Tensor) -> torch.Tensor:
    """The detected box resampled into the fixed canonical patch: the box
    fills the central (2*_TH, 2*_TW) region at offset (_BY, _BX), with a
    _MARGIN-box border all round for the jaw snap."""
    u0, v0, bw, bh = box[0], box[1], box[2], box[3]
    sy, sx = (2 * _TH) / bh, (2 * _TW) / bw
    ty, tx = _BY - v0 * sy, _BX - u0 * sx  # patch row / column of image row / column 0
    return resample_linear(img, (_CH, _CW), scale=(sy, sx),
                           translation=(ty + 0.5 - 0.5 * sy, tx + 0.5 - 0.5 * sx))


def _affine(points: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """(K, 2) points through the (2, 3) affine A."""
    return points[:, 0:1] * A[:, 0] + points[:, 1:2] * A[:, 1] + A[:, 2]


def _solve3(G: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """G^-1 B for a (3, 3) G, by the adjugate in float64 (no solver call, so
    no host read of a pivot or status)."""
    G, B = G.to(torch.float64), B.to(torch.float64)
    cof = torch.stack([torch.linalg.cross(G[(i + 1) % 3], G[(i + 2) % 3]) for i in range(3)])
    det = (G[0] * cof[0]).sum()
    return (cof.T @ B / det).to(torch.float32)


def _fit_canonical(patch: torch.Tensor):
    """An affine layout update on the canonical patch: (A (2, 3) in
    canonical coordinates, mean part NCC)."""
    patch = patch - patch.mean()
    src, dst, scores = [], [], []
    for pt_np, pm_np, (cu, cv), (y0, x0) in _part_bank():
        ph, pw = pt_np.shape
        win = patch[y0 - _SEARCH: y0 + ph + _SEARCH, x0 - _SEARCH: x0 + pw + _SEARCH]
        t, m = host_to_device(pt_np, patch.device), host_to_device(pm_np, patch.device)
        score, dv, du = _peak(_masked_ncc(win, t, m, float(pm_np.sum())))
        src.append((cu, cv))
        dst.append(torch.stack([cu + (du.to(torch.float32) - _SEARCH),
                                cv + (dv.to(torch.float32) - _SEARCH)]))
        scores.append(score)
    src = host_to_device(np.asarray(src, np.float32), patch.device)  # (K, 2)
    dst = torch.stack(dst)
    score = torch.stack(scores).mean()
    # ridge-regularised affine least squares, biased toward the identity so
    # one bad part match cannot fling the layout
    X = torch.cat([src, torch.ones_like(src[:, :1])], dim=1)  # (K, 3)
    lam = 4.0  # canonical px^2 of ridge
    A0 = torch.eye(2, 3, dtype=torch.float32, device=patch.device)
    G = X.T @ X + lam * torch.eye(3, dtype=torch.float32, device=patch.device)
    B = X.T @ dst + lam * A0.T  # (3, 2)
    return _solve3(G, B).T, score


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy's median: the mean of the two middle values of an even count."""
    s = x.reshape(-1).sort().values
    n = s.numel()
    return 0.5 * (s[(n - 1) // 2] + s[n // 2])


def fit_landmarks(image: torch.Tensor, det: FaceDetection, jaw_search: float = 0.12,
                  min_part_score: float = 0.25) -> torch.Tensor:
    """(68, 2) landmarks fitted to the image: part-template NCC, an affine
    layout update, a jaw edge snap, all on the canonical resampling of the
    detected box. Where the evidence is weak the canonical layout stays: the
    affine is ridge-biased to identity, the jaw moves only to an edge above
    the patch's median gradient, and a mean part NCC below `min_part_score`
    keeps ``det.landmarks``."""
    img = image.to(torch.float32)
    dev = img.device
    u0, v0, bw, bh = det.box[0], det.box[1], det.box[2], det.box[3]
    sy, sx = (2 * _TH) / bh, (2 * _TW) / bw  # canonical px per image px
    patch = _canonical_patch(img, det.box)
    A, part_score = _fit_canonical(patch)

    lm = host_to_device(canonical_landmarks(), dev)  # (68, 2) normalised box coords
    lm_c = torch.stack([lm[:, 0] * (2 * _TW - 1) + _BX, lm[:, 1] * (2 * _TH - 1) + _BY], dim=-1)
    fit_c = _affine(lm_c, A)

    # jaw snap: each jaw point moves along its outward normal (from the
    # updated face centre) to the strongest nearby gradient, distance
    # weighted, then the radial offsets are smoothed along the contour
    gy, gx = torch.gradient(patch)
    grad = torch.sqrt(gx * gx + gy * gy)
    centre = _affine(host_to_device(np.array([[0.5 * (2 * _TW - 1) + _BX,
                                               0.52 * (2 * _TH - 1) + _BY]], np.float32), dev), A)
    jaw = fit_c[:17]
    nrm = jaw - centre
    nrm = nrm / torch.clamp(torch.linalg.vector_norm(nrm, dim=-1, keepdim=True), min=1e-6)
    half = jaw_search * (2 * _TH)
    n_steps = 11
    steps = torch.linspace(-half, half, n_steps, dtype=torch.float32, device=dev)
    cand = jaw[:, None, :] + nrm[:, None, :] * steps[None, :, None]
    g = _bilinear_points(grad, cand[..., 0].reshape(-1),
                         cand[..., 1].reshape(-1)).reshape(17, n_steps)
    wgt = 1.0 / (1.0 + (steps / half) ** 2)  # mild near-preference
    k = torch.argmax(g * wgt[None], dim=1)
    t = steps[k]  # signed radial offset (17,)
    # no-evidence gate: an edge below the patch's median gradient is texture
    gbest = g.gather(1, k[:, None])[:, 0]
    t = torch.where(gbest > _median(grad), t, 0.0)
    for _ in range(2):  # 1-2-1 contour smoothing, edge-replicated
        tp = torch.cat([t[:1], t, t[-1:]])
        t = 0.25 * tp[:-2] + 0.5 * tp[1:-1] + 0.25 * tp[2:]
    fit_c = torch.cat([jaw + nrm * t[:, None], fit_c[17:]], dim=0)

    fit_img = torch.stack([u0 + (fit_c[:, 0] - _BX) / sx, v0 + (fit_c[:, 1] - _BY) / sy], dim=-1)
    ok = det.found & (part_score >= min_part_score)
    return torch.where(ok, fit_img, det.landmarks)


def face_mask(image: torch.Tensor, threshold: float = 0.30) -> torch.Tensor:
    """(H, W) bool compute-gating mask: NCC face detection and the
    reference's fillConvexPoly recipe over the fitted landmarks; where no
    face clears the threshold, the Otsu foreground ellipse (ungated, all
    True, where that finds nothing either). Both masks are computed and one
    is selected on the device."""
    from stereovisionarray_tpu_torch.roi.detect import detect_face_ellipse
    from stereovisionarray_tpu_torch.roi.mask import ellipse_mask, face_mask_from_landmarks

    det = detect_face(image, threshold=threshold)
    lm_mask = face_mask_from_landmarks(tuple(image.shape), fit_landmarks(image, det))
    roi = detect_face_ellipse(image.to(torch.float32))
    ell = ellipse_mask(tuple(image.shape), roi.center, roi.axes, roi.angle) | ~roi.found
    return torch.where(det.found, lm_mask, ell)

"""Bundle adjustment: Levenberg-Marquardt with the Schur complement, solved
matrix-free by preconditioned conjugate gradients (twin of
``stereovisionarray_tpu/sfm/ba.py``).

 - The sparse normal equations are never formed: the 2x6 / 2x3 Jacobian
   blocks of every observation are contracted on the fly, and the camera and
   point blocks summed per segment (:class:`~.segments.Segments`: a fixed
   order, no atomics, so two runs agree bit for bit).
 - The reduced camera system S dc = b is solved by CG; each product
   S x = (U + lam) x - W V^-1 W^T x is two segment sums and a batched 3x3
   product.
 - Fixed iteration counts everywhere (LM steps, CG iterations) and accept /
   reject as a ``torch.where`` on the state: no host read, no branch on a
   tensor, so the whole solve is enqueued without waiting for the card.
 - The small products are elementwise sums (never a TF32 GEMM), the
   inverses ``inv_ex`` (no error check that reads the card).

Robustness: IRLS with huber / cauchy / tukey kernels (tukey's cut scales
with the MAD of the current residuals); the LM damping adapts x0.3 on accept
and x5 on reject, so a diverging or NaN step is discarded. Gauge: camera 0
is frozen, and the global scale is fixed by keeping the camera-0 -> camera-1
baseline at its initial length after every update.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from stereovisionarray_tpu_torch.backend import host_to_device
from stereovisionarray_tpu_torch.geometry.camera import CameraArray
from stereovisionarray_tpu_torch.geometry.lie import _hat, matmul3, matvec3, so3_exp
from stereovisionarray_tpu_torch.sfm.segments import Segments, host_indices

__all__ = ["BAProblem", "BAState", "bundle_adjust"]


class BAProblem(NamedTuple):
    """Fixed-shape observation list (pad with valid=False)."""

    cam_idx: object  # (M,) host ints (numpy or a CPU tensor)
    pt_idx: object  # (M,) host ints
    uv: torch.Tensor  # (M, 2) float32 principal-point-centred measurements
    valid: torch.Tensor  # (M,) bool


class BAState(NamedTuple):
    cameras: CameraArray
    points: torch.Tensor  # (P, 3)
    cost: torch.Tensor  # (iterations + 1,) robust mean cost per iteration


def _mm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Batched (..., n, k) @ (..., k, m) as k elementwise products summed in
    index order (tiny blocks: no GEMM, no TF32)."""
    out = a[..., :, 0, None] * b[..., None, 0, :]
    for j in range(1, a.shape[-1]):
        out = out + a[..., :, j, None] * b[..., None, j, :]
    return out


def _mv(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched (..., n, k) @ (..., k)."""
    return _mm(a, x[..., :, None])[..., 0]


def _robust_weight(norm, c, kernel: str):
    """IRLS weight rho'(r)/r at scale c."""
    if kernel == "huber":
        return torch.where(norm <= c, 1.0, c / norm.clamp_min(1e-9))
    if kernel == "cauchy":
        return 1.0 / (1.0 + (norm / c) ** 2)
    if kernel == "tukey":
        u = torch.clamp(norm / c, 0.0, 1.0)
        return (1.0 - u * u) ** 2
    raise ValueError(f"unknown robust kernel {kernel!r}")


def _robust_rho(norm, c, kernel: str):
    """Robust loss rho(||r||) at scale c (for the LM step's acceptance)."""
    if kernel == "huber":
        return torch.where(norm <= c, 0.5 * norm * norm, c * (norm - 0.5 * c))
    if kernel == "cauchy":
        return 0.5 * c * c * torch.log1p((norm / c) ** 2)
    if kernel == "tukey":
        u2 = torch.clamp((norm / c) ** 2, 0.0, 1.0)
        return (c * c / 6.0) * (1.0 - (1.0 - u2) ** 3)
    raise ValueError(f"unknown robust kernel {kernel!r}")


def _at(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim device index, without reading it on the host."""
    return x.index_select(0, i.reshape(1))[0]


def _masked_median(x: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Median over the valid entries (invalid ones sorted to the top, the
    median's position from the valid count)."""
    n = torch.sum(valid.to(torch.int64))
    xs = torch.sort(torch.where(valid, x, float("inf"))).values
    i = torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, x.shape[0] - 1)
    j = torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, x.shape[0] - 1)
    return 0.5 * (_at(xs, i) + _at(xs, j))


def _kernel_scale(norm, valid, scale: float, kernel: str):
    """Fixed for huber / cauchy; for tukey the MAD of the valid residuals,
    floored at ``scale``."""
    if kernel != "tukey":
        return torch.full((), scale, dtype=norm.dtype, device=norm.device)
    med = _masked_median(norm, valid)
    mad = _masked_median(torch.abs(norm - med), valid)
    c = 4.685 * 1.4826 * mad
    return torch.clamp(torch.where(torch.isfinite(c), c, scale), min=scale)


class _Obs:
    """A problem's indices on its device and its two segment layouts."""

    def __init__(self, problem: BAProblem, n_cams: int, n_pts: int, device):
        ci, pi = host_indices(problem.cam_idx), host_indices(problem.pt_idx)
        self.ci = host_to_device(ci, device)
        self.pi = host_to_device(pi, device)
        self.cams = Segments(ci, n_cams, device)
        self.pts = Segments(pi, n_pts, device)
        self.uv = problem.uv
        self.valid = problem.valid


def _forward(R, t, X, fx, fy, obs: _Obs):
    """Residuals r (M, 2), norms (M,), geometric validity (M,), x_cam, 1/z."""
    x_cam = matvec3(R[obs.ci], X[obs.pi]) + t[obs.ci]
    z = x_cam[..., 2]
    inv_z = 1.0 / torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = fx[obs.ci] * x_cam[..., 0] * inv_z
    v = fy[obs.ci] * x_cam[..., 1] * inv_z
    r = torch.stack([u, v], dim=-1) - obs.uv
    norm = torch.sqrt(torch.sum(r * r, dim=-1))
    geom_ok = obs.valid & (z > 1e-4)
    return r, norm, geom_ok, x_cam, inv_z


def _blocks(R, fx, fy, x_cam, inv_z, obs: _Obs):
    """Jacobian blocks Jc (M, 2, 6) and Jp (M, 2, 3) at the current state."""
    fxm, fym = fx[obs.ci], fy[obs.ci]
    zero = torch.zeros_like(inv_z)
    J_proj = torch.stack([
        torch.stack([fxm * inv_z, zero, -fxm * x_cam[..., 0] * inv_z * inv_z], -1),
        torch.stack([zero, fym * inv_z, -fym * x_cam[..., 1] * inv_z * inv_z], -1),
    ], dim=-2)
    # left perturbation: dx_cam/dw = -[x_cam]x, dx_cam/dv = I, dx_cam/dX = R
    J_cam = torch.cat([-_mm(J_proj, _hat(x_cam)), J_proj], dim=-1)
    return J_cam, _mm(J_proj, R[obs.ci])


def _lm_step(R, X, fx, fy, fwd, obs: _Obs, lam, c, kernel: str, cg_iters: int):
    """Solve the damped normal equations: (dc (Nc, 6), dp (P, 3))."""
    r, norm, geom_ok, x_cam, inv_z = fwd
    Jc, Jp = _blocks(R, fx, fy, x_cam, inv_z, obs)
    w = _robust_weight(norm, c, kernel) * geom_ok.to(r.dtype)
    wJc = Jc * w[:, None, None]
    wJp = Jp * w[:, None, None]
    JcT, wJcT = Jc.transpose(-1, -2), wJc.transpose(-1, -2)
    U = obs.cams.sum(_mm(JcT, wJc))
    V = obs.pts.sum(_mm(Jp.transpose(-1, -2), wJp))
    W_m = _mm(wJcT, Jp)  # (M, 6, 3)
    W_mT = W_m.transpose(-1, -2)
    b_c = -obs.cams.sum(_mv(wJcT, r))
    b_p = -obs.pts.sum(_mv(wJp.transpose(-1, -2), r))

    # LM damping: multiplicative on the diagonal (scale-invariant) + absolute
    eye6 = torch.eye(6, dtype=R.dtype, device=R.device)
    eye3 = torch.eye(3, dtype=R.dtype, device=R.device)
    U = U + lam * (U * eye6) + 1e-8 * eye6
    V = V + lam * (V * eye3) + 1e-8 * eye3
    V_inv = torch.linalg.inv_ex(V)[0]
    U_inv = torch.linalg.inv_ex(U)[0]
    fixed = (torch.arange(U.shape[0], device=R.device) == 0)[:, None]  # the gauge camera

    def mask_c(x):
        return torch.where(fixed, 0.0, x)

    b_red = mask_c(b_c - obs.cams.sum(_mv(W_m, _mv(V_inv, b_p)[obs.pi])))

    def schur_matvec(x):
        x = mask_c(x)
        y = obs.pts.sum(_mv(W_mT, x[obs.ci]))
        return mask_c(_mv(U, x) - obs.cams.sum(_mv(W_m, _mv(V_inv, y)[obs.pi])))

    def precond(x):
        return mask_c(_mv(U_inv, x))

    x = torch.zeros_like(b_red)
    rr = b_red
    z = p = precond(b_red)
    for _ in range(cg_iters):
        Ap = schur_matvec(p)
        rz = torch.sum(rr * z)
        denom = torch.sum(p * Ap)
        alpha = rz / torch.where(torch.abs(denom) < 1e-20, 1e-20, denom)
        x = x + alpha * p
        rr = rr - alpha * Ap
        z_new = precond(rr)
        beta = torch.sum(rr * z_new) / torch.where(torch.abs(rz) < 1e-20, 1e-20, rz)
        z, p = z_new, z_new + beta * p
    dp = _mv(V_inv, b_p - obs.pts.sum(_mv(W_mT, x[obs.ci])))
    return x, dp


def _apply_update(R, t, X, dc, dp, base_len, fix_scale: bool):
    dR = so3_exp(dc[:, :3])
    R_new = matmul3(dR, R)
    t_new = matvec3(dR, t) + dc[:, 3:]
    X_new = X + dp
    if fix_scale:
        C = -matvec3(R_new.transpose(-1, -2), t_new)
        d = C[1] - C[0]
        s = base_len / (torch.sqrt(torch.sum(d * d)) + 1e-12)
        C0 = C[0]
        X_new = C0 + s * (X_new - C0)
        t_new = -matvec3(R_new, C0 + s * (C - C0))
    return R_new, t_new, X_new


def _mean_rho(norm, geom_ok, valid, c, kernel: str):
    # behind-camera candidates carry the worst in-range loss (a bounded
    # kernel must not reward pushing points out of view)
    worst = _robust_rho(torch.full_like(norm[:1], 1e6), c, kernel)
    rho = torch.where(geom_ok, _robust_rho(norm, c, kernel), worst)
    wv = valid.to(norm.dtype)
    return torch.sum(rho * wv) / torch.clamp(torch.sum(wv), min=1.0)


def bundle_adjust(cameras: CameraArray, points: torch.Tensor, problem: BAProblem,
                  iterations: int = 20, damping: float = 1e-3, huber: float = 2.0,
                  cg_iters: int = 30, fix_scale: bool = True,
                  kernel: str = "huber") -> BAState:
    """Run ``iterations`` LM steps; returns the refined cameras and points.

    ``problem.uv`` holds principal-point-centred pixel measurements (u - cx,
    v - cy): the intrinsics are known and fixed, the extrinsics and the
    structure refined. ``damping`` is the initial LM lambda. The observation
    indices are host arrays (their segment layout is built once, on the
    host); everything else runs on the cameras' device. The sharded form of
    the reference (``axis_name``) is not ported."""
    if kernel not in ("huber", "cauchy", "tukey"):
        raise ValueError(f"unknown robust kernel {kernel!r}")
    n_cams, n_pts = len(cameras), points.shape[0]
    device = cameras.R.device
    obs = _Obs(problem, n_cams, n_pts, device)
    fx, fy = cameras.fx, cameras.fy
    R, t, X = cameras.R, cameras.t, points.to(cameras.R.dtype)
    C = -matvec3(R.transpose(-1, -2), t)
    d = C[1] - C[0]
    base_len = torch.sqrt(torch.sum(d * d)) + 1e-12
    lam = torch.full((), damping, dtype=R.dtype, device=device)
    costs = []
    for _ in range(iterations):
        fwd = _forward(R, t, X, fx, fy, obs)
        c = _kernel_scale(fwd[1], fwd[2], huber, kernel)
        cost_cur = _mean_rho(fwd[1], fwd[2], obs.valid, c, kernel)
        dc, dp = _lm_step(R, X, fx, fy, fwd, obs, lam, c, kernel, cg_iters)
        R_new, t_new, X_new = _apply_update(R, t, X, dc, dp, base_len, fix_scale)
        _, norm_n, ok_n, _, _ = _forward(R_new, t_new, X_new, fx, fy, obs)
        cost_new = _mean_rho(norm_n, ok_n, obs.valid, c, kernel)
        accept = torch.isfinite(cost_new) & (cost_new < cost_cur)
        R = torch.where(accept, R_new, R)
        t = torch.where(accept, t_new, t)
        X = torch.where(accept, X_new, X)
        lam = torch.where(accept, torch.clamp(lam * 0.3, min=1e-8), torch.clamp(lam * 5.0, max=1e4))
        costs.append(cost_cur)
    _, norm_f, ok_f, _, _ = _forward(R, t, X, fx, fy, obs)
    c_f = _kernel_scale(norm_f, ok_f, huber, kernel)
    costs.append(_mean_rho(norm_f, ok_f, obs.valid, c_f, kernel))
    cams_out = CameraArray(fx=cameras.fx, fy=cameras.fy, cx=cameras.cx, cy=cameras.cy, R=R, t=t)
    return BAState(cameras=cams_out, points=X, cost=torch.stack(costs))

"""Pose-graph optimization over relative-pose constraints (twin of
``stereovisionarray_tpu/sfm/pose_graph.py``).

Refines world-to-camera poses X_i to minimize
``sum_ij || log(Z_ij^-1 X_j X_i^-1) ||^2`` by Levenberg-Marquardt: the (E, 6)
residual of left-perturbed poses is differentiated forward
(``torch.func.jacfwd``; the Lie maps' guarded divisions keep it finite at
delta = 0), one dense (6N x 6N) solve per iteration (``solve_ex``, in full
float32), and a step is accepted only when it lowers the cost and stays
finite, as a ``torch.where``. Camera 0 is the gauge.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from stereovisionarray_tpu_torch.backend import float32_matmuls
from stereovisionarray_tpu_torch.geometry.lie import matmul3, matvec3, se3_log, so3_exp

__all__ = ["PoseGraph", "pose_graph_optimize"]


class PoseGraph(NamedTuple):
    """Edges i -> j with measured relative pose x_j = (R_ij, t_ij) o x_i."""

    edge_i: torch.Tensor  # (E,) int
    edge_j: torch.Tensor  # (E,) int
    R_meas: torch.Tensor  # (E, 3, 3)
    t_meas: torch.Tensor  # (E, 3)
    weight: torch.Tensor  # (E,) edge confidence (0 disables an edge)


def _edge_residuals(R, t, graph: PoseGraph) -> torch.Tensor:
    """(E, 6) se(3) residuals log(Z_ij^-1 T_j T_i^-1) of world-to-camera T."""
    Ri, ti = R[graph.edge_i], t[graph.edge_i]
    Rj, tj = R[graph.edge_j], t[graph.edge_j]
    R_rel = matmul3(Rj, Ri.transpose(-1, -2))
    t_rel = tj - matvec3(R_rel, ti)
    R_measT = graph.R_meas.transpose(-1, -2)
    return se3_log(matmul3(R_measT, R_rel), matvec3(R_measT, t_rel - graph.t_meas))


def pose_graph_optimize(R: torch.Tensor, t: torch.Tensor, graph: PoseGraph,
                        iterations: int = 10,
                        damping: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Refine poses (N, 3, 3), (N, 3) against the edge set. Returns (R, t,
    the mean residual norm before each iteration)."""
    n = R.shape[0]

    def residuals_at(R_c, t_c):
        return _edge_residuals(R_c, t_c, graph) * graph.weight[:, None]

    def mean_norm(res):
        return torch.mean(torch.sqrt(torch.sum(res * res, dim=-1)))

    def perturbed(delta, R_c, t_c):
        dR = so3_exp(delta[:, :3])
        return matmul3(dR, R_c), matvec3(dR, t_c) + delta[:, 3:]

    eye = torch.eye(n * 6, dtype=R.dtype, device=R.device)
    gauge = torch.arange(n * 6, device=R.device) < 6
    lam = torch.full((), damping, dtype=R.dtype, device=R.device)
    costs = []
    for _ in range(iterations):
        zero = torch.zeros((n, 6), dtype=R.dtype, device=R.device)
        res0 = residuals_at(R, t)
        cost0 = mean_norm(res0)
        J = torch.func.jacfwd(lambda d: residuals_at(*perturbed(d, R, t)))(zero)  # (E, 6, N, 6)
        Jf = J.reshape(-1, n * 6)
        rf = res0.reshape(-1)
        with float32_matmuls():
            JtJ = Jf.T @ Jf
            g = Jf.T @ rf
        # LM damping scaled to the Hessian diagonal (scale-invariant)
        H = JtJ + lam * torch.diag(torch.clamp(torch.diagonal(JtJ), min=1e-12)) + 1e-9 * eye
        # gauge: camera 0's block pinned to the identity
        H = torch.where(gauge[:, None] | gauge[None, :], 0.0, H) + torch.diag(gauge.to(R.dtype))
        g = torch.where(gauge, 0.0, g)
        delta = -torch.linalg.solve_ex(H, g[:, None])[0][:, 0].reshape(n, 6)
        R_try, t_try = perturbed(delta, R, t)
        cost_try = mean_norm(residuals_at(R_try, t_try))
        accept = torch.isfinite(cost_try) & (cost_try < cost0)
        R = torch.where(accept, R_try, R)
        t = torch.where(accept, t_try, t)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 10.0), 1e-9, 1e6)
        costs.append(cost0)
    return R, t, torch.stack(costs)

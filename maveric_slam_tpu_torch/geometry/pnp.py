"""Pose-only Gauss-Newton PnP refinement (port of
maveric_slam_tpu/geometry/pnp.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.lie import se3_exp
from ..ops.linalg import cholesky_small, cholesky_solve_small
from . import projection


class PnPResult(NamedTuple):
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,)
    cost: torch.Tensor  # () final robust cost
    num_used: torch.Tensor  # () int32 factors with weight > 0


def refine_pose(K, R0, t0, X, z, mask, huber_delta: float = 2.0,
                damping: float = 1e-4, iterations: int = 8) -> PnPResult:
    """Minimize sum_i huber(|pi(R X_i + t) - z_i|) over (R, t) with a fixed
    number of damped Gauss-Newton steps (X (N, 3), z (N, 2), mask (N,))."""
    w_valid = mask.to(torch.float32)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    R, t = R0, t0
    for _ in range(iterations):
        r, J_pose, _ = projection.residual_and_jacobians(K, R, t, X, z)
        w = projection.huber_weights(r, huber_delta) * w_valid
        H = torch.einsum("nki,n,nkj->ij", J_pose, w, J_pose)
        b = -torch.einsum("nki,n,nk->i", J_pose, w, r)
        H = H + damping * eye6
        xi = cholesky_solve_small(cholesky_small(H), b)
        dR, dt = se3_exp(xi)
        R, t = dR @ R, dR @ t + dt
    r, _, _ = projection.residual_and_jacobians(K, R, t, X, z)
    w = projection.huber_weights(r, huber_delta) * w_valid
    cost = torch.sum(w * torch.sum(r * r, dim=-1))
    return PnPResult(R=R, t=t, cost=cost, num_used=torch.sum(mask).to(torch.int32))

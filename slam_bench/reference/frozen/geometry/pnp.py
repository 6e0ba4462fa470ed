"""Pose-only Gauss-Newton PnP refinement (port of
maveric_slam_tpu/geometry/pnp.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.lie import se3_exp
from ..ops.linalg import cholesky_small, cholesky_solve_small
from . import projection


class PnPResult(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)
    cost: torch.Tensor  # (...) final robust cost
    num_used: torch.Tensor  # (...) int32 factors with weight > 0


def refine_pose(K, R0, t0, X, z, mask, huber_delta: float = 2.0,
                damping: float = 1e-4, iterations: int = 8) -> PnPResult:
    """Minimize sum_i huber(|pi(R X_i + t) - z_i|) over (R, t) with a fixed
    number of damped Gauss-Newton steps (X (..., N, 3), z (..., N, 2),
    mask (..., N); one pose per leading index)."""
    w_valid = mask.to(torch.float32)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    R, t = R0, t0
    for _ in range(iterations):
        r, J_pose, _ = projection.residual_and_jacobians(K, R, t, X, z)
        w = projection.huber_weights(r, huber_delta) * w_valid
        # J^T W J and -J^T W r as batched matrix products over the 2N rows:
        # the same products per pose whatever the batch (einsum's contraction
        # path, and so its rounding, changes with the batch shape).
        J = J_pose.flatten(-3, -2)  # (..., 2N, 6)
        Jw = (J * w.repeat_interleave(2, dim=-1)[..., None]).transpose(-1, -2)
        H = Jw @ J + damping * eye6
        b = -(Jw @ r.flatten(-2)[..., None])[..., 0]
        xi = cholesky_solve_small(cholesky_small(H), b)
        dR, dt = se3_exp(xi)
        R, t = dR @ R, (dR @ t[..., None])[..., 0] + dt
    r, _, _ = projection.residual_and_jacobians(K, R, t, X, z)
    w = projection.huber_weights(r, huber_delta) * w_valid
    cost = torch.sum(w * torch.sum(r * r, dim=-1), dim=-1)
    return PnPResult(R=R, t=t, cost=cost, num_used=torch.sum(mask, dim=-1).to(torch.int32))

"""Reprojection residuals and analytic pose Jacobians (port of
maveric_slam_tpu/geometry/projection.py).

Pose convention: (R, t) maps world/map points into the camera frame,
p_cam = R X + t; the update is left-multiplicative, T <- exp(xi^) T with
xi = (dt, dw), so d(p_cam)/d(dt) = I and d(p_cam)/d(dw) = -[p_cam]_x.
"""

from __future__ import annotations

import torch

from ..ops.lie import hat
from ..ops.linalg import apply_rows


def project(K: torch.Tensor, p_cam: torch.Tensor) -> torch.Tensor:
    """Pinhole projection of camera-frame points (..., 3) -> pixels (..., 2)."""
    z = torch.clamp(p_cam[..., 2], min=1e-6)
    u = K[0, 0] * p_cam[..., 0] / z + K[0, 2]
    v = K[1, 1] * p_cam[..., 1] / z + K[1, 2]
    return torch.stack([u, v], dim=-1)


def reprojection_residual(K, R, t, X, z) -> torch.Tensor:
    """r = pi(R X + t) - z for world points X (..., N, 3), pixels z (..., N, 2)
    and one pose R (..., 3, 3), t (..., 3) per leading index."""
    return project(K, apply_rows(X, R) + t[..., None, :]) - z


def residual_and_jacobians(K, R, t, X, z):
    """Residuals r (..., N, 2), J_pose (..., N, 2, 6) and J_point
    (..., N, 2, 3) for N factors (X (..., N, 3) world points, z (..., N, 2)
    pixels) sharing one pose R (..., 3, 3), t (..., 3) per leading index."""
    p = apply_rows(X, R) + t[..., None, :]
    x, y = p[..., 0], p[..., 1]
    z_ = torch.clamp(p[..., 2], min=1e-6)
    fx, fy = K[0, 0], K[1, 1]
    inv_z = 1.0 / z_
    r = project(K, p) - z
    zero = torch.zeros_like(x)
    dpi = torch.stack(
        [
            torch.stack([fx * inv_z, zero, -fx * x * inv_z * inv_z], -1),
            torch.stack([zero, fy * inv_z, -fy * y * inv_z * inv_z], -1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=p.dtype, device=p.device).expand(p.shape[:-1] + (3, 3))
    dp_dxi = torch.cat([eye, -hat(p)], dim=-1)
    return r, dpi @ dp_dxi, dpi @ R[..., None, :, :]


def huber_weights(r: torch.Tensor, delta: float) -> torch.Tensor:
    """IRLS weights (..., N) in (0, 1] for the Huber loss on residual norms."""
    norm = torch.linalg.vector_norm(r, dim=-1)
    return torch.where(norm <= delta, 1.0, delta / torch.clamp(norm, min=1e-12))

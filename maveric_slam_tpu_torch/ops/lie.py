"""SO(3)/SE(3) exponentials, batched and branch-free (port of the parts of
maveric_slam_tpu/ops/lie.py that projection and PnP use).

Conventions: rotations act on column vectors; leading batch dimensions are
allowed everywhere.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
# Below this squared angle the Taylor expansions are selected (both branches
# are computed; the cutoff only controls accuracy).
_SMALL_THETA2 = 1e-8


def hat(omega: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix [omega]_x."""
    o1, o2, o3 = omega[..., 0], omega[..., 1], omega[..., 2]
    z = torch.zeros_like(o1)
    r = torch.stack([z, -o3, o2, o3, z, -o1, -o2, o1, z], dim=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula with a Taylor fallback near zero."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < _SMALL_THETA2
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(omega)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """J_l(omega): exp((omega+d)^) ~ exp(d_l) exp(omega^), d_l = J_l d."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < _SMALL_THETA2
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (theta2 * theta))
    W = hat(omega)
    return _eye_like(W) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def se3_exp(xi: torch.Tensor):
    """xi = (rho, omega) -> (R, t) with t = J_l(omega) rho."""
    rho, omega = xi[..., :3], xi[..., 3:]
    R = so3_exp(omega)
    t = (so3_left_jacobian(omega) @ rho[..., None])[..., 0]
    return R, t

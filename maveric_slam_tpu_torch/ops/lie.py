"""SO(3)/SE(3) exponentials and logarithms, batched and branch-free (port
of the parts of maveric_slam_tpu/ops/lie.py that projection, PnP, bundle
adjustment and the pose graph use).

Every regime (near zero, normal, near pi) is computed and selected with
`torch.where`, never with a data-dependent Python branch, so the functions
run under `torch.func.vmap` and forward-mode `torch.func.jacfwd`.

Conventions: rotations act on column vectors; leading batch dimensions are
allowed everywhere; an SE(3) element is an (R (..., 3, 3), t (..., 3)) pair.
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


def vee(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _mv(A: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """A @ v for matrices (..., 3, 3) and vectors (..., 3)."""
    return (A @ v[..., None])[..., 0]


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


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Inverse of so3_exp: the trace formulation with a Taylor regime for
    trace near 3 and the axis from the symmetric part near theta = pi."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    tr_3 = tr - 3.0
    # Normal regime: theta = acos((tr-1)/2), magnitude = theta / (2 sin theta).
    cos_theta = torch.clamp((tr - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    sin_theta = torch.sqrt(torch.clamp(1.0 - cos_theta * cos_theta, min=_EPS))
    mag_normal = theta / (2.0 * sin_theta)
    # Near identity (trace near 3): theta ~ 0.
    mag_taylor = 0.5 - tr_3 / 12.0 + tr_3 * tr_3 / 60.0
    magnitude = torch.where(tr_3 > -1e-6, mag_taylor, mag_normal)
    axis = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                        R[..., 1, 0] - R[..., 0, 1]], dim=-1)
    omega = magnitude[..., None] * axis

    # Near theta = pi the antisymmetric part vanishes; the axis comes from the
    # symmetric part: n_i^2 = (R_ii - cos) / (1 - cos), n_i n_j from R_ij + R_ji.
    near_pi = cos_theta < -1.0 + 1e-4
    one_minus_cos = torch.clamp(1.0 - cos_theta, min=_EPS)
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    n_abs = torch.sqrt(torch.clamp((diag - cos_theta[..., None]) / one_minus_cos[..., None], min=0.0))
    sxy = R[..., 0, 1] + R[..., 1, 0]
    sxz = R[..., 0, 2] + R[..., 2, 0]
    syz = R[..., 1, 2] + R[..., 2, 1]
    nx, ny, nz = n_abs[..., 0], n_abs[..., 1], n_abs[..., 2]

    def _sgn(x):
        return torch.where(x < 0, -1.0, 1.0)

    # One candidate per dominant axis (that component positive, the others
    # signed by the products n_i n_j), selected branch-free.
    cand_x = torch.stack([nx, _sgn(sxy) * ny, _sgn(sxz) * nz], dim=-1)
    cand_y = torch.stack([_sgn(sxy) * nx, ny, _sgn(syz) * nz], dim=-1)
    cand_z = torch.stack([_sgn(sxz) * nx, _sgn(syz) * ny, nz], dim=-1)
    x_dom = (nx >= ny) & (nx >= nz)
    y_dom = ny >= nz
    n_pi = torch.where(x_dom[..., None], cand_x, torch.where(y_dom[..., None], cand_y, cand_z))
    # The overall sign follows the (small) antisymmetric part.
    flip = torch.sum(n_pi * axis, dim=-1) < 0.0
    n_pi = torch.where(flip[..., None], -n_pi, n_pi)
    return torch.where(near_pi[..., None], theta[..., None] * n_pi, omega)


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


def so3_inverse_left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """J_l^{-1}(omega) = I - W/2 + c W^2, c = 1/theta^2 - (1 + cos)/(2 theta
    sin), in the half-angle form that stays finite at theta = pi."""
    theta2 = torch.sum(omega * omega, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < _SMALL_THETA2
    half = 0.5 * theta
    c = torch.where(small, 1.0 / 12.0 + theta2 / 720.0,
                    1.0 / theta2 - torch.cos(half) / (2.0 * theta * torch.clamp(torch.sin(half), min=_EPS)))
    W = hat(omega)
    return _eye_like(W) - 0.5 * W + c[..., None, None] * (W @ W)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): first apply b, then a."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, t)


def se3_exp(xi: torch.Tensor):
    """xi = (rho, omega) -> (R, t) with t = J_l(omega) rho."""
    rho, omega = xi[..., :3], xi[..., 3:]
    R = so3_exp(omega)
    t = _mv(so3_left_jacobian(omega), rho)
    return R, t


def se3_log(R, t) -> torch.Tensor:
    omega = so3_log(R)
    return torch.cat([_mv(so3_inverse_left_jacobian(omega), t), omega], dim=-1)

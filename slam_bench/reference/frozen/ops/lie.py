"""Quaternions and SO(3)/SE(3) exponentials, logarithms and Jacobians,
batched and branch-free (port of maveric_slam_tpu/ops/lie.py).

Every regime (near zero, normal, near pi) is computed and selected with
`torch.where`, never with a data-dependent Python branch, so the functions
run under `torch.func.vmap` and forward-mode `torch.func.jacfwd`.

Conventions: quaternions are (w, x, y, z); rotations act on column vectors;
leading batch dimensions are allowed everywhere; an SE(3) element is an
(R (..., 3, 3), t (..., 3)) pair.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
# Below this squared angle the Taylor expansions are selected (both branches
# are computed; the cutoff only controls accuracy).
_SMALL_THETA2 = 1e-8


def quat_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product."""
    w1, x1, y1, z1 = torch.unbind(q1, dim=-1)
    w2, x2, y2, z2 = torch.unbind(q2, dim=-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def quat_conjugate(q: torch.Tensor) -> torch.Tensor:
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype, device=q.device)


def quat_normalize(q: torch.Tensor) -> torch.Tensor:
    return q / torch.clamp(torch.linalg.vector_norm(q, dim=-1, keepdim=True), min=_EPS)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors by unit quaternions: v + 2 (w (u x v) + u x (u x v))."""
    w, u = q[..., :1], q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_to_matrix(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = torch.unbind(quat_normalize(q), dim=-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    r = torch.stack([
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    ], dim=-1)
    return r.reshape(r.shape[:-1] + (3, 3))


def matrix_to_quat(R: torch.Tensor) -> torch.Tensor:
    """Shepperd's method, branch-free: all four candidate forms are computed
    and the best-conditioned one selected with `torch.where`."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    s0 = safe_sqrt(tr + 1.0) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], -1)
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], -1)
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], -1)
    cond0 = (tr > 0.0)[..., None]
    cond1 = ((m00 > m11) & (m00 > m22))[..., None]
    cond2 = (m11 > m22)[..., None]
    return quat_normalize(torch.where(cond0, q0, torch.where(cond1, q1, torch.where(cond2, q2, q3))))


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


def so3_right_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """J_r(omega) = J_l(-omega)."""
    return so3_left_jacobian(-omega)


def so3_inverse_right_jacobian(omega: torch.Tensor) -> torch.Tensor:
    return so3_inverse_left_jacobian(-omega)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra, ta) * (Rb, tb): first apply b, then a."""
    return Ra @ Rb, _mv(Ra, tb) + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -_mv(Rt, t)


def se3_apply(R, t, points):
    """Transform points (..., 3): R p + t."""
    return _mv(R, points) + t


def se3_exp(xi: torch.Tensor):
    """xi = (rho, omega) -> (R, t) with t = J_l(omega) rho."""
    rho, omega = xi[..., :3], xi[..., 3:]
    R = so3_exp(omega)
    t = _mv(so3_left_jacobian(omega), rho)
    return R, t


def se3_log(R, t) -> torch.Tensor:
    omega = so3_log(R)
    return torch.cat([_mv(so3_inverse_left_jacobian(omega), t), omega], dim=-1)

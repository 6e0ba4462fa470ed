"""Essential-matrix estimation and pose recovery, batched (port of
maveric_slam_tpu/geometry/epipolar.py).

Points are in normalized camera coordinates (K^-1 applied); E satisfies
p2^T E p1 = 0; the recovered (R, t) maps cam1 points to cam2: p2 ~ R p1 + t.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..ops.lie import hat
from ..ops.linalg import apply_rows, smallest_eigvec_inverse_iteration
from ..ops.svd3 import svd3

_W = ((0.0, -1.0, 0.0), (1.0, 0.0, 0.0), (0.0, 0.0, 1.0))


def normalize_points(points: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel -> normalized camera coordinates."""
    return torch.stack(
        [(points[..., 0] - K[0, 2]) / K[0, 0], (points[..., 1] - K[1, 2]) / K[1, 1]], dim=-1
    )


def eight_point_design(p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Design matrix rows (..., M, 9) for p2^T E p1 = 0."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    one = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, one], dim=-1)


def _rank2_projection(U, s, V):
    d = torch.zeros_like(s)
    d[..., 0] = 1.0
    d[..., 1] = 1.0
    return U @ (d[..., :, None] * V.transpose(-1, -2))


def estimate_essential(p1, p2, weights=None, project: bool = True,
                       nullspace_iters: int = 10) -> torch.Tensor:
    """Least-squares essential matrix (..., 3, 3) from M >= 8 correspondences
    p1, p2 (..., M, 2), optionally weighted (weights broadcast against the
    design matrix). project=False skips the essential-manifold projection and
    is refused for minimal (M <= 8) samples, whose unprojected nullspace can
    score a fake-perfect Sampson error on small-baseline data."""
    if not project and p1.shape[-2] <= 8:
        raise ValueError(
            "estimate_essential(project=False) requires a non-minimal fit "
            f"(got M={p1.shape[-2]} <= 8 correspondences); minimal-sample "
            "hypotheses must be scored on the projected E"
        )
    A = eight_point_design(p1, p2)
    if weights is not None:
        A = A * weights[..., None]
    AtA = A.transpose(-1, -2) @ A
    e = smallest_eigvec_inverse_iteration(AtA, iterations=nullspace_iters)
    E = e.reshape(e.shape[:-1] + (3, 3))
    if not project:
        return E
    return _rank2_projection(*svd3(E))


def sampson_distance(E: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor) -> torch.Tensor:
    """Squared first-order geometric (Sampson) distance (..., M)."""
    ones = torch.ones_like(p1[..., :1])
    x1 = torch.cat([p1, ones], dim=-1)
    x2 = torch.cat([p2, ones], dim=-1)
    Ex1 = apply_rows(x1, E)  # (..., M, 3): (E x1)_i
    Etx2 = apply_rows(x2, E.transpose(-1, -2))  # (..., M, 3): (E^T x2)_i
    num = torch.sum(x2 * Ex1, dim=-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def triangulate(R, t, p1, p2, method: str = "midpoint") -> torch.Tensor:
    """Two-view triangulation for P1 = [I|0], P2 = [R|t]; R (..., 3, 3),
    t (..., 3), p1/p2 (..., M, 2) normalized -> X (..., M, 3) in cam 1.
    method="midpoint": the closed-form ray midpoint; "dlt": the linear 4x4
    system's nullspace by inverse iteration (the nullspace kernel on a
    CUDA tensor)."""
    if method == "midpoint":
        return _triangulate_midpoint(R, t, p1, p2)
    if method == "dlt":
        return _triangulate_dlt(R, t, p1, p2)
    raise ValueError(f"triangulate: method {method!r} is not 'midpoint' or 'dlt'")


def _triangulate_midpoint(R, t, p1, p2) -> torch.Tensor:
    """The midpoint of the closest points s a and c2 + u b of the two rays.
    The JAX package solves the 2x2 normal equations as written, with
    determinant |a|^2 |b|^2 - (a.b)^2, which cancels between near-parallel
    rays: its rounding error grows as eps / sin^2(parallax), and two devices
    that round a dot product differently place such a point meters apart
    (ROADMAP Faults (g)). The same determinant and numerators are computed
    here as products of cross products (the Lagrange and Binet-Cauchy
    identities: |a x b|^2, (c2 x b).(a x b), (c2 x a).(a x b)), whose
    error grows only as eps / sin(parallax)."""
    a = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    d2 = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1)
    Rt = R.transpose(-1, -2)
    b = apply_rows(d2, Rt)  # R^T [p2;1] per row
    c2 = -apply_rows(t[..., None, :], Rt)  # (..., 1, 3): -R^T t
    a, b, c2 = torch.broadcast_tensors(a, b, c2)
    n = torch.linalg.cross(a, b)
    den = torch.sum(n * n, dim=-1)
    den = torch.where(den < 1e-12, 1e-12, den)
    s = torch.sum(torch.linalg.cross(c2, b) * n, dim=-1) / den
    u = torch.sum(torch.linalg.cross(c2, a) * n, dim=-1) / den
    return 0.5 * (s[..., None] * a + c2 + u[..., None] * b)


def _triangulate_dlt(R, t, p1, p2) -> torch.Tensor:
    P2 = torch.cat([R, t[..., :, None]], dim=-1)[..., None, :, :]  # (..., 1, 3, 4)
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    # P1's rows are [1,0,0,0], [0,1,0,0], [0,0,1,0].
    zeros, ones = torch.zeros_like(x1), torch.ones_like(x1)
    row_a = torch.stack([-ones, zeros, x1, zeros], dim=-1)  # x1 * r2 - r0
    row_b = torch.stack([zeros, -ones, y1, zeros], dim=-1)  # y1 * r2 - r1
    row_c = x2[..., None] * P2[..., 2, :] - P2[..., 0, :]
    row_d = y2[..., None] * P2[..., 2, :] - P2[..., 1, :]
    A = torch.stack(torch.broadcast_tensors(row_a, row_b, row_c, row_d), dim=-2)  # (..., M, 4, 4)
    Xh = smallest_eigvec_inverse_iteration(A.transpose(-1, -2) @ A)
    w = Xh[..., 3]
    w = torch.where(torch.abs(w) < 1e-12, 1e-12, w)
    return Xh[..., :3] / w[..., None]


def _decompose(U, V):
    """(R1, R2, t) = (U W V^T, U W^T V^T, U[:, 2])."""
    Vt = V.transpose(-1, -2)
    W = torch.tensor(_W, dtype=U.dtype, device=U.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]


def decompose_essential(E: torch.Tensor):
    """E -> (R1, R2, t): the two rotation candidates (proper rotations, as
    svd3's U and V are) and the unit translation, from one svd3 (the
    kernel on a CUDA tensor)."""
    U, _, V = svd3(E)
    return _decompose(U, V)


def project_and_decompose(E: torch.Tensor):
    """One svd3 shared by the rank-2 projection and the pose decomposition:
    (E_proj, R1, R2, t) as `decompose_essential`'s."""
    U, s, V = svd3(E)
    return (_rank2_projection(U, s, V), *_decompose(U, V))


def choose_pose_by_cheirality(R1, R2, t, p1, p2, weights=None
                              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Pick among the 4 (R, +-t) candidates by positive-depth voting; ties go
    to the first candidate."""
    cands_R = torch.stack([R1, R1, R2, R2], dim=0)  # (4, ..., 3, 3)
    cands_t = torch.stack([t, -t, t, -t], dim=0)
    X = triangulate(cands_R, cands_t, p1, p2)  # (4, ..., M, 3)
    z1 = X[..., 2]
    z2 = apply_rows(X, cands_R)[..., 2] + cands_t[..., None, 2]
    good = (z1 > 0) & (z2 > 0)
    if weights is not None:
        good = good & (weights > 0)
    counts = torch.sum(good, dim=-1)  # (4, ...)
    best = torch.argmax(counts, dim=0)
    R = torch.take_along_dim(cands_R, best[None, ..., None, None], dim=0)[0]
    t_best = torch.take_along_dim(cands_t, best[None, ..., None], dim=0)[0]
    n_good = torch.take_along_dim(counts, best[None, ...], dim=0)[0]
    return R, t_best, n_good


def recover_pose(E: torch.Tensor, p1, p2, weights=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(R, t_unit, num_good): the candidate of `decompose_essential(E)` with
    the most correspondences in front of both cameras (cv2.recoverPose's
    rule); batched over E's leading dims."""
    return choose_pose_by_cheirality(*decompose_essential(E), p1, p2, weights)


def essential_from_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """E = [t]_x R for p2 = R p1 + t."""
    return hat(t) @ R

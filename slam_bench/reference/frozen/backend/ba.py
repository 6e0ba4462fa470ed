"""Sliding-window bundle adjustment by Schur complement (port of
maveric_slam_tpu/backend/ba.py).

The factor set is a dense (L, P) grid (every landmark x every window pose,
masked). Per-factor Hessian blocks go into a landmark block diagonal
H_ll (L, 3, 3), pose-landmark blocks W (L, P, 6, 3) and pose blocks
H_pp (P, 6, 6); landmarks are eliminated with damped analytic 3x3 inverses
and the Schur update S = H_pp - sum_l W A^-1 W^T; the reduced pose system is
solved by Cholesky with a gauge prior; landmarks are back-substituted; a
step that raises the robust cost is rejected. Everything stays on the
problem's device: the iteration loop issues no host synchronisation.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..geometry import projection
from ..ops.lie import se3_exp
from ..ops.linalg import inv3x3


class BAProblem(NamedTuple):
    """Dense-window BA problem, L landmarks and P poses; pose p maps world
    points into its camera: p_cam = R[p] X + t[p]."""

    K: torch.Tensor  # (3, 3)
    R: torch.Tensor  # (P, 3, 3)
    t: torch.Tensor  # (P, 3)
    X: torch.Tensor  # (L, 3)
    uv: torch.Tensor  # (L, P, 2) observations
    mask: torch.Tensor  # (L, P) bool: the observation exists


class BAStats(NamedTuple):
    cost: torch.Tensor  # (iterations + 1,) robust cost before each iteration, then the final
    num_factors: torch.Tensor  # () int32


def _residuals(problem: BAProblem):
    """Residuals (L, P, 2) and Jacobians (L, P, 2, 6) / (L, P, 2, 3) on the
    dense factor grid."""
    zeros = torch.zeros_like(problem.X[..., :2])
    r0, J_pose, J_point = projection.residual_and_jacobians(
        problem.K, problem.R, problem.t, problem.X[None], zeros[None])  # (P, L, ...)
    return r0.transpose(0, 1) - problem.uv, J_pose.transpose(0, 1), J_point.transpose(0, 1)


def _robust_weights(r: torch.Tensor, mask: torch.Tensor, delta: float) -> torch.Tensor:
    return torch.where(mask, projection.huber_weights(r, delta), 0.0)


def _cost(r: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return 0.5 * torch.sum(w * torch.sum(r * r, dim=-1))


def build_normal_blocks(problem: BAProblem, huber_delta: float):
    """One linearization: (H_ll (L, 3, 3), b_l (L, 3), H_pp (P, 6, 6),
    b_p (P, 6), W (L, P, 6, 3), cost)."""
    r, Jp, Jl = _residuals(problem)
    w = _robust_weights(r, problem.mask, huber_delta)
    wJp, wJl = w[..., None, None] * Jp, w[..., None, None] * Jl
    H_ll = torch.einsum("lpki,lpkj->lij", wJl, Jl)
    b_l = -torch.einsum("lpki,lpk->li", wJl, r)
    H_pp = torch.einsum("lpki,lpkj->pij", wJp, Jp)
    b_p = -torch.einsum("lpki,lpk->pi", wJp, r)
    W = torch.einsum("lpki,lpkj->lpij", wJp, Jl)
    return H_ll, b_l, H_pp, b_p, W, _cost(r, w)


def _block_diag(blocks: torch.Tensor) -> torch.Tensor:
    """(P, n, n) blocks -> (P, P, n, n) with them on the diagonal, zeros off it."""
    eye = torch.eye(blocks.shape[0], dtype=blocks.dtype, device=blocks.device)
    return torch.einsum("pq,pim->pqim", eye, blocks)


def reduce_schur(H_ll, b_l, H_pp, b_p, W, damping):
    """Eliminate the landmarks: the reduced pose system S (P, P, 6, 6), its
    right-hand side (P, 6) and the damped inverses A^-1 (L, 3, 3).

    W A^-1 is formed first, (L, P, 6, 3); the second product contracts l and
    k as one (6P x 3L) @ (3L x 6P) matrix product, so no (L, P, P, 6, 6)
    intermediate is formed."""
    A_inv = inv3x3(H_ll, damping=damping)
    WA = torch.einsum("lpij,ljk->lpik", W, A_inv)
    S_off = -torch.einsum("lpik,lqmk->pqim", WA, W)
    eye6 = torch.eye(6, dtype=H_pp.dtype, device=H_pp.device)
    S = S_off + _block_diag(H_pp + damping * eye6)
    rhs = b_p - torch.einsum("lpik,lk->pi", WA, b_l)
    return S, rhs, A_inv


def solve_reduced(S, rhs, gauge_weight: float = 1e8, num_anchored: int = 1):
    """Solve the reduced pose system with a gauge prior on the first
    `num_anchored` poses (2 anchors also pin the monocular scale)."""
    p = S.shape[0]
    prior = torch.zeros(p, dtype=S.dtype, device=S.device)
    prior[:num_anchored] = gauge_weight
    S = S + _block_diag(prior[:, None, None] * torch.eye(6, dtype=S.dtype, device=S.device))
    S_flat = S.transpose(1, 2).reshape(p * 6, p * 6)
    L, info = torch.linalg.cholesky_ex(S_flat)
    L = torch.where(info == 0, L, torch.nan)  # not positive definite: NaN, as jnp's
    y = torch.linalg.solve_triangular(L, rhs.reshape(p * 6, 1), upper=False)
    dx = torch.linalg.solve_triangular(L.T, y, upper=True)[:, 0]
    return dx.reshape(p, 6)


def back_substitute(A_inv, b_l, W, dx_p):
    """Landmark updates dx_l = A^-1 (b_l - W^T dx_p)."""
    Wt_dxp = torch.einsum("lpij,pi->lj", W, dx_p)
    return torch.einsum("lij,lj->li", A_inv, b_l - Wt_dxp)


def apply_update(problem, dx_p, dx_l):
    """The problem (dense or sparse_ba's) with poses T <- exp(dx_p^) T and
    landmarks X + dx_l."""
    dR, dt = se3_exp(dx_p)
    return problem._replace(R=dR @ problem.R,
                            t=torch.einsum("pij,pj->pi", dR, problem.t) + dt,
                            X=problem.X + dx_l)


def lm_damping(H_ll: torch.Tensor, damping: float) -> torch.Tensor:
    """Scale-aware LM damping: `damping` times the mean diagonal of H_ll."""
    tr = H_ll[..., 0, 0] + H_ll[..., 1, 1] + H_ll[..., 2, 2]
    return damping * torch.clamp(torch.mean(tr) / 3.0, min=1e-6)


def select(accept: torch.Tensor, new, old):
    """Field by field, `new` where `accept` else `old` (a () bool tensor)."""
    return type(old)(*(torch.where(accept, a, b) for a, b in zip(new, old)))


def bundle_adjust(problem: BAProblem, iterations: int = 10, damping: float = 1e-4,
                  huber_delta: float = 2.0, num_anchored: int = 1) -> Tuple[BAProblem, BAStats]:
    """Damped Gauss-Newton with Schur elimination, a fixed iteration count."""
    prob, costs = problem, []
    for _ in range(iterations):
        H_ll, b_l, H_pp, b_p, W, cost = build_normal_blocks(prob, huber_delta)
        S, rhs, A_inv = reduce_schur(H_ll, b_l, H_pp, b_p, W, lm_damping(H_ll, damping))
        dx_p = solve_reduced(S, rhs, num_anchored=num_anchored)
        new = apply_update(prob, dx_p, back_substitute(A_inv, b_l, W, dx_p))
        r_new, _, _ = _residuals(new)
        accept = _cost(r_new, _robust_weights(r_new, prob.mask, huber_delta)) < cost
        prob = select(accept, new, prob)
        costs.append(cost)
    r, _, _ = _residuals(prob)
    costs.append(_cost(r, _robust_weights(r, prob.mask, huber_delta)))
    return prob, BAStats(cost=torch.stack(costs),
                         num_factors=torch.sum(prob.mask).to(torch.int32))

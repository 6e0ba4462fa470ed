"""Factor-list bundle adjustment (port of maveric_slam_tpu/backend/sparse_ba.py).

The factors are a fixed-capacity (F,) list of (landmark, pose, uv, valid)
instead of the dense (L, P) grid: residuals and Jacobians are computed per
factor and summed into the same Schur blocks as `backend.ba` with
`index_add_`; elimination, solve and back-substitution are `backend.ba`'s.

On a CUDA device `index_add_` sums with atomics, so the order of each
block's sum, and with it its last bits, can change from run to run; the
card is held to the dense solver and to the CPU within tolerances (see
tests/test_torch_backend.py and chip_smoke.py's `[ba]` phase). On the CPU
the sums run in factor order.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..geometry import projection
from . import ba


class SparseBAProblem(NamedTuple):
    """Factor-list BA problem: L landmarks, P poses, F factor slots. Invalid
    slots carry f_l = f_p = 0 and valid = False; their weight is 0."""

    K: torch.Tensor  # (3, 3)
    R: torch.Tensor  # (P, 3, 3)
    t: torch.Tensor  # (P, 3)
    X: torch.Tensor  # (L, 3)
    f_l: torch.Tensor  # (F,) int64 landmark index per factor
    f_p: torch.Tensor  # (F,) int64 pose index per factor
    uv: torch.Tensor  # (F, 2) observations
    valid: torch.Tensor  # (F,) bool


def from_dense(problem: ba.BAProblem, capacity: int | None = None) -> SparseBAProblem:
    """The dense problem's observed cells as a factor list, in row-major
    (landmark, pose) order, on the problem's device (built on the host;
    capacity defaults to the observation count rounded up to 128)."""
    mask = problem.mask.cpu().numpy()
    l_idx, p_idx = np.nonzero(mask)
    n = l_idx.size
    if capacity is None:
        capacity = max(128, -(-n // 128) * 128)
    if n > capacity:
        raise ValueError(f"{n} factors exceed capacity {capacity}")
    f_l = np.zeros((capacity,), np.int64)
    f_p = np.zeros((capacity,), np.int64)
    uv = np.zeros((capacity, 2), np.float32)
    valid = np.zeros((capacity,), bool)
    f_l[:n], f_p[:n], valid[:n] = l_idx, p_idx, True
    uv[:n] = problem.uv.cpu().numpy()[l_idx, p_idx]
    dev = problem.R.device
    return SparseBAProblem(
        K=problem.K, R=problem.R, t=problem.t, X=problem.X,
        f_l=torch.from_numpy(f_l).to(dev), f_p=torch.from_numpy(f_p).to(dev),
        uv=torch.from_numpy(uv).to(dev), valid=torch.from_numpy(valid).to(dev))


def _factor_residuals(problem: SparseBAProblem):
    """Per-factor residual (F, 2) and Jacobians (F, 2, 6) / (F, 2, 3)."""
    r, J_pose, J_point = projection.residual_and_jacobians(
        problem.K, problem.R[problem.f_p], problem.t[problem.f_p],
        problem.X[problem.f_l][:, None], problem.uv[:, None])
    return r[:, 0], J_pose[:, 0], J_point[:, 0]


def _weights(problem: SparseBAProblem, r: torch.Tensor, huber_delta: float) -> torch.Tensor:
    return torch.where(problem.valid, projection.huber_weights(r, huber_delta), 0.0)


def _assemble(problem: SparseBAProblem, huber_delta: float):
    """The factor list summed into backend.ba's Schur blocks: (H_ll, b_l,
    H_pp, b_p, W, cost)."""
    r, Jp, Jl = _factor_residuals(problem)
    w = _weights(problem, r, huber_delta)
    L, P = problem.X.shape[0], problem.R.shape[0]
    wJp, wJl = w[:, None, None] * Jp, w[:, None, None] * Jl

    def scatter(n, index, values):
        return torch.zeros((n,) + values.shape[1:], dtype=r.dtype,
                           device=r.device).index_add_(0, index, values)

    H_ll = scatter(L, problem.f_l, torch.einsum("fki,fkj->fij", wJl, Jl))
    b_l = scatter(L, problem.f_l, -torch.einsum("fki,fk->fi", wJl, r))
    H_pp = scatter(P, problem.f_p, torch.einsum("fki,fkj->fij", wJp, Jp))
    b_p = scatter(P, problem.f_p, -torch.einsum("fki,fk->fi", wJp, r))
    W = scatter(L * P, problem.f_l * P + problem.f_p,
                torch.einsum("fki,fkj->fij", wJp, Jl)).reshape(L, P, 6, 3)
    return H_ll, b_l, H_pp, b_p, W, ba._cost(r, w)


def bundle_adjust(problem: SparseBAProblem, iterations: int = 10, damping: float = 1e-4,
                  huber_delta: float = 2.0, num_anchored: int = 1
                  ) -> Tuple[SparseBAProblem, torch.Tensor]:
    """Damped Gauss-Newton over the factor list; returns the solved problem
    and the cost before each iteration with the final one appended."""
    prob, costs = problem, []
    for _ in range(iterations):
        H_ll, b_l, H_pp, b_p, W, cost = _assemble(prob, huber_delta)
        S, rhs, A_inv = ba.reduce_schur(H_ll, b_l, H_pp, b_p, W, ba.lm_damping(H_ll, damping))
        dx_p = ba.solve_reduced(S, rhs, num_anchored=num_anchored)
        new = ba.apply_update(prob, dx_p, ba.back_substitute(A_inv, b_l, W, dx_p))
        r_new, _, _ = _factor_residuals(new)
        accept = ba._cost(r_new, _weights(new, r_new, huber_delta)) < cost
        prob = ba.select(accept, new, prob)
        costs.append(cost)
    r, _, _ = _factor_residuals(prob)
    costs.append(ba._cost(r, _weights(prob, r, huber_delta)))
    return prob, torch.stack(costs)

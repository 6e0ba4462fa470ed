"""Landmark-sharded Schur-complement bundle adjustment over a mesh (port of
maveric_slam_tpu/parallel/sharded_ba.py).

Landmarks are independent through linearization, block inversion and the
Schur contraction; only the reduced (6P x 6P) pose system needs the other
ranks. Each rank holds a block of L / n landmarks (with their observations)
and the replicated poses, runs the single-device functions of backend/ba.py
on its block, and sums what is shared with all-reduces. Every factor
(l, p) lives with landmark l on exactly one rank, so no Hessian block is
counted twice.

Per iteration, three all-reduces in the JAX package's order: (the cost,
the mean landmark trace for the damping), then (S, rhs), then the new
cost. The Cholesky of S and the pose update run on every rank, so the
poses stay replicated bit for bit. On a mesh of one rank the iteration is
the single-device `bundle_adjust`'s, operation for operation.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..backend import ba
from . import mesh as mesh_lib
from .mesh import Mesh


def shard_problem(problem: ba.BAProblem, mesh: Mesh) -> ba.BAProblem:
    """This rank's landmark block of `problem` (tensors or numpy arrays) and
    the replicated camera and poses, on the mesh's device. L must divide by
    the mesh size (pad with masked landmarks)."""
    rows = mesh_lib.local_rows(problem.X.shape[0], mesh, "landmarks")

    def on(a):
        return torch.as_tensor(a).to(mesh.device)

    return ba.BAProblem(K=on(problem.K), R=on(problem.R), t=on(problem.t), X=on(problem.X[rows]),
                        uv=on(problem.uv[rows]), mask=on(problem.mask[rows]))


def sharded_bundle_adjust(problem: ba.BAProblem, mesh: Mesh, iterations: int = 10,
                          damping: float = 1e-4, huber_delta: float = 2.0,
                          num_anchored: int = 1) -> Tuple[ba.BAProblem, torch.Tensor]:
    """Damped Gauss-Newton over the mesh from this rank's block
    (`shard_problem`). Returns (the solved problem: replicated R and t, this
    rank's X), the cost before each iteration (iterations,))."""
    n = mesh.size
    p = problem.R.shape[0]
    eye = ba._block_diag(torch.eye(6, dtype=problem.R.dtype, device=problem.R.device).expand(p, 6, 6))
    prob, costs = problem, []
    for _ in range(iterations):
        H_ll, b_l, H_pp, b_p, W, cost_part = ba.build_normal_blocks(prob, huber_delta)
        # Globally consistent LM damping: the mean of the landmark traces
        # over every rank (blocks are equal, so the mean of the blocks' means).
        tr = H_ll[..., 0, 0] + H_ll[..., 1, 1] + H_ll[..., 2, 2]
        cost, tr_mean = mesh_lib.psum(torch.stack([cost_part, torch.mean(tr) / n]), mesh)
        lam = damping * torch.clamp(tr_mean / 3.0, min=1e-6)
        S_part, rhs_part, A_inv = ba.reduce_schur(H_ll, b_l, H_pp, b_p, W, lam)
        # reduce_schur damped S's diagonal on every rank; keep one copy after the sum.
        S_part = S_part - (1.0 - 1.0 / n) * lam * eye
        flat = mesh_lib.psum(torch.cat([S_part.reshape(-1), rhs_part.reshape(-1)]), mesh)
        S, rhs = flat[:S_part.numel()].reshape(S_part.shape), flat[S_part.numel():].reshape(p, 6)
        dx_p = ba.solve_reduced(S, rhs, num_anchored=num_anchored)
        new = ba.apply_update(prob, dx_p, ba.back_substitute(A_inv, b_l, W, dx_p))
        r_new, _, _ = ba._residuals(new)
        new_cost = mesh_lib.psum(ba._cost(r_new, ba._robust_weights(r_new, prob.mask, huber_delta)),
                                 mesh)
        prob = ba.select(new_cost < cost, new, prob)
        costs.append(cost)
    return prob, torch.stack(costs)


def gather_landmarks(X: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's landmark block, in landmark order: (L, 3) on every rank."""
    return mesh_lib.all_gather(X, mesh).reshape(-1, X.shape[-1])

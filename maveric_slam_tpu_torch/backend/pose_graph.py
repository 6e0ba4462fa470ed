"""Pose-graph optimization over between-factors, odometry and loop closures
(port of maveric_slam_tpu/backend/pose_graph.py).

A fixed-capacity edge list, a dense (6P x 6P) normal system and adaptive
Levenberg-Marquardt with a gauge prior on pose 0. The loop runs on the
graph's device with no host synchronisation: acceptance and the damping
schedule are tensor selects, and the solve reports no error to the host.

The normal system is summed with `index_put_(accumulate=True)`. On a CUDA
device PyTorch sorts the indices and adds each target's terms in one
thread, a fixed order: two solves of one graph on a card are bitwise equal
(chip_smoke.py `[pose-graph]` checks it), which a resumed engine needs to
replay a loop closure exactly (`[resume]`). The card is held to the CPU
within a tolerance (`[pose-graph]`): their products round differently.

Each iteration's spans (utils/profiling.py): `pose_graph.normal_system`
(the Jacobians, H and b), `pose_graph.lu_solve` (the damped solve) and
`pose_graph.update` (the step, its cost and the acceptance).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from ..ops import lie
from ..utils import profiling
from . import relin


class PoseGraph(NamedTuple):
    R: torch.Tensor  # (P, 3, 3) world-from-camera rotations
    t: torch.Tensor  # (P, 3)
    edge_i: torch.Tensor  # (E,) int64 source pose index
    edge_j: torch.Tensor  # (E,) int64 target pose index
    R_meas: torch.Tensor  # (E, 3, 3) measured T_ci_cj rotation
    t_meas: torch.Tensor  # (E, 3)
    weight: torch.Tensor  # (E,) float32; 0 disables an edge


def _edge_args(graph: PoseGraph, R, t):
    return (R[graph.edge_i], t[graph.edge_i], R[graph.edge_j], t[graph.edge_j],
            graph.R_meas, graph.t_meas)


def _cost(graph: PoseGraph, R, t) -> torch.Tensor:
    r = relin.between_residual(*_edge_args(graph, R, t))
    return 0.5 * torch.sum(graph.weight * torch.sum(r * r, dim=-1))


def _normal_system(graph: PoseGraph, R, t):
    """H (P, P, 6, 6) and b (P, 6) of the Gauss-Newton step."""
    p = R.shape[0]
    r, J_i, J_j = relin.between_residual_jacobians(*_edge_args(graph, R, t))
    w = graph.weight[:, None, None]
    wJi, wJj = w * J_i, w * J_j
    ei, ej = graph.edge_i, graph.edge_j
    H = torch.zeros((p, p, 6, 6), dtype=r.dtype, device=r.device)
    for (a, b), block in (((ei, ei), wJi.transpose(1, 2) @ J_i),
                          ((ej, ej), wJj.transpose(1, 2) @ J_j),
                          ((ei, ej), wJi.transpose(1, 2) @ J_j),
                          ((ej, ei), wJj.transpose(1, 2) @ J_i)):
        H.index_put_((a, b), block, accumulate=True)
    b = torch.zeros((p, 6), dtype=r.dtype, device=r.device)
    b.index_put_((ei,), -torch.einsum("eki,ek->ei", wJi, r), accumulate=True)
    b.index_put_((ej,), -torch.einsum("eki,ek->ei", wJj, r), accumulate=True)
    return H, b


def optimize(graph: PoseGraph, iterations: int = 10, damping: float = 1e-6,
             gauge_weight: float = 1e8) -> Tuple[PoseGraph, torch.Tensor]:
    """Adaptive LM on all poses: a step is kept only if it lowers the cost;
    lambda halves on success and quadruples on rejection, within
    [1e-8, 1e6]. Returns the optimized graph and the costs, the initial
    one first and then the cost after each iteration."""
    p = graph.R.shape[0]
    dev, dt_ = graph.R.device, graph.R.dtype
    eye6 = torch.eye(6, dtype=dt_, device=dev)
    gauge = torch.zeros(p, dtype=dt_, device=dev)
    gauge[0] = gauge_weight
    eye_p = torch.eye(p, dtype=dt_, device=dev)
    R, t = graph.R, graph.t
    cost = _cost(graph, R, t)
    lam = torch.tensor(max(damping, 1e-4), dtype=dt_, device=dev)
    costs = [cost]
    for _ in range(iterations):
        with profiling.span("pose_graph.normal_system"):
            H, b = _normal_system(graph, R, t)
        with profiling.span("pose_graph.lu_solve"):
            H = H + torch.einsum("pq,im->pqim", eye_p, lam * eye6)
            H = H + torch.einsum("pq,p,im->pqim", eye_p, gauge, eye6)
            dx = torch.linalg.solve_ex(H.transpose(1, 2).reshape(p * 6, p * 6),
                                       b.reshape(-1))[0].reshape(p, 6)
        with profiling.span("pose_graph.update"):
            dR, dt = lie.se3_exp(dx)
            R_c, t_c = dR @ R, torch.einsum("pij,pj->pi", dR, t) + dt
            new_cost = _cost(graph, R_c, t_c)
            accept = torch.isfinite(new_cost) & (new_cost < cost)
            R = torch.where(accept, R_c, R)
            t = torch.where(accept, t_c, t)
            cost = torch.where(accept, new_cost, cost)
            lam = torch.clamp(torch.where(accept, lam * 0.5, lam * 4.0), 1e-8, 1e6)
            costs.append(cost)
    return graph._replace(R=R, t=t), torch.stack(costs)


def odometry_edges(rel_R: torch.Tensor, rel_t: torch.Tensor):
    """Consecutive-pose edges (i, i + 1) from the tracker's relative
    measurements T_c(i+1)_ci: the edge measurement T_ci_c(i+1) is their
    inverse. Returns (edge_i, edge_j, R_meas, t_meas)."""
    n = rel_R.shape[0]
    R_m, t_m = lie.se3_inverse(rel_R, rel_t)
    return (torch.arange(n, device=rel_R.device), torch.arange(1, n + 1, device=rel_R.device),
            R_m, t_m)

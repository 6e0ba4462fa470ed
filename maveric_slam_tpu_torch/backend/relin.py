"""Pose-graph relinearization: between-factor residuals and their exact
Jacobians (port of maveric_slam_tpu/backend/relin.py).

The Jacobians are forward-mode derivatives of the perturbed residual, as
the JAX package takes them (`jax.jacfwd` under `jax.vmap` over the edges).
Here one `torch.func.jvp` runs over all edges at once for each of the 12
perturbation directions, the directions under `torch.func.vmap`: an edge's
residual depends on its own perturbation only, so the tangent e_k on every
edge gives column k of every edge's Jacobian. (Per edge, under vmap, every
value would be 0-dimensional, and PyTorch's forward mode promotes the
tangent of a 0-dimensional f32 tensor times a Python float to f64.)
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.func import jvp, vmap

from ..ops import lie


def between_residual(R_i, t_i, R_j, t_j, R_meas, t_meas) -> torch.Tensor:
    """r = Log(T_meas^-1 T_i^-1 T_j) (..., 6), zero when T_i^-1 T_j == T_meas.
    Poses are world-from-camera; the measurement is T_ci_cj."""
    R_ij, t_ij = lie.se3_compose(*lie.se3_inverse(R_i, t_i), R_j, t_j)
    R_err, t_err = lie.se3_compose(*lie.se3_inverse(R_meas, t_meas), R_ij, t_ij)
    return lie.se3_log(R_err, t_err)


def _perturbed(xi_i, xi_j, R_i, t_i, R_j, t_j, R_meas, t_meas):
    """The residual after the left-multiplicative updates exp(xi^) T_i and
    exp(xi^) T_j, the boxplus of the BA and PnP solvers."""
    Ri2, ti2 = lie.se3_compose(*lie.se3_exp(xi_i), R_i, t_i)
    Rj2, tj2 = lie.se3_compose(*lie.se3_exp(xi_j), R_j, t_j)
    return between_residual(Ri2, ti2, Rj2, tj2, R_meas, t_meas)


def between_residual_jacobians(R_i, t_i, R_j, t_j, R_meas, t_meas
                               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Residual r (..., 6) and its Jacobians J_i, J_j (..., 6, 6) with respect
    to left-multiplicative perturbations of T_i and T_j; one leading edge
    axis E or none."""
    if R_i.ndim == 2:
        r, J_i, J_j = between_residual_jacobians(
            *(a[None] for a in (R_i, t_i, R_j, t_j, R_meas, t_meas)))
        return r[0], J_i[0], J_j[0]
    e = R_i.shape[0]
    zeros = torch.zeros((e, 6), dtype=R_i.dtype, device=R_i.device)
    basis = torch.eye(12, dtype=R_i.dtype, device=R_i.device)[:, None, :].expand(12, e, 12)

    def column(tan_i, tan_j):
        return jvp(lambda xi_i, xi_j: _perturbed(xi_i, xi_j, R_i, t_i, R_j, t_j, R_meas, t_meas),
                   (zeros, zeros), (tan_i, tan_j))[1]

    J = vmap(column)(basis[..., :6], basis[..., 6:]).permute(1, 2, 0)  # (E, 6 out, 12 in)
    return between_residual(R_i, t_i, R_j, t_j, R_meas, t_meas), J[..., :6], J[..., 6:]


def so3_local_jacobian(R: torch.Tensor) -> torch.Tensor:
    """d Log(exp(w^) R) / d w at w = 0, i.e. J_l^{-1}(Log(R))."""
    return lie.so3_inverse_left_jacobian(lie.so3_log(R))

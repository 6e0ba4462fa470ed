"""Pose-only Gauss-Newton PnP refinement (port of
maveric_slam_tpu/geometry/pnp.py)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class PnPResult(NamedTuple):
    R: torch.Tensor  # (..., 3, 3)
    t: torch.Tensor  # (..., 3)
    cost: torch.Tensor  # (...) final robust cost
    num_used: torch.Tensor  # (...) int32 factors with weight > 0


def refine_pose(K, R0, t0, X, z, mask, huber_delta: float = 2.0,
                damping: float = 1e-4, iterations: int = 8) -> PnPResult:
    """Minimize sum_i huber(|pi(R X_i + t) - z_i|) over (R, t) with a fixed
    number of damped Gauss-Newton steps (X (..., N, 3), z (..., N, 2),
    mask (..., N); one pose per leading index).
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (ops/kernels/refine_pose.py)."""
    from ..ops.kernels.refine_pose import refine_pose as kernel

    return kernel(K, R0, t0, X, z, mask, huber_delta, damping, iterations)

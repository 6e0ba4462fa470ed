"""Batched pose-only Gauss-Newton PnP (CUDA `csrc/refine_pose.cu`) and its
plain PyTorch version.

No TPU kernel: the JAX package runs this loop as jnp under jit
(maveric_slam_tpu/geometry/pnp.py refine_pose); the plain version is its
port, and the kernel runs all of its iterations in one launch.
"""

from __future__ import annotations

import torch

from ...geometry import projection
from ...geometry.pnp import PnPResult
from ..lie import se3_exp
from ..linalg import cholesky_small, cholesky_solve_small
from . import _build

launches = 0  # kernel launches since the last reset (see ops.kernels)


def refine_pose_plain(K, R0, t0, X, z, mask, huber_delta: float = 2.0,
                      damping: float = 1e-4, iterations: int = 8) -> PnPResult:
    """Minimize sum_i huber(|pi(R X_i + t) - z_i|) over (R, t) with a fixed
    number of damped Gauss-Newton steps (X (..., N, 3), z (..., N, 2),
    mask (..., N); one pose per leading index)."""
    w_valid = mask.to(torch.float32)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    R, t = R0, t0
    for _ in range(iterations):
        r, J_pose, _ = projection.residual_and_jacobians(K, R, t, X, z)
        w = projection.huber_weights(r, huber_delta) * w_valid
        # J^T W J and -J^T W r as batched matrix products over the 2N rows:
        # the same products per pose whatever the batch (einsum's contraction
        # path, and so its rounding, changes with the batch shape).
        J = J_pose.flatten(-3, -2)  # (..., 2N, 6)
        Jw = (J * w.repeat_interleave(2, dim=-1)[..., None]).transpose(-1, -2)
        H = Jw @ J + damping * eye6
        b = -(Jw @ r.flatten(-2)[..., None])[..., 0]
        xi = cholesky_solve_small(cholesky_small(H), b)
        dR, dt = se3_exp(xi)
        R, t = dR @ R, (dR @ t[..., None])[..., 0] + dt
    r, _, _ = projection.residual_and_jacobians(K, R, t, X, z)
    w = projection.huber_weights(r, huber_delta) * w_valid
    cost = torch.sum(w * torch.sum(r * r, dim=-1), dim=-1)
    return PnPResult(R=R, t=t, cost=cost, num_used=torch.sum(mask, dim=-1).to(torch.int32))


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, shape: tuple) -> None:
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} must have shape {shape}, got {tuple(x.shape)}")


def refine_pose(K, R0, t0, X, z, mask, huber_delta: float = 2.0,
                damping: float = 1e-4, iterations: int = 8) -> PnPResult:
    """K (3, 3), R0 (..., 3, 3), t0 (..., 3), X (..., N, 3), z (..., N, 2)
    f32 and mask (..., N) bool -> PnPResult with leading dims (...).
    CPU tensors take the plain version; CUDA tensors launch the kernel (one
    launch for every pose of the call), all on one device and contiguous."""
    if X.ndim < 2 or X.shape[-1] != 3:
        raise ValueError(f"X must be (..., N, 3), got {tuple(X.shape)}")
    batch, n = tuple(X.shape[:-2]), X.shape[-2]
    _check("K", K, torch.float32, (3, 3))
    _check("R0", R0, torch.float32, batch + (3, 3))
    _check("t0", t0, torch.float32, batch + (3,))
    _check("X", X, torch.float32, batch + (n, 3))
    _check("z", z, torch.float32, batch + (n, 2))
    _check("mask", mask, torch.bool, batch + (n,))
    tensors = {"K": K, "R0": R0, "t0": t0, "X": X, "z": z, "mask": mask}
    devices = {x.device for x in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"the inputs lie on more than one device: {sorted(map(str, devices))}")
    if X.device.type == "cpu":
        return refine_pose_plain(K, R0, t0, X, z, mask, huber_delta, damping, iterations)
    if X.device.type != "cuda":
        raise ValueError(f"unsupported device {X.device}")
    for name, x in tensors.items():
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    s = R0.numel() // 9
    R = torch.empty(batch + (3, 3), dtype=torch.float32, device=X.device)
    t = torch.empty(batch + (3,), dtype=torch.float32, device=X.device)
    cost = torch.empty(batch, dtype=torch.float32, device=X.device)
    num_used = torch.empty(batch, dtype=torch.int32, device=X.device)
    global launches
    with torch.cuda.device(X.device):
        err = _build.library().refine_pose(
            K.data_ptr(), R0.data_ptr(), t0.data_ptr(), X.data_ptr(), z.data_ptr(),
            mask.data_ptr(), s, n, huber_delta, damping, iterations, R.data_ptr(),
            t.data_ptr(), cost.data_ptr(), num_used.data_ptr(), _build.stream_of(X))
    _build.check(err, "refine_pose")
    launches += 1
    return PnPResult(R=R, t=t, cost=cost, num_used=num_used)

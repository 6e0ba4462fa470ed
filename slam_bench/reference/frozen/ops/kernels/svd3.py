"""Batched signed 3x3 SVD (CUDA `csrc/svd3.cu`) and its plain PyTorch
version.

Port of maveric_slam_tpu/ops/pallas_kernels.py svd3_pallas; the plain
version is the port of maveric_slam_tpu/ops/svd3.py svd3_ref.
"""

from __future__ import annotations

import math

import torch



JACOBI_SWEEPS = 6
_EPS = 1e-12
# Jacobi rotation constants (McAdams et al. 2011, sec. 2.1), evaluated in
# f32 as the JAX package's jnp constants are (csrc/svd3.cu uses the same bits).
_F32_2 = torch.tensor(2.0, dtype=torch.float32)
_F32_PI_8 = torch.tensor(math.pi, dtype=torch.float32) / 8.0
_GAMMA = float(3.0 + 2.0 * torch.sqrt(_F32_2))
_COS_PI_8 = float(torch.cos(_F32_PI_8))
_SIN_PI_8 = float(torch.sin(_F32_PI_8))


def _jacobi_rotation(app, aqq, apq):
    ch = 2.0 * (app - aqq)
    sh = apq
    use_big = _GAMMA * sh * sh < ch * ch
    w = torch.where(use_big, 1.0 / torch.sqrt(torch.clamp(ch * ch + sh * sh, min=_EPS)),
                    torch.zeros_like(ch))
    ch_half = torch.where(use_big, w * ch, torch.full_like(ch, _COS_PI_8))
    sh_half = torch.where(use_big, w * sh, torch.full_like(sh, _SIN_PI_8))
    n = ch_half * ch_half + sh_half * sh_half
    c = (ch_half * ch_half - sh_half * sh_half) / n
    s = (2.0 * ch_half * sh_half) / n
    return c, s


def _apply_jacobi(S, V, p, q):
    c, s = _jacobi_rotation(S[..., p, p], S[..., q, q], S[..., p, q])
    G = torch.eye(3, dtype=S.dtype, device=S.device).expand(S.shape).clone()
    G[..., p, p] = c
    G[..., q, q] = c
    G[..., p, q] = -s
    G[..., q, p] = s
    return G.transpose(-1, -2) @ S @ G, V @ G


def _sort_columns_desc(B, V):
    """Sort columns by descending norm with conditional swaps that negate
    the moved column, keeping det V = +1."""
    B, V = B.clone(), V.clone()

    def cond_swap(i, j):
        do = (torch.sum(B[..., :, i] ** 2, -1) < torch.sum(B[..., :, j] ** 2, -1))[..., None]
        for M in (B, V):
            mi, mj = M[..., :, i].clone(), M[..., :, j].clone()
            M[..., :, i] = torch.where(do, mj, mi)
            M[..., :, j] = torch.where(do, -mi, mj)

    cond_swap(0, 1)
    cond_swap(0, 2)
    cond_swap(1, 2)
    return B, V


def _unit(i: int, like: torch.Tensor) -> torch.Tensor:
    e = torch.zeros_like(like)
    e[..., i] = 1.0
    return e


def svd3_plain(A: torch.Tensor):
    """Signed SVD of (..., 3, 3): U, s, V with A == U diag(s) V^T, U and V
    proper rotations, |s0| >= |s1| >= |s2|, s2 signed."""
    S = A.transpose(-1, -2) @ A
    V = torch.eye(3, dtype=A.dtype, device=A.device).expand(S.shape).clone()
    for _ in range(JACOBI_SWEEPS):
        S, V = _apply_jacobi(S, V, 0, 1)
        S, V = _apply_jacobi(S, V, 0, 2)
        S, V = _apply_jacobi(S, V, 1, 2)

    B = A @ V
    B, V = _sort_columns_desc(B, V)

    s0 = torch.linalg.vector_norm(B[..., :, 0], dim=-1)
    s1 = torch.linalg.vector_norm(B[..., :, 1], dim=-1)

    u0 = B[..., :, 0] / torch.clamp(s0, min=_EPS)[..., None]
    u0 = torch.where((s0 > 1e-8)[..., None], u0, _unit(0, u0))

    b1 = B[..., :, 1]
    b1 = b1 - torch.sum(b1 * u0, dim=-1, keepdim=True) * u0
    b1_norm = torch.linalg.vector_norm(b1, dim=-1)
    ax = torch.abs(u0)
    alt = torch.where(
        (ax[..., 0:1] <= ax[..., 1:2]) & (ax[..., 0:1] <= ax[..., 2:3]),
        _unit(0, u0),
        torch.where(ax[..., 1:2] <= ax[..., 2:3], _unit(1, u0), _unit(2, u0)),
    )
    alt = torch.linalg.cross(u0, alt)
    alt = alt / torch.clamp(torch.linalg.vector_norm(alt, dim=-1, keepdim=True), min=_EPS)
    u1 = torch.where((b1_norm > 1e-8)[..., None],
                     b1 / torch.clamp(b1_norm, min=_EPS)[..., None], alt)
    u2 = torch.linalg.cross(u0, u1)
    s2 = torch.sum(B[..., :, 2] * u2, dim=-1)
    return torch.stack([u0, u1, u2], dim=-1), torch.stack([s0, s1, s2], dim=-1), V


def svd3(A: torch.Tensor):
    """(..., 3, 3) f32 -> U (..., 3, 3), s (..., 3), V (..., 3, 3).
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if A.ndim < 2 or A.shape[-2:] != (3, 3):
        raise ValueError(f"A must be (..., 3, 3), got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise TypeError(f"A must be float32, got {A.dtype}")
    return svd3_plain(A)
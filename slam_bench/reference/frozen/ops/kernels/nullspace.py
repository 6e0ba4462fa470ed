"""Batched smallest-eigenvector solve (CUDA `csrc/nullspace.cu`) and its
plain PyTorch version.

Port of maveric_slam_tpu/ops/pallas_kernels.py nullspace_inverse_iteration.
"""

from __future__ import annotations

import torch

from ..linalg import cholesky_small, cholesky_solve_small

SIZES = (4, 9)  # matrix sizes the kernel is instantiated for


def nullspace_plain(A: torch.Tensor, iterations: int = 10) -> torch.Tensor:
    """The jnp path of smallest_eigvec_inverse_iteration (linalg.py:198-207):
    trace-shifted Cholesky, then `iterations` solve-and-normalize rounds."""
    n = A.shape[-1]
    tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
    delta = 1e-7 * torch.clamp(tr, min=1e-30) / n
    M = A + delta[..., None, None] * torch.eye(n, dtype=A.dtype, device=A.device)
    L = cholesky_small(M)
    x = torch.ones(A.shape[:-1], dtype=A.dtype, device=A.device) / torch.sqrt(
        torch.tensor(float(n), dtype=A.dtype))
    for _ in range(iterations):
        x = cholesky_solve_small(L, x)
        x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-30)
    return x


def nullspace_inverse_iteration(A: torch.Tensor, iterations: int = 10) -> torch.Tensor:
    """(..., n, n) f32 symmetric PSD -> (..., n) unit smallest eigenvectors.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (n in SIZES)."""
    if A.ndim < 2 or A.shape[-1] != A.shape[-2]:
        raise ValueError(f"A must be (..., n, n), got {tuple(A.shape)}")
    if A.dtype != torch.float32:
        raise TypeError(f"A must be float32, got {A.dtype}")
    return nullspace_plain(A, iterations)
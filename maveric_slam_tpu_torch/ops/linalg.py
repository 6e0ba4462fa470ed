"""Small batched linear algebra (port of maveric_slam_tpu/ops/linalg.py, the
parts the tracking step uses). Batches are (..., n, n)."""

from __future__ import annotations

import torch


def apply_rows(X: torch.Tensor, A: torch.Tensor) -> torch.Tensor:
    """X @ A^T for row vectors X (..., N, k) and small matrices A (..., m, k),
    as products and sums in a fixed order: each row's rounding is the same
    whatever the batch shape. (A matmul's kernel, and with it the rounding,
    changes with the batch shape; in the ill-conditioned pose refinement
    that moves a stream's pose by up to 1e-3 between batch sizes.)"""
    Ab = A[..., None, :, :]
    out = X[..., 0, None] * Ab[..., 0]
    for j in range(1, X.shape[-1]):
        out = out + X[..., j, None] * Ab[..., j]
    return out


def cholesky_small(A: torch.Tensor) -> torch.Tensor:
    """Unrolled batched Cholesky for small n, pivots sqrt(max(s, 1e-30))."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp(s, min=1e-30))
            else:
                L[i][j] = s / L[j][j]
    zero = torch.zeros_like(A[..., 0, 0])
    rows = [torch.stack([L[i][j] if j <= i else zero for j in range(n)], dim=-1)
            for i in range(n)]
    return torch.stack(rows, dim=-2)


def cholesky_solve_small(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L L^T x = b with unrolled forward/back substitution (batched)."""
    n = L.shape[-1]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[..., i, k] * y[k]
        y[i] = s / L[..., i, i]
    x = [None] * n
    for i in range(n - 1, -1, -1):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[..., k, i] * x[k]
        x[i] = s / L[..., i, i]
    return torch.stack(x, dim=-1)


def smallest_eigvec_inverse_iteration(A: torch.Tensor, iterations: int = 10) -> torch.Tensor:
    """Smallest eigenvector of symmetric PSD A (..., n, n) -> (..., n).

    Runs the CUDA kernel for CUDA tensors and its plain version for CPU
    tensors (ops/kernels/nullspace.py)."""
    from .kernels.nullspace import nullspace_inverse_iteration

    return nullspace_inverse_iteration(A, iterations)

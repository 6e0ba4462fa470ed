"""Small batched linear algebra (port of maveric_slam_tpu/ops/linalg.py).
Batches are (..., n, n). The JAX package's functions here are `jnp` code
outside any Pallas kernel, so they are plain PyTorch, except the smallest
eigenvector by inverse iteration, which is the nullspace kernel."""

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


def inv3x3(M: torch.Tensor, damping=0.0) -> torch.Tensor:
    """Analytic inverse of (..., 3, 3) matrices by the adjugate, after adding
    `damping` (a float or a () tensor) to the diagonal; |det| < 1e-20 is
    replaced by 1e-20."""
    M = M + damping * torch.eye(3, dtype=M.dtype, device=M.device)
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, 1e-20, det)
    cof = torch.stack([
        A, -(b * i - c * h), (b * f - c * e),
        B, (a * i - c * g), -(a * f - c * d),
        C, -(a * h - b * g), (a * e - b * d),
    ], dim=-1).reshape(M.shape)
    return cof * inv_det[..., None, None]


def solve_psd(A: torch.Tensor, b: torch.Tensor, damping: float = 0.0) -> torch.Tensor:
    """Solve A x = b for symmetric positive-definite A (..., n, n), b
    (..., n), by Cholesky and two triangular solves; `damping` is added to
    the diagonal first."""
    if damping:
        A = A + damping * torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    L = torch.linalg.cholesky(A)
    y = torch.linalg.solve_triangular(L, b[..., None], upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)[..., 0]


def block_diag_inv(blocks: torch.Tensor, damping: float = 0.0) -> torch.Tensor:
    """Invert a batch of 3x3 diagonal blocks (L, 3, 3), e.g. the landmark
    Hessian blocks, after adding `damping` to their diagonals."""
    return inv3x3(blocks, damping=damping)


def jacobi_eigh(A: torch.Tensor, sweeps: int = 6):
    """Symmetric eigendecomposition of (..., n, n) by cyclic Jacobi
    rotations: `sweeps` passes over the pivot pairs (p, q), p < q, in row
    order, each rotation applied as A <- G^T A G, V <- V G with the stable
    angle of Golub & Van Loan 8.4.1 (sgn(0) = +1; no rotation where
    |a_pq| <= 1e-30). Returns (w, V), eigenvalues ascending (a stable
    sort), A = V diag(w) V^T."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    V = eye.expand(A.shape).clone()
    for _ in range(sweeps):
        for p in range(n - 1):
            for q in range(p + 1, n):
                app, aqq, apq = A[..., p, p], A[..., q, q], A[..., p, q]
                safe = torch.abs(apq) > 1e-30
                tau = (aqq - app) / torch.where(safe, 2.0 * apq, 1.0)
                sgn = torch.where(tau >= 0, 1.0, -1.0)
                t = sgn / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
                t = torch.where(safe, t, 0.0)
                c = 1.0 / torch.sqrt(1.0 + t * t)
                s = t * c
                G = eye.expand(A.shape).clone()
                G[..., p, p] = c
                G[..., q, q] = c
                G[..., p, q] = s
                G[..., q, p] = -s
                A = G.transpose(-1, -2) @ A @ G
                V = V @ G
    w = torch.diagonal(A, dim1=-2, dim2=-1)
    order = torch.argsort(w, dim=-1, stable=True)
    return (torch.take_along_dim(w, order, dim=-1),
            torch.take_along_dim(V, order[..., None, :], dim=-1))


def smallest_eigvec_sym(A: torch.Tensor, refine_steps: int = 0) -> torch.Tensor:
    """Unit eigenvector (..., n) of the smallest eigenvalue of symmetric A
    (..., n, n), by `jacobi_eigh`; `refine_steps` steps of inverse power
    iteration shifted to w0 - 1e-6 tr(A) refine it."""
    n = A.shape[-1]
    w, v = jacobi_eigh(A)
    x = v[..., :, 0]
    if refine_steps:
        tr = torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)
        shift = w[..., 0] - 1e-6 * tr
        M = A - shift[..., None, None] * torch.eye(n, dtype=A.dtype, device=A.device)
        for _ in range(refine_steps):
            x = torch.linalg.solve(M, x[..., :, None])[..., 0]
            x = x / torch.clamp(torch.linalg.vector_norm(x, dim=-1, keepdim=True), min=1e-30)
    return x


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

"""Batched signed 3x3 SVD and the polar decomposition (port of
maveric_slam_tpu/ops/svd3.py).

`svd3` launches the CUDA kernel for CUDA tensors and runs `svd3_ref`, the
plain PyTorch version, for CPU tensors. Contract: U, V proper rotations,
|s0| >= |s1| >= |s2|, s2 carries sign(det A), A == U diag(s) V^T.
"""

import torch

from .kernels.svd3 import svd3, svd3_plain as svd3_ref

__all__ = ["polar_decomposition", "svd3", "svd3_ref"]


def polar_decomposition(A: torch.Tensor):
    """A = R @ P with R a rotation and P symmetric (PSD where det A > 0),
    from one `svd3` (the kernel on a CUDA tensor): R = U V^T,
    P = V diag(s) V^T."""
    U, s, V = svd3(A)
    Vt = V.transpose(-1, -2)
    return U @ Vt, V @ (s[..., :, None] * Vt)

"""Batched signed 3x3 SVD (port of maveric_slam_tpu/ops/svd3.py).

`svd3` launches the CUDA kernel for CUDA tensors and runs `svd3_ref`, the
plain PyTorch version, for CPU tensors. Contract: U, V proper rotations,
|s0| >= |s1| >= |s2|, s2 carries sign(det A), A == U diag(s) V^T.
"""

from .kernels.svd3 import svd3, svd3_plain as svd3_ref

__all__ = ["svd3", "svd3_ref"]

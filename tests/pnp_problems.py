"""Seeded pose-refinement problems for the refine_pose tests, on the CPU.

Imported by tests/test_torch_refine_pose_kernel.py (against the JAX
package) and tests/test_torch_cuda.py (the kernel on the card), so it
imports neither JAX nor the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

K = ((400.0, 0.0, 160.0), (0.0, 400.0, 48.0), (0.0, 0.0, 1.0))  # the 96x320 camera


def rotation(w) -> np.ndarray:
    """Rodrigues: the rotation by the axis-angle vector w (nonzero)."""
    th = np.linalg.norm(w)
    W = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    return np.eye(3) + np.sin(th) * W + (1 - np.cos(th)) * W @ W


def pnp_problem(s: int, n: int, seed: int):
    """S problems as the tracker poses them: points 4-30 m ahead, pixel
    noise of 0.5 px, a tenth of them outliers by up to 30 px, a tenth
    masked, and the initial pose off by ~0.03 rad and ~0.05 m. Returns CPU
    tensors (K, R0, t0, X, z) in float32 and mask in bool."""
    rng = np.random.default_rng(seed)
    Kn = np.array(K)
    R0, t0, X, z, mask = [], [], [], [], []
    for _ in range(s):
        R = rotation(rng.normal(scale=0.05, size=3))
        t = np.array([0.1, 0.02, 1.0]) + rng.normal(scale=0.05, size=3)
        pts = np.stack([rng.uniform(-5, 5, n), rng.uniform(-2, 2, n), rng.uniform(4, 30, n)], -1)
        p = pts @ R.T + t
        uv = p[:, :2] / p[:, 2:] * Kn[0, 0] + Kn[:2, 2] + rng.normal(scale=0.5, size=(n, 2))
        out = rng.random(n) < 0.1
        uv[out] += rng.uniform(-30, 30, size=(int(out.sum()), 2))
        R0.append(rotation(rng.normal(scale=0.03, size=3)) @ R)
        t0.append(t + rng.normal(scale=0.05, size=3))
        X.append(pts)
        z.append(uv)
        mask.append(rng.random(n) >= 0.1)
    f32 = (torch.from_numpy(np.asarray(a, np.float32)) for a in (Kn, R0, t0, X, z))
    return (*f32, torch.from_numpy(np.asarray(mask)))

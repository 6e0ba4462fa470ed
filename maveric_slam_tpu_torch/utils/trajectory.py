"""Trajectory composition and IO.

Replaces the reference's offline tooling (python/compute_trajectory.py,
python/compute_pairwise_diff.py) with correct compounding: the reference
composed translations *without* rotating them
(compute_trajectory.py:76-77, `t <- t_rel + t`), which is only valid for
identity rotations; here poses compose on SE(3) properly.

Conventions:
- A camera pose is T_w_c (camera-to-world), KITTI format (outputs/00.txt).
- A relative measurement (R, t) from pairwise/tracking maps cam_i points to
  cam_j points: p_j = R p_i + t, i.e. T_cj_ci.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np


def compose_trajectory(
    rel_R: Sequence[np.ndarray], rel_t: Sequence[np.ndarray]
) -> np.ndarray:
    """Chain relative cam-to-cam transforms into global poses T_w_ci.

    rel_R[i], rel_t[i]: T_c(i+1)_c(i). Starts at identity. Returns
    (N+1, 4, 4) cam-to-world poses.
    """
    n = len(rel_R)
    poses = np.zeros((n + 1, 4, 4))
    poses[0] = np.eye(4)
    T_w_c = np.eye(4)
    for i in range(n):
        T_rel = np.eye(4)
        T_rel[:3, :3] = rel_R[i]
        T_rel[:3, 3] = rel_t[i]
        # T_w_c(i+1) = T_w_ci @ inv(T_c(i+1)_ci)
        T_w_c = T_w_c @ np.linalg.inv(T_rel)
        poses[i + 1] = T_w_c
    return poses


def relative_from_poses(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """T_c(i+1)_ci for consecutive cam-to-world poses (N, 4, 4)."""
    rel = np.einsum("nij,njk->nik", np.linalg.inv(poses[1:]), poses[:-1])
    return rel[:, :3, :3], rel[:, :3, 3]


def save_kitti_poses(path: str, poses: np.ndarray) -> None:
    """Write (N, 4, 4) poses in KITTI 3x4 row-major format."""
    with open(path, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.6e}" for v in T[:3, :].reshape(-1)) + "\n")


def write_ply(path: str, points: np.ndarray) -> None:
    """Polyline PLY of a trajectory (capability of compute_trajectory.py:6-43)."""
    n = len(points)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {n}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element edge {max(n - 1, 0)}\n")
        f.write("property int vertex1\nproperty int vertex2\nend_header\n")
        for i, p in enumerate(points):
            color = (255, 0, 0) if i == 0 else ((0, 0, 0) if i == n - 1 else (0, 0, 255))
            f.write(f"{p[0]} {p[1]} {p[2]} {color[0]} {color[1]} {color[2]}\n")
        for i in range(n - 1):
            f.write(f"{i} {i + 1}\n")

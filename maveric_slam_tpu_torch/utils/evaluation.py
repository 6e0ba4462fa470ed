"""Trajectory evaluation: ATE and RPE against KITTI ground truth (the port's
own copy of maveric_slam_tpu/utils/evaluation.py).

The accuracy currency of the whole project (BASELINE.md: "KITTI seq 00
tracked end-to-end at ATE parity"). The reference has no evaluator — its
'evaluation' is eyeballing PLY files; this implements the standard metrics.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def umeyama_alignment(
    src: np.ndarray, dst: np.ndarray, with_scale: bool = True
):
    """Least-squares similarity transform aligning src -> dst ((N, 3) each).

    Returns (s, R, t) with dst ~ s R src + t.
    """
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate(
    est_poses: np.ndarray, gt_poses: np.ndarray, align_scale: bool = True
) -> Dict[str, float]:
    """Absolute trajectory error after Sim(3) (monocular) alignment.

    est_poses, gt_poses: (N, 4, 4) cam-to-world. Monocular pipelines are
    scale-free, so Sim(3) alignment is standard.
    """
    p_est = est_poses[:, :3, 3]
    p_gt = gt_poses[:, :3, 3]
    s, R, t = umeyama_alignment(p_est, p_gt, with_scale=align_scale)
    aligned = (s * (R @ p_est.T)).T + t
    err = np.linalg.norm(aligned - p_gt, axis=-1)
    return {
        "ate_rmse": float(np.sqrt((err**2).mean())),
        "ate_mean": float(err.mean()),
        "ate_median": float(np.median(err)),
        "ate_max": float(err.max()),
        "scale": float(s),
    }


def rpe(
    est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1
) -> Dict[str, float]:
    """Relative pose error over `delta`-frame intervals (rotation deg,
    translation direction deg, translation magnitude ratio)."""
    def rel(poses):
        return np.einsum(
            "nij,njk->nik", np.linalg.inv(poses[:-delta]), poses[delta:]
        )

    e = rel(est_poses)
    g = rel(gt_poses)
    d = np.einsum("nij,njk->nik", np.linalg.inv(g), e)
    # Rotation error.
    tr = np.clip((np.trace(d[:, :3, :3], axis1=1, axis2=2) - 1) / 2, -1, 1)
    rot_deg = np.degrees(np.arccos(tr))
    # Translation direction error between est and gt steps.
    te = e[:, :3, 3]
    tg = g[:, :3, 3]
    ne = np.linalg.norm(te, axis=-1)
    ng = np.linalg.norm(tg, axis=-1)
    valid = (ne > 1e-9) & (ng > 1e-9)
    cosang = np.clip(
        np.sum(te * tg, axis=-1)[valid] / (ne[valid] * ng[valid]), -1, 1
    )
    dir_deg = np.degrees(np.arccos(cosang))
    return {
        "rpe_rot_deg_mean": float(rot_deg.mean()),
        "rpe_rot_deg_max": float(rot_deg.max()),
        "rpe_tdir_deg_mean": float(dir_deg.mean()) if len(dir_deg) else float("nan"),
        "rpe_tdir_deg_median": float(np.median(dir_deg)) if len(dir_deg) else float("nan"),
    }

"""Visualization (the port's copy of the parts of
maveric_slam_tpu/utils/visualization.py its entry points use): match
overlays and top-down trajectory plots written as PNGs. cv2 and matplotlib
are imported only when drawing."""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def _to_bgr(img: np.ndarray) -> np.ndarray:
    import cv2

    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return cv2.cvtColor(u8, cv2.COLOR_GRAY2BGR)


def draw_matches(
    img0: np.ndarray,
    img1: np.ndarray,
    xy0: np.ndarray,
    xy1: np.ndarray,
    mask: Optional[np.ndarray] = None,
    out_path: Optional[str] = None,
) -> np.ndarray:
    """Side-by-side correspondences: img0 left, img1 right, one line per
    match (in a seeded random colour), written to `out_path` if given."""
    import cv2

    c0, c1 = _to_bgr(img0), _to_bgr(img1)
    w = img0.shape[1]
    canvas = np.concatenate([c0, c1], axis=1)
    rng = np.random.default_rng(0)
    for i in range(len(xy0)):
        if mask is not None and not mask[i]:
            continue
        color = tuple(int(v) for v in rng.integers(64, 255, 3))
        p0 = (int(round(xy0[i, 0])), int(round(xy0[i, 1])))
        p1 = (int(round(xy1[i, 0])) + w, int(round(xy1[i, 1])))
        cv2.circle(canvas, p0, 2, color, -1)
        cv2.circle(canvas, p1, 2, color, -1)
        cv2.line(canvas, p0, p1, color, 1, lineType=cv2.LINE_AA)
    if out_path:
        cv2.imwrite(out_path, canvas)
    return canvas


def plot_trajectories(trajectories: List[Tuple[str, np.ndarray]], out_path: str) -> None:
    """Top-down (x, z) plot of named (N, 4, 4) pose arrays, written to
    `out_path`."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 8))
    for name, poses in trajectories:
        p = poses[:, :3, 3]
        ax.plot(p[:, 0], p[:, 2], label=name, marker=".", markersize=3)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("z [m]")
    ax.axis("equal")
    ax.legend()
    ax.grid(True, alpha=0.3)
    fig.savefig(out_path, dpi=120, bbox_inches="tight")
    plt.close(fig)

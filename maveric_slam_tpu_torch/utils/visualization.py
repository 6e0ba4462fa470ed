"""Visualization (port of maveric_slam_tpu/utils/visualization.py):
keypoint, match, track and epipolar-line overlays and top-down trajectory
plots, returned as BGR arrays and written as PNGs. The capability of the
reference's plotting scripts (python/draw_features.py,
python/plot_feature_correspondance.py, PointTracker.draw_tracks at
superpoint_inference.py:426-457, the epilines of pairwise_pnp.py:548-575).
cv2 and matplotlib are imported only when drawing."""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

# The reference's jet ramp for track-confidence colours
# (pairwise_pnp.py:21-30), as BGR uint8.
_JET = (
    np.array(
        [
            [0.5, 0.0, 0.0], [1.0, 0.0, 0.0], [1.0, 0.38, 0.0],
            [1.0, 0.83, 0.0], [0.67, 1.0, 0.3], [0.3, 1.0, 0.67],
            [0.0, 0.9, 1.0], [0.0, 0.48, 1.0], [0.0, 0.07, 1.0],
            [0.0, 0.0, 0.5],
        ]
    )
    * 255
).astype(np.uint8)


def _to_bgr(img: np.ndarray) -> np.ndarray:
    import cv2

    u8 = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return cv2.cvtColor(u8, cv2.COLOR_GRAY2BGR)


def draw_features(
    img: np.ndarray,
    xy: np.ndarray,
    mask: Optional[np.ndarray] = None,
    color: Tuple[int, int, int] = (0, 255, 0),
    out_path: Optional[str] = None,
) -> np.ndarray:
    """Keypoint overlay: a filled dot at each (masked-in) xy, written to
    `out_path` if given."""
    import cv2

    canvas = _to_bgr(img)
    for i in range(len(xy)):
        if mask is not None and not mask[i]:
            continue
        cv2.circle(canvas, (int(round(xy[i, 0])), int(round(xy[i, 1]))), 2, color, -1)
    if out_path:
        cv2.imwrite(out_path, canvas)
    return canvas


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


def draw_tracks(
    img: np.ndarray,
    tracks: Sequence[Tuple[int, Sequence]],
    scores: Optional[dict] = None,
    out_path: Optional[str] = None,
) -> np.ndarray:
    """Track polylines (`TrackTable.get_tracks()`: (id, observations)),
    coloured on the jet ramp by each track's score (0.5 when absent), with
    a red dot at each track's newest point."""
    import cv2

    canvas = _to_bgr(img)
    for tid, obs in tracks:
        score = (scores or {}).get(tid, 0.5)
        clr = tuple(int(v) for v in _JET[int(np.clip(score * 10, 0, 9))])
        pts = [(int(round(o.xy[0])), int(round(o.xy[1]))) for o in obs]
        for a, b in zip(pts[:-1], pts[1:]):
            cv2.line(canvas, a, b, clr, 1, lineType=cv2.LINE_AA)
        if pts:
            cv2.circle(canvas, pts[-1], 2, (0, 0, 255), -1)
    if out_path:
        cv2.imwrite(out_path, canvas)
    return canvas


def draw_epilines(
    img0: np.ndarray,
    img1: np.ndarray,
    xy0: np.ndarray,
    xy1: np.ndarray,
    F: np.ndarray,
    out_path: Optional[str] = None,
) -> np.ndarray:
    """Epipolar lines side by side: on img0 the lines of xy1's points, on
    img1 those of xy0's (fundamental matrix F, x1^T F x0 = 0), each with
    its point, in seeded random colours."""
    import cv2

    c0, c1 = _to_bgr(img0), _to_bgr(img1)
    w = img0.shape[1]
    rng = np.random.default_rng(1)

    def lines_on(canvas, lines, pts):
        for l, p in zip(lines, pts):
            color = tuple(int(v) for v in rng.integers(64, 255, 3))
            if abs(l[1]) < 1e-9:
                continue
            x0, y0 = 0, int(-l[2] / l[1])
            x1, y1 = w, int(-(l[2] + l[0] * w) / l[1])
            cv2.line(canvas, (x0, y0), (x1, y1), color, 1)
            cv2.circle(canvas, (int(p[0]), int(p[1])), 4, color, -1)

    ones = np.ones((len(xy0), 1))
    lines_on(c0, np.hstack([xy1, ones]) @ F, xy0)  # lines in image 0 of points in 1
    lines_on(c1, np.hstack([xy0, ones]) @ F.T, xy1)  # lines in image 1 of points in 0
    canvas = np.concatenate([c0, c1], axis=1)
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

"""Configuration system for the SLAM engine.

The reference hardcodes every knob as a compile-time #define and even ships
two inconsistent camera matrices (reference: src/tracking_main.c:205 uses a
TUM-style K while python/pairwise_pnp.py:667 uses the KITTI K) and never
rescales intrinsics for the 192x640 resize (python/pairwise_pnp.py:624).
Here everything is a frozen dataclass, and intrinsics are rescaled for the
working resolution exactly once, in one place.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """Pinhole intrinsics at the *native* dataset resolution."""

    fx: float = 718.856
    fy: float = 718.856
    cx: float = 607.1928
    cy: float = 185.2157
    width: int = 1241
    height: int = 376

    def rescaled(self, new_width: int, new_height: int) -> "CameraConfig":
        """Intrinsics after resizing the image to (new_height, new_width).

        The reference forgets this step entirely; we scale focal lengths and
        principal point by the per-axis resize ratio.
        """
        sx = new_width / self.width
        sy = new_height / self.height
        return CameraConfig(
            fx=self.fx * sx,
            fy=self.fy * sy,
            cx=self.cx * sx,
            cy=self.cy * sy,
            width=new_width,
            height=new_height,
        )

    @property
    def K(self) -> np.ndarray:
        return np.array(
            [[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
            dtype=np.float32,
        )


# KITTI odometry sequence 00, grayscale camera 0 (values match the golden
# pipeline, reference: python/pairwise_pnp.py:667-669).
KITTI_00_CAMERA = CameraConfig()


@dataclasses.dataclass(frozen=True)
class FrontendConfig:
    """SuperPoint feature extraction + post-processing.

    Sizes mirror the reference envelope (BASELINE.md): 192x640 input,
    24x80 cell grid, 65 semi channels, 256 descriptor channels.
    """

    height: int = 192
    width: int = 640
    cell: int = 8  # output stride of the SuperPoint encoder
    conf_thresh: float = 0.015  # reference: python/pairwise_pnp.py:591
    nms_dist: int = 4  # reference: python/pairwise_pnp.py:589
    border_remove: int = 4  # reference: python/pairwise_pnp.py:99
    max_keypoints: int = 1000  # fixed capacity for TPU shapes
    top_n: int = 100  # reference: src/tracking_main.c:14
    # "prob" keeps the N strongest cells; "reference" reproduces the C
    # scan-order selection (top_N.c:108-131), which spatially biases
    # features to the leftmost columns when over-subscribed.
    top_n_mode: str = "prob"
    valid_prob_thresh: float = 0.01  # reference: src/top_N.c:76
    exp_taylor_degree: int = 5  # reference: src/top_N.c:7

    @property
    def grid_h(self) -> int:
        return self.height // self.cell

    @property
    def grid_w(self) -> int:
        return self.width // self.cell

    @property
    def num_cells(self) -> int:
        return self.grid_h * self.grid_w


@dataclasses.dataclass(frozen=True)
class MatcherConfig:
    """Windowed quantized descriptor matching (reference: src/tracking_main.c)."""

    match_threshold: float = 0.8  # cosine sim; reference used 0.9 (tracking_main.c:12) but never ran its tracker — 0.8 measured 5x more inliers on KITTI
    max_matches: int = 150  # reference: tracking_main.c:13
    window_shift: Tuple[int, int] = (0, 0)  # grid cells; reference used (4,4)
    window_radius: int = 4  # grid cells (reference: tracking_main.c:106)
    min_prob: float = 0.1  # reference used 0.2 (tracking_main.c:147); 0.1 measured better recall
    nn_thresh: float = 0.7  # float L2 match (reference: pairwise_pnp.py:593)
    dot_thresh: float = 0.8  # golden O(N^2) match (reference: pairwise_pnp.py:648)


@dataclasses.dataclass(frozen=True)
class LightGlueConfig:
    """LightGlue, the learned matcher of the pairwise path (models/lightglue.py):
    the `superpoint` settings of cvg/LightGlue's `default_conf`
    (arXiv:2306.13643). Its published weights are not in the repository, so
    the weights are drawn from `weights_seed`; adaptive depth and width need
    them, so both confidences are -1 (off), the only value the model takes
    (published: depth_confidence 0.95, width_confidence 0.99). Not a field
    of SlamConfig, which stays the JAX package's twin (the JAX package has
    no learned matcher); pass it to the model."""

    input_dim: int = 256
    descriptor_dim: int = 256
    n_layers: int = 9
    num_heads: int = 4  # a head is descriptor_dim / num_heads = 64 wide
    filter_threshold: float = 0.1  # a match needs exp(log-assignment) above it
    depth_confidence: float = -1.0  # early exit off: every layer runs
    width_confidence: float = -1.0  # point pruning off: every point is kept
    weights_seed: int = 0


@dataclasses.dataclass(frozen=True)
class RansacConfig:
    """Essential-matrix RANSAC. The reference ran 10 scalar iterations
    (src/tracking_main.c:210); on TPU hypotheses are free, so we vmap many."""

    num_hypotheses: int = 256
    sample_size: int = 8
    # Sampson distance threshold in *normalized* coordinates. The reference's
    # threshold (1.1, src/tracking_main.c:211) was against an E=I stub and is
    # meaningless; this corresponds to ~1px at KITTI focal length.
    inlier_thresh: float = 3.0 / 718.856


@dataclasses.dataclass(frozen=True)
class BAConfig:
    """Sliding-window bundle adjustment (reference: src/local_bundle_adjustment.c)."""

    num_poses: int = 8  # reference: local_bundle_adjustment.c:16
    max_landmarks: int = 1024  # reference used 1000; rounded to tile nicely
    max_factors_per_landmark: int = 8
    lm_damping: float = 1e-4
    max_iterations: int = 10
    huber_delta: float = 2.0  # pixels


@dataclasses.dataclass(frozen=True)
class KeyframeConfig:
    """Keyframe selection policy (net-new: the reference has none — it
    bounds state only by its 8-frame pool window, local_feature_pool.h:11).

    A frame becomes a keyframe when at least min_interval frames passed
    since the last one AND (the match ratio to the previous frame dropped
    below min_match_ratio, or max_interval frames passed). Keyframes are
    what enters the loop-closure database and the pose graph, which bounds
    long-run state growth."""

    min_interval: int = 1
    max_interval: int = 4
    min_match_ratio: float = 0.55  # inliers / top_n


@dataclasses.dataclass(frozen=True)
class LoopClosureConfig:
    """BoW loop closure (reference: src/bow_main.c, src/lcd_main.c)."""

    num_base_nodes: int = 10  # reference: include/data/LCD/vocabulary.h:5
    words_per_base_node: int = 1000  # reference: vocabulary.h:270
    top_n_features: int = 100  # reference: bow_main.c:9
    max_db_frames: int = 4096  # keyframe ring capacity
    min_score: float = 0.05
    min_frame_gap: int = 50  # in frames (not slots/keyframes)
    # Pose-graph skeleton cap: loop correction optimizes at most this many
    # nodes (keyframes are subsampled, skipped poses ride along rigidly).
    max_graph_nodes: int = 256
    # Correction gate: the pose graph is only re-optimized when some loop
    # edge's translation residual against the current trajectory exceeds
    # this (meters). Below it, corrections would only redistribute edge
    # measurement noise (~0.1-0.3 m per edge) and jitter the trajectory.
    correction_gate_m: float = 0.5

    @property
    def vocab_size(self) -> int:
        return self.num_base_nodes * self.words_per_base_node


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    """Local feature pool (reference: include/local_feature_pool.h)."""

    capacity: int = 3000  # reference: local_feature_pool.h:14
    max_frames: int = 8  # reference: local_feature_pool.h:11
    max_features_per_frame: int = 1000  # reference: local_feature_pool.h:12


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    camera: CameraConfig = KITTI_00_CAMERA
    frontend: FrontendConfig = FrontendConfig()
    matcher: MatcherConfig = MatcherConfig()
    ransac: RansacConfig = RansacConfig()
    ba: BAConfig = BAConfig()
    keyframe: KeyframeConfig = KeyframeConfig()
    loop: LoopClosureConfig = LoopClosureConfig()
    pool: PoolConfig = PoolConfig()

    @property
    def working_camera(self) -> CameraConfig:
        """Intrinsics rescaled to the frontend working resolution."""
        return self.camera.rescaled(self.frontend.width, self.frontend.height)


DEFAULT_CONFIG = SlamConfig()

"""Frame-to-frame visual odometry tracker (port of the single-stream step of
maveric_slam_tpu/frontend/tracker.py).

One step: int8 SuperPoint, the detector and top-N, the windowed match
against the previous frame, 256-hypothesis LO-RANSAC on the essential
matrix, midpoint triangulation, depth-ratio scale and Gauss-Newton PnP.
The step makes no host synchronisation; `Tracker` reads its statistics.

The state carries a `torch.Generator` in place of the JAX PRNG key; the
RANSAC noise can also be passed in (see geometry/ransac.py).
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import epipolar, pnp, ransac
from ..ops import matching
from ..ops.backend import resolve_device
from . import extractor


class TrackerState(NamedTuple):
    desc: torch.Tensor  # (num_cells, 256) int8 — previous frame descriptors
    probs: torch.Tensor  # (num_cells,) float32
    indices: torch.Tensor  # (num_cells,) int32
    xy: torch.Tensor  # (num_cells, 2) float32 sub-pixel keypoint coords
    depth: torch.Tensor  # (num_cells,) float32 — per-cell landmark depth
    depth_valid: torch.Tensor  # (num_cells,) bool
    scale: torch.Tensor  # () float32 — last step length in global units
    prev_R: torch.Tensor  # (3, 3) last accepted step rotation (constant-
    prev_t: torch.Tensor  # (3,)   velocity fallback for degenerate frames)
    generator: torch.Generator  # RANSAC noise source when none is passed in


class StepResult(NamedTuple):
    R: torch.Tensor  # (3, 3) p_new = R p_prev + t
    t: torch.Tensor  # (3,) scaled translation
    valid: torch.Tensor  # () bool — False: degenerate frame; R, t are the
    #     constant-velocity fallback, not a measurement
    num_matches: torch.Tensor
    num_inliers: torch.Tensor
    num_scale_pairs: torch.Tensor
    scale: torch.Tensor
    cells_new: torch.Tensor  # (N,) cell of each new-frame feature
    xy_new: torch.Tensor  # (N, 2) sub-pixel coords in the new frame
    matched_prev_cell: torch.Tensor  # (N,) matched prev-frame cell or -1
    match_score: torch.Tensor  # (N,) cosine^2
    match_mask: torch.Tensor  # (N,) bool — RANSAC inlier matches
    desc_top: torch.Tensor  # (N, 256) int8 descriptors of the new features
    desc_scale: torch.Tensor  # () descriptor scale
    depth_top: torch.Tensor  # (N,) metric depth in the new camera (0: invalid)
    depth_top_ok: torch.Tensor  # (N,) bool


def _masked_median(x: torch.Tensor, mask: torch.Tensor, default: torch.Tensor) -> torch.Tensor:
    order = torch.sort(torch.where(mask, x, torch.inf)).values
    n = torch.sum(mask)
    med = order[torch.clamp(n - 1, min=0) // 2]
    return torch.where(n > 0, med, default)


def init_state(params, image: torch.Tensor, config: SlamConfig, seed: int = 0) -> TrackerState:
    """State from the first frame, on the image's device."""
    dev = image.device
    fc = config.frontend
    feats = extractor.extract_quantized(params, image, config)
    n = fc.num_cells
    return TrackerState(
        desc=feats.desc_q.reshape(n, 256),
        probs=feats.probs.reshape(n),
        indices=feats.indices.reshape(n),
        xy=feats.xy.reshape(n, 2),
        depth=torch.zeros(n, dtype=torch.float32, device=dev),
        depth_valid=torch.zeros(n, dtype=torch.bool, device=dev),
        scale=torch.ones((), dtype=torch.float32, device=dev),
        prev_R=torch.eye(3, dtype=torch.float32, device=dev),
        prev_t=torch.zeros(3, dtype=torch.float32, device=dev),
        generator=torch.Generator(device=dev).manual_seed(seed),
    )


def track_step(params, state: TrackerState, image: torch.Tensor, config: SlamConfig,
               gumbel_min: torch.Tensor | None = None,
               gumbel_lo: torch.Tensor | None = None) -> Tuple[TrackerState, StepResult]:
    """One tracking step on the image's device. `gumbel_min`
    (num_hypotheses, top_n) and `gumbel_lo` (lo hypotheses, top_n) inject the
    RANSAC noise; otherwise it is drawn from `state.generator`."""
    feats = extractor.extract_quantized(params, image, config)
    return _step_from_feats(state, feats, config, gumbel_min, gumbel_lo)


def _step_from_feats(state: TrackerState, feats: extractor.QuantizedFeatures,
                     config: SlamConfig, gumbel_min, gumbel_lo):
    fc, mc = config.frontend, config.matcher
    n_cells = fc.num_cells
    dev = state.desc.device
    desc1 = feats.desc_q.reshape(n_cells, 256)
    top = feats.top

    m = matching.windowed_match(
        state.desc, state.probs, state.indices, desc1, top.cells, top.indices, top.mask,
        grid_h=fc.grid_h, grid_w=fc.grid_w, shift=mc.window_shift,
        radius=mc.window_radius, match_threshold=mc.match_threshold,
        min_prob=mc.min_prob, xy0_cells=state.xy, xy1_cells=feats.xy.reshape(n_cells, 2),
    )

    K = torch.from_numpy(config.working_camera.K).to(dev)
    p_prev = epipolar.normalize_points(m.xy0, K)
    p_new = epipolar.normalize_points(m.xy1, K)
    res = ransac.ransac_essential(
        p_prev, p_new, m.mask, inlier_thresh=config.ransac.inlier_thresh,
        num_hypotheses=config.ransac.num_hypotheses, sample_size=config.ransac.sample_size,
        gumbel_min=gumbel_min, gumbel_lo=gumbel_lo, generator=state.generator,
    )

    # Unit-baseline structure in the previous frame's coordinates.
    X_unit = epipolar.triangulate(res.R, res.t, p_prev, p_new)
    depth_ok = res.inliers & (X_unit[..., 2] > 1e-3) & (X_unit[..., 2] < 1e3)

    # Depth-ratio scale against last step's depths at the matched cells.
    cell0 = m.cell0.long()
    prev_depth = state.depth[cell0]
    prev_ok = state.depth_valid[cell0] & (cell0 >= 0)
    ratio = prev_depth / torch.clamp(X_unit[..., 2], min=1e-6)
    pair_ok = depth_ok & prev_ok
    scale = torch.clamp(_masked_median(ratio, pair_ok, state.scale), 1e-3, 1e3)

    X_scaled = X_unit * scale
    refined = pnp.refine_pose(K, res.R, res.t * scale, X_scaled, m.xy1, depth_ok,
                              huber_delta=config.ba.huber_delta, damping=config.ba.lm_damping)
    # Fall back to the RANSAC pose if GN diverged.
    t_norm = torch.linalg.vector_norm(refined.t)
    ok = (t_norm > 0.25 * scale) & (t_norm < 4.0 * scale) & (res.num_inliers > 10)
    R_out = torch.where(ok, refined.R, res.R)
    t_out = torch.where(ok, refined.t, res.t * scale)

    # Degenerate-frame gate: emit a flagged constant-velocity step.
    step_valid = ((m.num_matches >= 8) & (res.num_inliers >= 5)
                  & torch.all(torch.isfinite(R_out)) & torch.all(torch.isfinite(t_out)))
    R_out = torch.where(step_valid, R_out, state.prev_R)
    t_out = torch.where(step_valid, t_out, state.prev_t)

    # Per-cell depth map in the new frame. Rows that do not write go to a
    # spare slot past the grid, so no masked row can clobber a real cell.
    p_cam_new = X_scaled @ R_out.T + t_out
    write = depth_ok & step_valid & torch.all(torch.isfinite(p_cam_new), dim=-1)
    depth_top = torch.where(write, p_cam_new[..., 2], 0.0)
    slot = torch.where(write, top.cells.long(), n_cells)
    new_depth = torch.zeros(n_cells + 1, dtype=torch.float32, device=dev)
    new_depth[slot] = depth_top
    new_valid = torch.zeros(n_cells + 1, dtype=torch.bool, device=dev)
    new_valid[slot] = write

    new_state = TrackerState(
        desc=desc1,
        probs=feats.probs.reshape(n_cells),
        indices=feats.indices.reshape(n_cells),
        xy=feats.xy.reshape(n_cells, 2),
        depth=new_depth[:n_cells],
        depth_valid=new_valid[:n_cells],
        scale=torch.where(step_valid, torch.linalg.vector_norm(t_out), state.scale),
        prev_R=R_out,
        prev_t=t_out,
        generator=state.generator,
    )
    inliers_out = res.inliers & step_valid
    return new_state, StepResult(
        R=R_out,
        t=t_out,
        valid=step_valid,
        num_matches=m.num_matches,
        num_inliers=torch.where(step_valid, res.num_inliers, 0).to(torch.int32),
        num_scale_pairs=torch.sum(pair_ok).to(torch.int32),
        scale=scale,
        cells_new=top.cells,
        xy_new=m.xy1,
        matched_prev_cell=torch.where(inliers_out, m.cell0, -1).to(torch.int32),
        match_score=m.score,
        match_mask=m.mask & inliers_out,
        desc_top=desc1[top.cells.long()],
        desc_scale=feats.desc_scale,
        depth_top=depth_top,
        depth_top_ok=write,
    )


class Tracker:
    """Host-side odometry loop around `track_step`, on `device` (None: CUDA)."""

    def __init__(self, params, config: SlamConfig, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.config = config
        self.seed = seed
        self.state: TrackerState | None = None
        self.rel_poses: List[Tuple[np.ndarray, np.ndarray]] = []
        self.stats: List[dict] = []

    def process(self, image: np.ndarray, gumbel_min=None, gumbel_lo=None) -> StepResult | None:
        img = torch.as_tensor(np.asarray(image, np.float32), device=self.device)
        if self.state is None:
            self.state = init_state(self.params, img, self.config, self.seed)
            return None
        self.state, step = track_step(self.params, self.state, img, self.config,
                                      gumbel_min, gumbel_lo)
        self.rel_poses.append((step.R.cpu().numpy(), step.t.cpu().numpy()))
        self.stats.append({
            "matches": int(step.num_matches),
            "inliers": int(step.num_inliers),
            "scale_pairs": int(step.num_scale_pairs),
            "scale": float(step.scale),
            "valid": bool(step.valid),
        })
        return step

    def trajectory(self) -> np.ndarray:
        from ..utils.trajectory import compose_trajectory

        return compose_trajectory([p[0] for p in self.rel_poses], [p[1] for p in self.rel_poses])

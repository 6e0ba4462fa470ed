"""Frame-to-frame visual odometry tracker (port of
maveric_slam_tpu/frontend/tracker.py).

One step: int8 SuperPoint (fused stem), the detector and top-N, the
windowed match against the previous frame, 256-hypothesis LO-RANSAC on the
essential matrix, midpoint triangulation, depth-ratio scale and
Gauss-Newton PnP. The step reads nothing back to the host; the host loops
(`Tracker`, `PipelinedTracker`) read its statistics. PyTorch synchronises
each upload of a host tensor, though, and the step makes three: the camera
matrix (span `tracker.camera`), RANSAC's refit schedule and the pose
decomposition's `W`. On a card the first waits for the extraction and the
match queued before it.

Spans (utils/profiling.py): `tracker.step` (`track_step`,
`track_step_batched`) or `tracker.chunk` (`track_chunk`) around
`tracker.extract`, then, per frame, `tracker.match`, `tracker.camera`,
`tracker.ransac` (normalisation, noise draws, `ransac_essential`),
`tracker.scale` (triangulation, depth-ratio scale), `tracker.refine_pose`
(PnP and its fall-back) and `tracker.state` (the degenerate gate, the depth
map, the new state and the result).

Streams. The step is written once, over a leading stream axis S
(`_step_from_feats`): `track_step_batched` runs S independent streams in
one pass, so each kernel launches as often per batched step as per single
step; `track_step` is that pass at S = 1; `track_chunk` extracts K frames of
one stream in one batched pass, then runs the tail once per frame, in order.

Randomness. A state carries `torch.Generator`s in place of the JAX PRNG
key: one for a single stream (`init_state(seed=...)`), a tuple of S for a
batched state, stream s seeded s (`init_states_batched`, as the JAX package
gives stream s PRNGKey(s)). Each stream's RANSAC noise is drawn from its
own generator, so stream s of a batch draws what a single-stream tracker
seeded s draws. The noise can also be passed in (see geometry/ransac.py).
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from ..config import SlamConfig
from ..geometry import epipolar, pnp, ransac
from ..ops import matching
from ..ops.backend import resolve_device
from ..ops.linalg import apply_rows
from ..utils import profiling
from . import extractor


class TrackerState(NamedTuple):
    """One stream's state; a batched state gives each tensor a leading
    stream axis S and holds a tuple of S generators."""

    desc: torch.Tensor  # (num_cells, 256) int8 — previous frame descriptors
    probs: torch.Tensor  # (num_cells,) float32
    indices: torch.Tensor  # (num_cells,) int32
    xy: torch.Tensor  # (num_cells, 2) float32 sub-pixel keypoint coords
    depth: torch.Tensor  # (num_cells,) float32 — per-cell landmark depth
    depth_valid: torch.Tensor  # (num_cells,) bool
    scale: torch.Tensor  # () float32 — last step length in global units
    prev_R: torch.Tensor  # (3, 3) last accepted step rotation (constant-
    prev_t: torch.Tensor  # (3,)   velocity fallback for degenerate frames)
    generator: torch.Generator | Tuple[torch.Generator, ...]  # RANSAC noise
    #     source when none is passed in


class StepResult(NamedTuple):
    """One step's result; batched and chunked steps give every field a
    leading stream or frame axis."""

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
    """Lower median of x over the mask along the last axis, else `default`."""
    order = torch.sort(torch.where(mask, x, torch.inf), dim=-1).values
    n = torch.sum(mask, dim=-1)
    med = torch.take_along_dim(order, (torch.clamp(n - 1, min=0) // 2)[..., None], dim=-1)[..., 0]
    return torch.where(n > 0, med, default)


def _init(params, images: torch.Tensor, config: SlamConfig, seeds: Sequence[int]) -> TrackerState:
    dev = images.device
    fc = config.frontend
    s, n = images.shape[0], fc.num_cells
    feats = extractor.extract_quantized_batched(params, images, config)
    return TrackerState(
        desc=feats.desc_q.reshape(s, n, 256),
        probs=feats.probs.reshape(s, n),
        indices=feats.indices.reshape(s, n),
        xy=feats.xy.reshape(s, n, 2),
        depth=torch.zeros(s, n, dtype=torch.float32, device=dev),
        depth_valid=torch.zeros(s, n, dtype=torch.bool, device=dev),
        scale=torch.ones(s, dtype=torch.float32, device=dev),
        prev_R=torch.eye(3, dtype=torch.float32, device=dev).repeat(s, 1, 1),
        prev_t=torch.zeros(s, 3, dtype=torch.float32, device=dev),
        generator=tuple(torch.Generator(device=dev).manual_seed(int(k)) for k in seeds),
    )


def _batched(state: TrackerState) -> TrackerState:
    """A single-stream state as a batch of one."""
    return TrackerState(*(f[None] for f in state[:-1]), generator=(state.generator,))


def _stream(state: TrackerState, k: int) -> TrackerState:
    """Stream k of a batched state."""
    return TrackerState(*(f[k] for f in state[:-1]), generator=state.generator[k])


def init_state(params, image: torch.Tensor, config: SlamConfig, seed: int = 0) -> TrackerState:
    """State from the first frame, on the image's device."""
    return _stream(_init(params, image[None], config, [seed]), 0)


def init_states_batched(params, images: torch.Tensor, config: SlamConfig) -> TrackerState:
    """S independent states from (S, H, W) first frames, in one extraction;
    stream s's generator is seeded s."""
    return _init(params, images, config, range(images.shape[0]))


def track_step(params, state: TrackerState, image: torch.Tensor, config: SlamConfig,
               gumbel_min: torch.Tensor | None = None,
               gumbel_lo: torch.Tensor | None = None) -> Tuple[TrackerState, StepResult]:
    """One tracking step on the image's device. `gumbel_min`
    (num_hypotheses, top_n) and `gumbel_lo` (lo hypotheses, top_n) inject the
    RANSAC noise; otherwise it is drawn from `state.generator`."""
    with profiling.span("tracker.step"):
        with profiling.span("tracker.extract"):
            feats = extractor.extract_quantized_batched(params, image[None], config)
        new, res = _step_from_feats(
            _batched(state), feats, config,
            None if gumbel_min is None else gumbel_min[None],
            None if gumbel_lo is None else gumbel_lo[None])
        return _stream(new, 0), StepResult(*(f[0] for f in res))


def track_step_batched(params, states: TrackerState, images: torch.Tensor, config: SlamConfig,
                       gumbel_min: torch.Tensor | None = None,
                       gumbel_lo: torch.Tensor | None = None) -> Tuple[TrackerState, StepResult]:
    """One tracking step for S independent streams (images (S, H, W)) in one
    batched pass. `gumbel_min` (S, num_hypotheses, top_n) and `gumbel_lo`
    (S, lo hypotheses, top_n) inject the noise; otherwise each stream draws
    from its own generator."""
    with profiling.span("tracker.step"):
        with profiling.span("tracker.extract"):
            feats = extractor.extract_quantized_batched(params, images, config)
        return _step_from_feats(states, feats, config, gumbel_min, gumbel_lo)


def track_chunk(params, state: TrackerState, images: torch.Tensor, config: SlamConfig,
                gumbel_min: torch.Tensor | None = None,
                gumbel_lo: torch.Tensor | None = None) -> Tuple[TrackerState, StepResult]:
    """Track K frames (images (K, H, W)) of one stream: extraction runs once
    over the chunk, then the sequential tail runs once per frame, in order,
    as JAX's `lax.scan` does. The results equal K `track_step` calls and gain
    a leading K axis; `gumbel_min` (K, num_hypotheses, top_n) and `gumbel_lo`
    (K, lo hypotheses, top_n) inject each frame's noise."""
    with profiling.span("tracker.chunk"):
        with profiling.span("tracker.extract"):
            feats = extractor.extract_quantized_batched(params, images, config)
        st = _batched(state)
        out = []
        for k in range(images.shape[0]):
            st, res = _step_from_feats(
                st, extractor.select(feats, slice(k, k + 1)), config,
                None if gumbel_min is None else gumbel_min[k:k + 1],
                None if gumbel_lo is None else gumbel_lo[k:k + 1])
            out.append(res)
        return _stream(st, 0), StepResult(*(torch.cat(f) for f in zip(*out)))


def _step_from_feats(state: TrackerState, feats: extractor.QuantizedFeatures,
                     config: SlamConfig, gumbel_min, gumbel_lo):
    """The tail of a step (everything after extraction) for S streams:
    `state` and `feats` carry a leading axis S, as do the results."""
    fc, mc, rc = config.frontend, config.matcher, config.ransac
    n_cells = fc.num_cells
    s = state.desc.shape[0]
    dev = state.desc.device
    desc1 = feats.desc_q.reshape(s, n_cells, 256)
    top = feats.top

    with profiling.span("tracker.match"):
        m = matching.windowed_match(
            state.desc, state.probs, state.indices, desc1, top.cells, top.indices, top.mask,
            grid_h=fc.grid_h, grid_w=fc.grid_w, shift=mc.window_shift,
            radius=mc.window_radius, match_threshold=mc.match_threshold,
            min_prob=mc.min_prob, xy0_cells=state.xy, xy1_cells=feats.xy.reshape(s, n_cells, 2),
        )

    # The camera matrix's upload: PyTorch synchronises a host tensor's copy
    # to a card, so on one this span is the host's wait for the queued work.
    with profiling.span("tracker.camera"):
        K = torch.from_numpy(config.working_camera.K).to(dev)
    with profiling.span("tracker.ransac"):
        p_prev = epipolar.normalize_points(m.xy0, K)
        p_new = epipolar.normalize_points(m.xy1, K)
        if gumbel_min is None or gumbel_lo is None:
            lo_k, n = ransac.lo_hypotheses(rc.num_hypotheses), fc.top_n
            draws = [(ransac.gumbel((rc.num_hypotheses, n), g, dev), ransac.gumbel((lo_k, n), g, dev))
                     for g in state.generator]
            gumbel_min = torch.stack([d[0] for d in draws]) if gumbel_min is None else gumbel_min
            gumbel_lo = torch.stack([d[1] for d in draws]) if gumbel_lo is None else gumbel_lo
        res = ransac.ransac_essential(
            p_prev, p_new, m.mask, inlier_thresh=rc.inlier_thresh,
            num_hypotheses=rc.num_hypotheses, sample_size=rc.sample_size,
            gumbel_min=gumbel_min, gumbel_lo=gumbel_lo,
        )

    with profiling.span("tracker.scale"):
        # Unit-baseline structure in the previous frame's coordinates.
        X_unit = epipolar.triangulate(res.R, res.t, p_prev, p_new)
        depth_ok = res.inliers & (X_unit[..., 2] > 1e-3) & (X_unit[..., 2] < 1e3)

        # Depth-ratio scale against last step's depths at the matched cells.
        cell0 = m.cell0.long()
        c0 = torch.clamp(cell0, min=0)
        prev_depth = torch.take_along_dim(state.depth, c0, dim=-1)
        prev_ok = torch.take_along_dim(state.depth_valid, c0, dim=-1) & (cell0 >= 0)
        ratio = prev_depth / torch.clamp(X_unit[..., 2], min=1e-6)
        pair_ok = depth_ok & prev_ok
        scale = torch.clamp(_masked_median(ratio, pair_ok, state.scale), 1e-3, 1e3)

        X_scaled = X_unit * scale[:, None, None]
        t_scaled = res.t * scale[:, None]
    with profiling.span("tracker.refine_pose"):
        refined = pnp.refine_pose(K, res.R, t_scaled, X_scaled, m.xy1, depth_ok,
                                  huber_delta=config.ba.huber_delta, damping=config.ba.lm_damping)
        # Fall back to the RANSAC pose if GN diverged.
        t_norm = torch.linalg.vector_norm(refined.t, dim=-1)
        ok = (t_norm > 0.25 * scale) & (t_norm < 4.0 * scale) & (res.num_inliers > 10)
        R_out = torch.where(ok[:, None, None], refined.R, res.R)
        t_out = torch.where(ok[:, None], refined.t, t_scaled)

    with profiling.span("tracker.state"):
        # Degenerate-frame gate: emit a flagged constant-velocity step.
        step_valid = ((m.num_matches >= 8) & (res.num_inliers >= 5)
                      & torch.all(torch.isfinite(R_out).reshape(s, 9), dim=-1)
                      & torch.all(torch.isfinite(t_out), dim=-1))
        R_out = torch.where(step_valid[:, None, None], R_out, state.prev_R)
        t_out = torch.where(step_valid[:, None], t_out, state.prev_t)

        # Per-cell depth map in the new frame. Rows that do not write go to a
        # spare slot past the grid, so no masked row can clobber a real cell.
        p_cam_new = apply_rows(X_scaled, R_out) + t_out[:, None, :]
        write = depth_ok & step_valid[:, None] & torch.all(torch.isfinite(p_cam_new), dim=-1)
        depth_top = torch.where(write, p_cam_new[..., 2], 0.0)
        slot = torch.where(write, top.cells.long(), n_cells)
        new_depth = torch.zeros(s, n_cells + 1, dtype=torch.float32, device=dev)
        new_depth.scatter_(1, slot, depth_top)
        new_valid = torch.zeros(s, n_cells + 1, dtype=torch.bool, device=dev)
        new_valid.scatter_(1, slot, write)

        new_state = TrackerState(
            desc=desc1,
            probs=feats.probs.reshape(s, n_cells),
            indices=feats.indices.reshape(s, n_cells),
            xy=feats.xy.reshape(s, n_cells, 2),
            depth=new_depth[:, :n_cells],
            depth_valid=new_valid[:, :n_cells],
            scale=torch.where(step_valid, torch.linalg.vector_norm(t_out, dim=-1), state.scale),
            prev_R=R_out,
            prev_t=t_out,
            generator=state.generator,
        )
        inliers_out = res.inliers & step_valid[:, None]
        return new_state, StepResult(
            R=R_out,
            t=t_out,
            valid=step_valid,
            num_matches=m.num_matches,
            num_inliers=torch.where(step_valid, res.num_inliers, 0).to(torch.int32),
            num_scale_pairs=torch.sum(pair_ok, dim=-1).to(torch.int32),
            scale=scale,
            cells_new=top.cells,
            xy_new=m.xy1,
            matched_prev_cell=torch.where(inliers_out, m.cell0, -1).to(torch.int32),
            match_score=m.score,
            match_mask=m.mask & inliers_out,
            desc_top=torch.take_along_dim(desc1, top.cells.long()[..., None], dim=-2),
            desc_scale=feats.desc_scale.expand(s),
            depth_top=depth_top,
            depth_top_ok=write,
        )


def _stats(res: StepResult) -> List[dict]:
    """Per-step statistics of a result with a leading step axis (one host
    copy per field)."""
    cols = {k: getattr(res, f).cpu().tolist() for k, f in (
        ("matches", "num_matches"), ("inliers", "num_inliers"),
        ("scale_pairs", "num_scale_pairs"), ("scale", "scale"), ("valid", "valid"))}
    return [dict(zip(cols, row)) for row in zip(*cols.values())]


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
        self.stats.extend(_stats(StepResult(*(f[None] for f in step))))
        return step

    def trajectory(self) -> np.ndarray:
        from ..utils.trajectory import compose_trajectory

        return compose_trajectory([p[0] for p in self.rel_poses], [p[1] for p in self.rel_poses])


class PipelinedTracker:
    """Host loop around `track_chunk` for throughput-bound use (offline
    mapping, multi-camera ingest): frames are buffered and tracked a chunk
    at a time, so results arrive chunk by chunk. A partial chunk (from
    `flush` or `trajectory`) runs frame by frame through `track_step`."""

    def __init__(self, params, config: SlamConfig, chunk: int = 8, seed: int = 0, device=None):
        self.device = resolve_device(device)
        self.params = params
        self.config = config
        self.chunk = chunk
        self.seed = seed
        self.state: TrackerState | None = None
        self._buf: List[tuple] = []
        self.rel_poses: List[Tuple[np.ndarray, np.ndarray]] = []
        self.stats: List[dict] = []

    def process(self, image: np.ndarray, gumbel_min=None, gumbel_lo=None) -> None:
        """Buffer a frame (with its RANSAC noise, if injected); a full
        buffer is tracked at once."""
        img = torch.as_tensor(np.asarray(image, np.float32), device=self.device)
        if self.state is None:
            self.state = init_state(self.params, img, self.config, self.seed)
            return
        self._buf.append((img, gumbel_min, gumbel_lo))
        if len(self._buf) >= self.chunk:
            self.flush()

    def flush(self) -> None:
        if not self._buf or self.state is None:
            return
        buf, self._buf = self._buf, []
        if len(buf) == self.chunk:
            noise = []
            for j in (1, 2):
                given = [b[j] is not None for b in buf]
                if any(given) and not all(given):
                    raise ValueError("inject RANSAC noise for every frame of a chunk or for none")
                noise.append(torch.stack([torch.as_tensor(b[j], device=self.device) for b in buf])
                             if all(given) else None)
            self.state, res = track_chunk(self.params, self.state,
                                          torch.stack([b[0] for b in buf]), self.config, *noise)
            self._record(res)
        else:
            for img, gmin, glo in buf:
                self.state, res = track_step(self.params, self.state, img, self.config, gmin, glo)
                self._record(StepResult(*(f[None] for f in res)))

    def _record(self, res: StepResult) -> None:
        R, t = res.R.cpu().numpy(), res.t.cpu().numpy()
        self.rel_poses.extend(zip(R, t))
        self.stats.extend(_stats(res))

    def trajectory(self) -> np.ndarray:
        from ..utils.trajectory import compose_trajectory

        self.flush()
        return compose_trajectory([p[0] for p in self.rel_poses], [p[1] for p in self.rel_poses])

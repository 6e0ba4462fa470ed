"""Multi-frame feature track table (the port's own copy of
maveric_slam_tpu/tracks.py).

Capability of the reference's PointTracker (python/superpoint_inference.py:
259-466: fixed-memory track matrix, id propagation through pairwise matches,
score averaging, track harvesting) operating on the quantized tracker's
cell-level matches. Host-side numpy: this is bookkeeping that feeds the BA
problem builder, not a hot path (the hot matching already ran on device).
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np


class Observation(NamedTuple):
    frame: int
    xy: Tuple[float, float]


class TrackTable:
    """Tracks keyed by id; per-frame cell -> track-id maps chain matches."""

    def __init__(self, num_cells: int, max_length: int = 8):
        self.num_cells = num_cells
        self.max_length = max_length
        self.next_id = 0
        # track id occupying each cell of the most recent frame (-1 none).
        self.cell_to_track = np.full(num_cells, -1, np.int64)
        self.observations: Dict[int, List[Observation]] = {}
        self.scores: Dict[int, float] = {}
        self.words: Dict[int, int] = {}  # latest visual-word id per track

    def advance(
        self,
        frame: int,
        cells_new: np.ndarray,  # (N,) cells of the new frame's features
        xy_new: np.ndarray,  # (N, 2) their pixel coords
        matched_prev_cell: np.ndarray,  # (N,) matched cell in prev frame or -1
        score: np.ndarray,  # (N,) match score
        mask: np.ndarray,  # (N,) bool
        word_ids: np.ndarray | None = None,  # (N,) visual word per feature
    ) -> None:
        """Ingest one frame's matches; extends or starts tracks."""
        new_map = np.full(self.num_cells, -1, np.int64)
        for i in range(len(cells_new)):
            if not mask[i]:
                continue
            c_new = int(cells_new[i])
            c_prev = int(matched_prev_cell[i])
            tid = self.cell_to_track[c_prev] if c_prev >= 0 else -1
            if tid < 0:
                tid = self.next_id
                self.next_id += 1
                self.observations[tid] = []
                self.scores[tid] = float(score[i])
            else:
                # Running average, like PointTracker's score update
                # (superpoint_inference.py:380-389).
                n = len(self.observations[tid])
                frac = 1.0 / max(n, 1)
                self.scores[tid] = (1 - frac) * self.scores[tid] + frac * float(score[i])
            obs = self.observations[tid]
            obs.append(Observation(frame, (float(xy_new[i, 0]), float(xy_new[i, 1]))))
            if len(obs) > self.max_length:
                del obs[0]
            new_map[c_new] = tid
            if word_ids is not None and word_ids[i] >= 0:
                self.words[tid] = int(word_ids[i])
        self.cell_to_track = new_map
        # Drop tracks that fell out of the table and have stale heads.
        live = set(new_map[new_map >= 0].tolist())
        for tid in list(self.observations):
            if tid not in live and (
                not self.observations[tid]
                or self.observations[tid][-1].frame < frame - self.max_length
            ):
                del self.observations[tid]
                self.scores.pop(tid, None)
                self.words.pop(tid, None)

    def get_tracks(self, min_length: int = 2) -> List[Tuple[int, List[Observation]]]:
        """Tracks with at least min_length observations (PointTracker
        get_tracks semantics, superpoint_inference.py:408-424)."""
        return [
            (tid, obs)
            for tid, obs in self.observations.items()
            if len(obs) >= min_length
        ]

    def window_problem(
        self,
        frames: List[int],
        max_landmarks: int,
        priorities: Dict[int, float] | None = None,
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Dense (L, P) observation grid for the given keyframe window.

        Returns (uv (L, P, 2), mask (L, P), track_ids (L,)); tracks with >= 2
        observations inside the window, strongest first, capped at
        max_landmarks with zero padding. `priorities` (e.g. feature-pool
        covisibility weights keyed by track id) breaks ties between tracks
        of equal window length — stable, well-covised landmarks win the
        fixed BA budget.
        """
        p = len(frames)
        frame_pos = {f: k for k, f in enumerate(frames)}
        rows = []
        for tid, obs in self.observations.items():
            hits = [(frame_pos[o.frame], o.xy) for o in obs if o.frame in frame_pos]
            if len(hits) >= 2:
                rows.append((len(hits), tid, hits))
        if priorities:
            rows.sort(key=lambda r: (-r[0], -priorities.get(r[1], 0.0)))
        else:
            rows.sort(key=lambda r: -r[0])
        rows = rows[:max_landmarks]

        uv = np.zeros((max_landmarks, p, 2), np.float32)
        mask = np.zeros((max_landmarks, p), bool)
        tids = np.full(max_landmarks, -1, np.int64)
        for l, (_, tid, hits) in enumerate(rows):
            tids[l] = tid
            for k, xy in hits:
                uv[l, k] = xy
                mask[l, k] = True
        return uv, mask, tids

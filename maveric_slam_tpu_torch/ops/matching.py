"""Windowed int8 descriptor matching (port of maveric_slam_tpu/ops/matching.py
`windowed_match`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from .kernels.match import windowed_match as _best_in_window


class WindowedMatches(NamedTuple):
    """Fixed-capacity match set between a query frame and a reference frame."""

    cell0: torch.Tensor  # ([S,] N) int32 matched cell in frame0 (-1 if !mask)
    xy0: torch.Tensor  # ([S,] N, 2) float32 pixel coords in frame0
    xy1: torch.Tensor  # ([S,] N, 2) float32 pixel coords in frame1
    score: torch.Tensor  # ([S,] N) float32 cosine^2 similarity
    mask: torch.Tensor  # ([S,] N) bool
    num_matches: torch.Tensor  # ([S]) int32


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx, :] per leading index: x (..., C, D), idx (..., N) -> (..., N, D)."""
    return torch.take_along_dim(x, idx[..., None], dim=-2)


def windowed_match(
    desc0: torch.Tensor,  # ([S,] Hc*Wc, 256) int8, frame0 descriptors (row-major cells)
    probs0: torch.Tensor,  # ([S,] Hc*Wc) float32
    indices0: torch.Tensor,  # ([S,] Hc*Wc) int32 (64 = none)
    desc1: torch.Tensor,  # ([S,] Hc*Wc, 256) int8, frame1 descriptors
    cells1: torch.Tensor,  # ([S,] N) int32 selected frame1 cells
    indices1: torch.Tensor,  # ([S,] N) int32
    mask1: torch.Tensor,  # ([S,] N) bool
    grid_h: int,
    grid_w: int,
    shift: tuple = (0, 0),
    radius: int = 4,
    match_threshold: float = 0.9,
    min_prob: float = 0.2,
    signed: bool = True,
    xy0_cells: torch.Tensor | None = None,  # ([S,] Hc*Wc, 2) sub-pixel coords per cell
    xy1_cells: torch.Tensor | None = None,
) -> WindowedMatches:
    """For each selected frame1 feature, the best-cosine frame0 cell within a
    (2*radius+1)^2 grid window around its shifted location, subject to
    prob0 >= min_prob and cos^2 > match_threshold^2 (and a positive dot
    when `signed`). With a leading stream axis S every stream is matched
    against its own frame0, in one kernel launch; the fields gain that axis."""
    c1 = cells1.long()
    best_score, best_cell = _best_in_window(
        _rows(desc1, c1), desc0, probs0, indices0, cells1,
        grid_h=grid_h, grid_w=grid_w, shift=shift, radius=radius,
        min_prob=min_prob, signed=signed,
    )
    matched = mask1 & (best_score > match_threshold**2)
    bc = best_cell.long()
    if xy0_cells is not None:
        xy0 = _rows(xy0_cells, bc)
    else:
        idx0 = torch.take_along_dim(indices0, bc, dim=-1)
        xy0 = torch.stack([(bc % grid_w) * 8 + idx0 % 8, (bc // grid_w) * 8 + idx0 // 8], -1)
    if xy1_cells is not None:
        xy1 = _rows(xy1_cells, c1)
    else:
        xy1 = torch.stack([(c1 % grid_w) * 8 + indices1 % 8, (c1 // grid_w) * 8 + indices1 // 8], -1)
    return WindowedMatches(
        cell0=torch.where(matched, best_cell, -1).to(torch.int32),
        xy0=xy0.to(torch.float32),
        xy1=xy1.to(torch.float32),
        score=best_score,
        mask=matched,
        num_matches=torch.sum(matched, dim=-1).to(torch.int32),
    )

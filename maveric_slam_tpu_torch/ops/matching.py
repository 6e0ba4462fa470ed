"""Descriptor matching (port of maveric_slam_tpu/ops/matching.py): the
windowed int8 matcher of the tracker (a CUDA kernel on a card) and the float
nearest-neighbour matchers of the golden pipeline (f32 products, TF32 off).
Ties go to the first maximum / minimum, as in the JAX package."""

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


class NNMatches(NamedTuple):
    index: torch.Tensor  # ([P,] Na) int32 best match in B
    score: torch.Tensor  # ([P,] Na) float32 dot product (nn_match_dot) or L2 distance (two-way)
    mask: torch.Tensor  # ([P,] Na) bool


def nn_match_dot(descA: torch.Tensor, descB: torch.Tensor, maskA: torch.Tensor,
                 maskB: torch.Tensor, dot_thresh: float = 0.8) -> NNMatches:
    """One-way best-dot match of L2-normalized (..., Na, D) against
    (..., Nb, D); leading axes are independent pairs."""
    dots = torch.where(maskB[..., None, :], descA @ descB.transpose(-1, -2), -torch.inf)
    idx = torch.argmax(dots, dim=-1)
    score = torch.take_along_dim(dots, idx[..., None], dim=-1)[..., 0]
    return NNMatches(index=idx.to(torch.int32), score=score, mask=maskA & (score > dot_thresh))


def nn_match_two_way(descA: torch.Tensor, descB: torch.Tensor, maskA: torch.Tensor,
                     maskB: torch.Tensor, nn_thresh: float = 0.7) -> NNMatches:
    """Two-way-consistent NN match on L2 distance d = sqrt(2 - 2 dot): keep
    (i, j) iff j = argmin_j d(i, j), i = argmin_i d(i, j) and d < nn_thresh."""
    dots = torch.clamp(descA @ descB.T, -1.0, 1.0)
    dist = torch.sqrt(torch.clamp(2.0 - 2.0 * dots, min=0.0))
    dist = torch.where(maskA[:, None] & maskB[None, :], dist, torch.inf)
    j_of_i = torch.argmin(dist, dim=1)
    i_of_j = torch.argmin(dist, dim=0)
    d = torch.take_along_dim(dist, j_of_i[:, None], dim=1)[:, 0]
    mutual = i_of_j[j_of_i] == torch.arange(descA.shape[0], device=descA.device)
    return NNMatches(index=j_of_i.to(torch.int32), score=d,
                     mask=maskA & mutual & (d < nn_thresh))

"""Detector-head post-processing: approximate and exact softmax, top-N
selection and sub-pixel keypoints (port of maveric_slam_tpu/ops/softmax_topn.py).

Grids keep the JAX package's layout: (..., Hc, Wc, 65) int8 logits in,
(..., Hc, Wc) maps out, cells flattened row-major (r * Wc + c). Leading axes
are streams: every function here works on each stream's grid alone.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

FLT_MIN = 1.175494e-38
DUSTBIN = 64


def _taylor_exp_ref(x_int: torch.Tensor, scale: torch.Tensor, degree: int = 5) -> torch.Tensor:
    """Taylor exp accumulated exactly like top_N.c:61-65 (and the JAX port):
    scale_poly = scale_poly * scale / i, acc = acc + scale_poly * x^i."""
    x = x_int.to(torch.float32)
    scale = torch.as_tensor(scale, dtype=torch.float32, device=x.device)
    acc = torch.ones_like(x)
    scale_poly = torch.ones((), dtype=torch.float32, device=x.device)
    x_poly = x
    for i in range(1, degree):
        scale_poly = scale_poly * scale / i
        acc = acc + scale_poly * x_poly
        x_poly = x_poly * x
    return acc


class SoftmaxGrid(NamedTuple):
    probs: torch.Tensor  # (..., Hc, Wc) float32; -1 where dustbin wins
    indices: torch.Tensor  # (..., Hc, Wc) int32 in [0, 64]; 64 = no keypoint


def approx_softmax_grid(semi_q: torch.Tensor, scale, degree: int = 5) -> SoftmaxGrid:
    """Approximate per-cell softmax over 65 channels, negatives skipped; the
    winner is the FIRST largest exp among channels 0..63."""
    expx = torch.where(semi_q >= 0, _taylor_exp_ref(semi_q, scale, degree), 0.0)
    denom = torch.sum(expx, dim=-1) + FLT_MIN
    point_exp = expx[..., :DUSTBIN]
    max_exp = torch.amax(point_exp, dim=-1)
    argmax = torch.argmax(point_exp, dim=-1).to(torch.int32)
    has_point = max_exp > 0.0
    indices = torch.where(has_point, argmax, DUSTBIN).to(torch.int32)
    probs = torch.where(has_point, max_exp / denom, -1.0)
    return SoftmaxGrid(probs=probs, indices=indices)


def exact_softmax_grid(semi: torch.Tensor) -> SoftmaxGrid:
    """Float softmax over the 65 channels of float logits (the golden
    path): probs are the dustbin-free channel maxima of exp / (sum + 1e-5),
    indices the first channel that reaches them."""
    e = torch.exp(semi)
    nodust = (e / (torch.sum(e, dim=-1, keepdim=True) + 1e-5))[..., :DUSTBIN]
    return SoftmaxGrid(probs=torch.amax(nodust, dim=-1),
                       indices=torch.argmax(nodust, dim=-1).to(torch.int32))


class TopN(NamedTuple):
    cells: torch.Tensor  # (..., N) int32 flat cell index (row-major: r*Wc + c)
    indices: torch.Tensor  # (..., N) int32 in-cell argmax channel
    probs: torch.Tensor  # (..., N) float32
    mask: torch.Tensor  # (..., N) bool — True where a feature was selected
    num_selected: torch.Tensor  # (...) int32


def top_k(x: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis with
    `jax.lax.top_k`'s order: ties go to the lower index (a stable
    descending sort; `torch.topk` promises no order on ties)."""
    vals, order = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], order[..., :k]


def top_n_select(
    grid: SoftmaxGrid, n: int = 100, valid_thresh: float = 0.01, mode: str = "reference"
) -> TopN:
    """Select ~N features by the reference's interpolated-threshold rule
    (compute_top_N, top_N.c:53-134). mode="prob" keeps the N strongest valid
    cells; mode="reference" keeps the first N threshold survivors in the
    reference's column-major scan order. Leading axes of the (..., Hc, Wc)
    grid are streams: each selects its own N."""
    hc, wc = grid.probs.shape[-2:]
    lead = grid.probs.shape[:-2]
    probs = grid.probs.reshape(*lead, hc * wc)
    indices = grid.indices.reshape(*lead, hc * wc)
    num_cells = hc * wc
    ids = torch.arange(num_cells, device=probs.device)
    scan_rank = (ids % wc) * hc + ids // wc

    valid = (indices != DUSTBIN) & (probs > valid_thresh)
    num_valid = torch.sum(valid, dim=-1).to(torch.int32)

    min_prob = torch.amin(torch.where(valid, probs, torch.inf), dim=-1)
    max_prob = torch.amax(torch.where(valid, probs, -torch.inf), dim=-1)
    split = n / torch.clamp(num_valid.to(torch.float32), min=1.0)
    threshold = max_prob * split + min_prob * (1.0 - split)
    keep = torch.where((num_valid <= n)[..., None], valid,
                       valid & (probs >= threshold[..., None]))

    if mode == "prob":
        key = torch.where(valid, probs, 0.0)
    else:
        key = torch.where(keep, (num_cells - scan_rank).to(torch.float32), 0.0)
    vals, cells = top_k(key, n)
    mask = vals > 0
    cells = torch.where(mask, cells, 0).to(torch.int32)
    selected_pool = valid if mode == "prob" else keep
    cl = cells.long()
    return TopN(
        cells=cells,
        indices=torch.take_along_dim(indices, cl, dim=-1),
        probs=torch.where(mask, torch.take_along_dim(probs, cl, dim=-1), -1.0),
        mask=mask,
        num_selected=torch.clamp(torch.sum(selected_pool, dim=-1), max=n).to(torch.int32),
    )


def subpixel_xy(
    semi_q: torch.Tensor, scale, grid: SoftmaxGrid, degree: int = 5
) -> torch.Tensor:
    """(..., Hc, Wc, 2) absolute pixel (x, y) per cell: the cell's 8x8
    origin plus the soft-argmax over the 3x3 channel neighbourhood of the
    winner (garbage where indices == 64)."""
    point = semi_q[..., :DUSTBIN]
    expx = torch.where(point >= 0, _taylor_exp_ref(point, scale, degree), 0.0)
    hc, wc = semi_q.shape[-3:-1]
    ch = torch.arange(DUSTBIN, device=semi_q.device)
    ix = (ch % 8).to(torch.int32)
    iy = (ch // 8).to(torch.int32)
    wy = grid.indices[..., None] // 8
    wx = grid.indices[..., None] % 8
    near = (torch.abs(ix - wx) <= 1) & (torch.abs(iy - wy) <= 1)
    p3 = torch.where(near, expx, 0.0)
    denom = torch.clamp(torch.sum(p3, dim=-1), min=1e-20)
    ex = torch.sum(p3 * ix, dim=-1) / denom
    ey = torch.sum(p3 * iy, dim=-1) / denom
    rows = torch.arange(hc, device=semi_q.device)[:, None].to(torch.float32)
    cols = torch.arange(wc, device=semi_q.device)[None, :].to(torch.float32)
    return torch.stack([cols * 8 + ex, rows * 8 + ey], dim=-1)


def cell_to_xy(cells: torch.Tensor, in_cell_idx: torch.Tensor, grid_w: int):
    """Flat row-major cell index and in-cell channel k -> full-resolution
    pixel (x, y): channel k is the sub-cell offset (k % 8, k // 8)."""
    row, col = cells // grid_w, cells % grid_w
    return col * 8 + in_cell_idx % 8, row * 8 + in_cell_idx // 8

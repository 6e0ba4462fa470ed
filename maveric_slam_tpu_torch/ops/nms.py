"""Non-maximum suppression (port of maveric_slam_tpu/ops/nms.py).

- `heatmap_nms`: local-max NMS on the full-resolution heatmap by max
  pooling, the fixed-shape stand-in for the golden pipeline's greedy
  `nms_fast` (tests/golden_nms.py is the greedy oracle).
- `quadrant_nms`: suppresses cell winners within L_inf < min_dist pixels of
  a stronger winner in one of the 8 neighbouring cells.

Leading axes are streams: each works on every (H, W) / (Hc, Wc) grid alone.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .softmax_topn import DUSTBIN, SoftmaxGrid


def _max_pool(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k stride-1 max pool with -inf padding ("SAME") over the last two axes."""
    h, w = x.shape[-2:]
    out = F.max_pool2d(x.reshape(-1, 1, h, w), kernel_size=k, stride=1, padding=k // 2)
    return out.reshape(x.shape)


def heatmap_nms(heatmap: torch.Tensor, dist: int = 4, conf_thresh: float = 0.015,
                border: int = 4) -> torch.Tensor:
    """Bool mask over (..., H, W): a pixel is kept iff it is above
    conf_thresh, the maximum of its (2*dist+1)^2 window, the first such
    pixel in row-major order among equal maxima of its window, and at least
    `border` px from the edge."""
    h, w = heatmap.shape[-2:]
    k = 2 * dist + 1
    is_max = heatmap >= _max_pool(heatmap, k)
    # Tie dedup: among pixels at their window's maximum keep the earliest
    # (row-major). Indices below 2^24 are exact in f32.
    idx = torch.arange(h * w, dtype=torch.float32, device=heatmap.device).reshape(h, w)
    cand = torch.where(is_max, -idx, -torch.inf)
    is_max = is_max & (-idx >= _max_pool(cand, k))
    ys = torch.arange(h, device=heatmap.device)[:, None]
    xs = torch.arange(w, device=heatmap.device)[None, :]
    in_border = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    return (heatmap >= conf_thresh) & is_max & in_border


def quadrant_nms(grid: SoftmaxGrid, min_dist: int = 4) -> SoftmaxGrid:
    """Dustbin every cell winner that lies within L_inf < min_dist px of a
    stronger winner in one of its 8 neighbouring cells (on equal probs the
    neighbour above, or to the left in the same row, wins)."""
    probs, indices = grid.probs, grid.indices
    hc, wc = probs.shape[-2:]
    rows = torch.arange(hc, device=probs.device)[:, None]
    cols = torch.arange(wc, device=probs.device)[None, :]
    x = cols * 8 + indices % 8
    y = rows * 8 + indices // 8
    valid = indices != DUSTBIN
    key = torch.where(valid, probs, -torch.inf)
    dominated = torch.zeros_like(valid)
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr == 0 and dc == 0:
                continue

            def nb(a):
                return torch.roll(a, shifts=(-dr, -dc), dims=(-2, -1))

            nb_key = nb(key)
            in_grid = (rows + dr >= 0) & (rows + dr < hc) & (cols + dc >= 0) & (cols + dc < wc)
            near = (torch.abs(nb(x) - x) < min_dist) & (torch.abs(nb(y) - y) < min_dist)
            stronger = (nb_key > key) | ((nb_key == key) & ((dr, dc) < (0, 0)))
            dominated = dominated | (nb(valid) & in_grid & near & stronger & valid)
    return SoftmaxGrid(probs=torch.where(dominated, -1.0, probs),
                       indices=torch.where(dominated, DUSTBIN, indices).to(indices.dtype))

"""Feature extraction: image -> keypoints + descriptors (port of
maveric_slam_tpu/frontend/extractor.py).

- **quantized**: int8 grids -> approximate softmax detector -> (optional
  quadrant NMS) -> top-N cells with int8 cell descriptors (the tracker's).
- **golden**: dequantized heatmap -> local-max NMS -> the K strongest
  keypoints -> bilinear descriptor interpolation + L2 norm (the pairwise
  pipeline's).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..models import superpoint as sp
from ..ops import nms as nms_ops
from ..ops import softmax_topn as st
from ..ops.kernels.detector import detector_postproc


class QuantizedFeatures(NamedTuple):
    """One frame's features; `extract_quantized_batched` gives every field
    a leading stream axis S (the scales stay () tensors)."""

    semi_q: torch.Tensor  # (Hc, Wc, 65) int8
    desc_q: torch.Tensor  # (Hc, Wc, 256) int8
    probs: torch.Tensor  # (Hc, Wc) float32 approx softmax winner prob
    indices: torch.Tensor  # (Hc, Wc) int32 winner channel (64 = none)
    xy: torch.Tensor  # (Hc, Wc, 2) float32 sub-pixel keypoint coords per cell
    top: st.TopN  # fixed-capacity top-N selection
    semi_scale: torch.Tensor
    desc_scale: torch.Tensor


def extract_quantized_batched(params, images: torch.Tensor, config: SlamConfig,
                              apply_nms: bool = False) -> QuantizedFeatures:
    """Quantized frontend on (S, H, W) images, on their device, with one
    network call, one stem launch and one detector launch for all S; the
    top-N is selected per image. On a card the stem and the detector run as
    CUDA kernels, on the CPU as their plain versions. `apply_nms` runs the
    quadrant NMS on the detector's grid; xy stays each cell's pre-NMS value
    (suppression only dustbins cells)."""
    fc = config.frontend
    s = images.shape[0]
    semi_q, desc_q, scales = sp.superpoint_int8(params, images)
    probs, idx, xy = detector_postproc(
        semi_q.reshape(s, -1, 65), scales["semi_scale"], degree=fc.exp_taylor_degree,
        grid_w=fc.grid_w, grid_h=fc.grid_h)
    grid = st.SoftmaxGrid(probs=probs.reshape(s, fc.grid_h, fc.grid_w),
                          indices=idx.reshape(s, fc.grid_h, fc.grid_w))
    if apply_nms:
        grid = nms_ops.quadrant_nms(grid, min_dist=fc.nms_dist)
    top = st.top_n_select(grid, n=fc.top_n, valid_thresh=fc.valid_prob_thresh,
                          mode=fc.top_n_mode)
    return QuantizedFeatures(
        semi_q=semi_q,
        desc_q=desc_q,
        probs=grid.probs,
        indices=grid.indices,
        xy=xy.reshape(s, fc.grid_h, fc.grid_w, 2),
        top=top,
        semi_scale=scales["semi_scale"],
        desc_scale=scales["desc_scale"],
    )


def select(feats: QuantizedFeatures, k) -> QuantizedFeatures:
    """Images `k` of batched features: an index drops the stream axis, a
    slice keeps it."""
    return QuantizedFeatures(
        *(f[k] for f in feats[:5]), st.TopN(*(f[k] for f in feats.top)),
        feats.semi_scale, feats.desc_scale)


def extract_quantized(params, image: torch.Tensor, config: SlamConfig,
                      apply_nms: bool = False) -> QuantizedFeatures:
    """Quantized frontend on one (H, W) image, on the image's device."""
    return select(extract_quantized_batched(params, image[None], config, apply_nms), 0)


class GoldenFeatures(NamedTuple):
    xy: torch.Tensor  # (K, 2) float32 pixel coords
    conf: torch.Tensor  # (K,) float32 heatmap confidence
    desc: torch.Tensor  # (K, 256) float32 L2-normalized descriptors
    mask: torch.Tensor  # (K,) bool
    num: torch.Tensor  # () int32


def _unfold_heatmap(semi: torch.Tensor, cell: int = 8) -> torch.Tensor:
    """(Hc, Wc, 65) logits -> (Hc*8, Wc*8) dustbin-free softmax heatmap."""
    e = torch.exp(semi)
    dense = e / (torch.sum(e, dim=-1, keepdim=True) + 1e-5)
    hc, wc = dense.shape[:2]
    heat = dense[..., :64].reshape(hc, wc, cell, cell)
    return heat.permute(0, 2, 1, 3).reshape(hc * cell, wc * cell)


def _bilinear_sample(grid: torch.Tensor, u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Sample (Hc, Wc, C) at fractional (v, u) with a border clamp (grid_sample
    with align_corners=False inside the image; keypoints keep off the border)."""
    hc, wc = grid.shape[:2]
    u0 = torch.clamp(torch.floor(u).to(torch.int32), 0, wc - 1)
    v0 = torch.clamp(torch.floor(v).to(torch.int32), 0, hc - 1)
    u1 = torch.clamp(u0 + 1, max=wc - 1)
    v1 = torch.clamp(v0 + 1, max=hc - 1)
    fu = torch.clamp(u - u0, 0.0, 1.0)[:, None]
    fv = torch.clamp(v - v0, 0.0, 1.0)[:, None]
    u0, u1, v0, v1 = (a.long() for a in (u0, u1, v0, v1))
    return (grid[v0, u0] * (1 - fu) * (1 - fv) + grid[v0, u1] * fu * (1 - fv)
            + grid[v1, u0] * (1 - fu) * fv + grid[v1, u1] * fu * fv)


def extract_golden(params, image: torch.Tensor, config: SlamConfig) -> GoldenFeatures:
    """Golden float frontend on one (H, W) image, on the image's device, with
    fixed capacity K = config.frontend.max_keypoints: the int8 backbone (one
    stem launch on a card), then float post-processing."""
    fc = config.frontend
    semi_q, desc_q, scales = sp.superpoint_int8(params, image[None])
    semi = semi_q[0].to(torch.float32) * scales["semi_scale"]
    desc_grid = desc_q[0].to(torch.float32) * scales["desc_scale"]
    heat = _unfold_heatmap(semi, fc.cell)  # (H, W)
    keep = nms_ops.heatmap_nms(heat, dist=fc.nms_dist, conf_thresh=fc.conf_thresh,
                               border=fc.border_remove)
    w = heat.shape[1]
    vals, flat_idx = st.top_k(torch.where(keep, heat, 0.0).reshape(-1), fc.max_keypoints)
    mask = vals > 0.0
    ys = (flat_idx // w).to(torch.float32)
    xs = (flat_idx % w).to(torch.float32)
    # Descriptor interpolation at (x/8 - 0.5, y/8 - 0.5) + L2 norm.
    desc = _bilinear_sample(desc_grid, xs / fc.cell - 0.5, ys / fc.cell - 0.5)  # (K, 256)
    desc = desc / torch.clamp(torch.linalg.vector_norm(desc, dim=-1, keepdim=True), min=1e-12)
    return GoldenFeatures(
        xy=torch.stack([xs, ys], dim=-1),
        conf=vals,
        desc=torch.where(mask[:, None], desc, 0.0),
        mask=mask,
        num=torch.sum(mask).to(torch.int32),
    )

"""Quantized feature extraction: image -> int8 grids -> detector -> top-N
(port of maveric_slam_tpu/frontend/extractor.py `extract_quantized`)."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..models import superpoint as sp
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
    CUDA kernels, on the CPU as their plain versions."""
    if apply_nms:
        raise NotImplementedError("apply_nms=True (quadrant NMS) is not ported yet")
    fc = config.frontend
    s = images.shape[0]
    semi_q, desc_q, scales = sp.superpoint_int8(params, images)
    probs, idx, xy = detector_postproc(
        semi_q.reshape(s, -1, 65), scales["semi_scale"], degree=fc.exp_taylor_degree,
        grid_w=fc.grid_w, grid_h=fc.grid_h)
    grid = st.SoftmaxGrid(probs=probs.reshape(s, fc.grid_h, fc.grid_w),
                          indices=idx.reshape(s, fc.grid_h, fc.grid_w))
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

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
    semi_q: torch.Tensor  # (Hc, Wc, 65) int8
    desc_q: torch.Tensor  # (Hc, Wc, 256) int8
    probs: torch.Tensor  # (Hc, Wc) float32 approx softmax winner prob
    indices: torch.Tensor  # (Hc, Wc) int32 winner channel (64 = none)
    xy: torch.Tensor  # (Hc, Wc, 2) float32 sub-pixel keypoint coords per cell
    top: st.TopN  # fixed-capacity top-N selection
    semi_scale: torch.Tensor
    desc_scale: torch.Tensor


def extract_quantized(params, image: torch.Tensor, config: SlamConfig,
                      apply_nms: bool = False) -> QuantizedFeatures:
    """Quantized frontend on one (H, W) image, on the image's device: the
    detector runs as the CUDA kernel on a card and as its plain version on
    the CPU."""
    if apply_nms:
        raise NotImplementedError("apply_nms=True (quadrant NMS) is not ported yet")
    fc = config.frontend
    semi_q, desc_q, scales = sp.superpoint_int8(params, image[None], stem="off")
    semi_q, desc_q = semi_q[0], desc_q[0]
    probs, idx, xy = detector_postproc(
        semi_q.reshape(-1, 65), scales["semi_scale"], degree=fc.exp_taylor_degree,
        grid_w=fc.grid_w)
    grid = st.SoftmaxGrid(probs=probs.reshape(fc.grid_h, fc.grid_w),
                          indices=idx.reshape(fc.grid_h, fc.grid_w))
    top = st.top_n_select(grid, n=fc.top_n, valid_thresh=fc.valid_prob_thresh,
                          mode=fc.top_n_mode)
    return QuantizedFeatures(
        semi_q=semi_q,
        desc_q=desc_q,
        probs=grid.probs,
        indices=grid.indices,
        xy=xy.reshape(fc.grid_h, fc.grid_w, 2),
        top=top,
        semi_scale=scales["semi_scale"],
        desc_scale=scales["desc_scale"],
    )

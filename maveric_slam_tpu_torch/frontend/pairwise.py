"""Pairwise relative pose between two frames (port of
maveric_slam_tpu/frontend/pairwise.py).

Image pair -> golden SuperPoint features -> one-way best-dot match ->
RANSAC essential matrix -> (R, t) with |t| = 1, all on the images' device.
The returned (R, t) satisfy p2 ~ R p1 + t for camera points; the camera
matrix is the working-resolution K.

Randomness: the JAX package passes a PRNG key to its RANSAC. Here the
Gumbel noise is an input (`gumbel_min` (num_hypotheses, K), `gumbel_lo`
(lo hypotheses, K), K = max_keypoints), else it is drawn from `generator`
(a torch.Generator on the images' device; None: PyTorch's default).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import SlamConfig
from ..geometry import epipolar, ransac
from ..ops import matching
from . import extractor


class PairwiseResult(NamedTuple):
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,) unit norm
    E: torch.Tensor  # (3, 3)
    num_matches: torch.Tensor  # () int32
    num_inliers: torch.Tensor  # () int32


def pairwise_pose(params, image0: torch.Tensor, image1: torch.Tensor, config: SlamConfig,
                  gumbel_min: torch.Tensor | None = None,
                  gumbel_lo: torch.Tensor | None = None,
                  generator: torch.Generator | None = None) -> PairwiseResult:
    """Relative pose from frame0 to frame1 (p1 in frame0, p2 in frame1)."""
    dev = image0.device
    feats0 = extractor.extract_golden(params, image0, config)
    feats1 = extractor.extract_golden(params, image1, config)
    m = matching.nn_match_dot(feats0.desc, feats1.desc, feats0.mask, feats1.mask,
                              dot_thresh=config.matcher.dot_thresh)
    xy1 = feats1.xy[m.index.long()]
    K = torch.from_numpy(config.working_camera.K).to(dev)
    p1n = epipolar.normalize_points(feats0.xy, K)
    p2n = epipolar.normalize_points(xy1, K)
    n_hyp, k = config.ransac.num_hypotheses, p1n.shape[0]
    if gumbel_min is None:
        gumbel_min = ransac.gumbel((n_hyp, k), generator, dev)
    if gumbel_lo is None:
        gumbel_lo = ransac.gumbel((ransac.lo_hypotheses(n_hyp), k), generator, dev)
    res = ransac.ransac_essential(p1n, p2n, m.mask, inlier_thresh=config.ransac.inlier_thresh,
                                  num_hypotheses=n_hyp, gumbel_min=gumbel_min,
                                  gumbel_lo=gumbel_lo)
    return PairwiseResult(R=res.R, t=res.t, E=res.E,
                          num_matches=torch.sum(m.mask).to(torch.int32),
                          num_inliers=res.num_inliers)

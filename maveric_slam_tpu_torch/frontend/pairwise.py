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

`pairwise_pose_batched` is the batched path: P pairs of features at the
fixed capacity K, one matcher call (the best-dot match, or LightGlue,
`models/lightglue.py`) and one `ransac_essential` over all P. Its spans:
`pairwise.batch` around the call, and inside it `pairwise.match` (with
LightGlue's own `lightglue.*` spans) and `pairwise.ransac`;
`extract_features` opens `pairwise.extract`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..config import SlamConfig
from ..geometry import epipolar, ransac
from ..models.lightglue import LightGlue, LightGlueMatches
from ..ops import matching
from ..utils.profiling import span
from . import extractor


class PairwiseResult(NamedTuple):
    R: torch.Tensor  # (3, 3)
    t: torch.Tensor  # (3,) unit norm
    E: torch.Tensor  # (3, 3)
    num_matches: torch.Tensor  # () int32
    num_inliers: torch.Tensor  # () int32


def _ransac_pose(xy0: torch.Tensor, xy1: torch.Tensor, mask: torch.Tensor, config: SlamConfig,
                 gumbel_min, gumbel_lo, generator) -> ransac.RansacResult:
    """RANSAC essential on matched pixel keypoints (..., K, 2), the noise
    drawn from `generator` where not given: gumbel_min, then gumbel_lo."""
    dev = xy0.device
    K = torch.from_numpy(config.working_camera.K).to(dev)
    p1n = epipolar.normalize_points(xy0, K)
    p2n = epipolar.normalize_points(xy1, K)
    lead, (n_hyp, k) = p1n.shape[:-2], (config.ransac.num_hypotheses, p1n.shape[-2])
    if gumbel_min is None:
        gumbel_min = ransac.gumbel((*lead, n_hyp, k), generator, dev)
    if gumbel_lo is None:
        gumbel_lo = ransac.gumbel((*lead, ransac.lo_hypotheses(n_hyp), k), generator, dev)
    return ransac.ransac_essential(p1n, p2n, mask, inlier_thresh=config.ransac.inlier_thresh,
                                   num_hypotheses=n_hyp, gumbel_min=gumbel_min,
                                   gumbel_lo=gumbel_lo)


class _Matched(NamedTuple):
    index: torch.Tensor  # ([P,] K) int64: the matched keypoint of side 1 (0 where none)
    mask: torch.Tensor  # ([P,] K) bool
    lightglue: Optional[LightGlueMatches]  # None for "dot"


def _match(feats0: extractor.GoldenFeatures, feats1: extractor.GoldenFeatures,
           config: SlamConfig, matcher) -> _Matched:
    """Side 0's keypoints matched into side 1's, with leading pair axes or
    none: `matcher` "dot" (the one-way best-dot match) or a `LightGlue`."""
    if isinstance(matcher, LightGlue):
        w, h = config.frontend.width, config.frontend.height
        lg = matcher(feats0.xy, feats1.xy, feats0.desc, feats1.desc, feats0.mask, feats1.mask,
                     (w, h))
        return _Matched(torch.clamp(lg.matches0, min=0), lg.matches0 >= 0, lg)
    if matcher == "dot":
        m = matching.nn_match_dot(feats0.desc, feats1.desc, feats0.mask, feats1.mask,
                                  dot_thresh=config.matcher.dot_thresh)
        return _Matched(m.index.long(), m.mask, None)
    raise ValueError(f"matcher must be 'dot' or a LightGlue, not {matcher!r}")


def pairwise_pose(params, image0: torch.Tensor, image1: torch.Tensor, config: SlamConfig,
                  gumbel_min: torch.Tensor | None = None,
                  gumbel_lo: torch.Tensor | None = None,
                  generator: torch.Generator | None = None) -> PairwiseResult:
    """Relative pose from frame0 to frame1 (p1 in frame0, p2 in frame1)."""
    feats0 = extractor.extract_golden(params, image0, config)
    feats1 = extractor.extract_golden(params, image1, config)
    m = _match(feats0, feats1, config, "dot")
    res = _ransac_pose(feats0.xy, feats1.xy[m.index], m.mask, config, gumbel_min, gumbel_lo,
                       generator)
    return PairwiseResult(R=res.R, t=res.t, E=res.E,
                          num_matches=torch.sum(m.mask).to(torch.int32),
                          num_inliers=res.num_inliers)


class PairwiseBatchResult(NamedTuple):
    R: torch.Tensor  # (P, 3, 3); the identity where not valid
    t: torch.Tensor  # (P, 3) unit norm; zero where not valid
    E: torch.Tensor  # (P, 3, 3); zero where not valid
    num_matches: torch.Tensor  # (P,) int32
    num_inliers: torch.Tensor  # (P,) int32; 0 where not valid
    matches: torch.Tensor  # (P, K) int32: the matched keypoint of side 1, -1 for none
    valid: torch.Tensor  # (P,) bool: at least sample_size matches and a finite pose
    log_assignment: Optional[torch.Tensor]  # (P, K + 1, K + 1) LightGlue's scores; None for "dot"
    mutual: Optional[torch.Tensor]  # (P, K) LightGlue's mutual argmax before its threshold; None for "dot"


def extract_features(params, images: torch.Tensor, config: SlamConfig) -> extractor.GoldenFeatures:
    """Golden features of (N, H, W) images, with a leading axis N: one
    `extractor.extract_golden` an image."""
    with span("pairwise.extract"):
        feats = [extractor.extract_golden(params, im, config) for im in images]
        return extractor.GoldenFeatures(*(torch.stack(f) for f in zip(*feats)))


def pairwise_pose_batched(feats0: extractor.GoldenFeatures, feats1: extractor.GoldenFeatures,
                          config: SlamConfig, matcher="dot",
                          gumbel_min: torch.Tensor | None = None,
                          gumbel_lo: torch.Tensor | None = None,
                          generator: torch.Generator | None = None) -> PairwiseBatchResult:
    """Relative poses of P pairs from their golden features (xy (P, K, 2),
    desc (P, K, 256), mask (P, K); K = max_keypoints): `matcher` "dot" (the
    one-way best-dot match of `pairwise_pose`) or a `LightGlue`, then one
    `ransac_essential` over the P pairs. The noise, where not given, is
    drawn from `generator`: gumbel_min (P, num_hypotheses, K), then
    gumbel_lo (P, lo_hypotheses, K). A pair with fewer than sample_size
    matches (or a pose that is not finite) is marked not valid, with the
    identity, a zero translation and no inliers."""
    with span("pairwise.batch"):
        with span("pairwise.match"):
            index, mask, lg = _match(feats0, feats1, config, matcher)
            xy1 = torch.take_along_dim(feats1.xy, index[..., None], dim=-2)
        with span("pairwise.ransac"):
            res = _ransac_pose(feats0.xy, xy1, mask, config, gumbel_min, gumbel_lo, generator)
            num_matches = torch.sum(mask, dim=-1).to(torch.int32)
            finite = torch.isfinite(res.R).flatten(1).all(1) & torch.isfinite(res.t).all(1)
            valid = (num_matches >= config.ransac.sample_size) & finite
            eye = torch.eye(3, dtype=res.R.dtype, device=res.R.device)
            return PairwiseBatchResult(
                R=torch.where(valid[:, None, None], res.R, eye),
                t=torch.where(valid[:, None], res.t, 0.0),
                E=torch.where(valid[:, None, None], res.E, 0.0),
                num_matches=num_matches,
                num_inliers=torch.where(valid, res.num_inliers, 0),
                matches=torch.where(mask, index, -1).to(torch.int32),
                valid=valid, log_assignment=None if lg is None else lg.scores,
                mutual=None if lg is None else lg.mutual0)

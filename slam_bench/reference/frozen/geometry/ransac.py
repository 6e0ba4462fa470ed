"""Batched LO-RANSAC for the essential matrix (port of
maveric_slam_tpu/geometry/ransac.py `ransac_essential`).

All K hypotheses are estimated and scored in one batched pass, then
`lo_rounds` LO passes of non-minimal resamples (one by default) and
score-guarded weighted refits. Nothing leaves the device: every choice is
a tensor select, so the step issues no host synchronisation.

Randomness: the JAX package draws each hypothesis's sample as a Gumbel
top-k from `jax.random`, whose bits PyTorch cannot reproduce. Here the
Gumbel noise is an input (`gumbel_min` (..., K, M), `gumbel_lo`
(..., K2, M), or (..., lo_rounds, K2, M) for lo_rounds other than 1: LO
round r's rows, which JAX draws from fold_in(key, 1 + r)); the tracker
draws it from each stream's `torch.Generator`, and tests feed both
packages the same noise. Without it, it is drawn from PyTorch's default
generator.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.softmax_topn import top_k
from . import epipolar


class RansacResult(NamedTuple):
    E: torch.Tensor  # (..., 3, 3) best essential matrix (after inlier refit)
    R: torch.Tensor  # (..., 3, 3) recovered rotation (cam1 -> cam2)
    t: torch.Tensor  # (..., 3) unit translation
    inliers: torch.Tensor  # (..., M) bool
    num_inliers: torch.Tensor  # (...) int32
    num_cheirality: torch.Tensor  # (...) int32 points passing the depth test


def lo_hypotheses(num_hypotheses: int) -> int:
    """Number of LO resamples for `num_hypotheses` minimal hypotheses."""
    return max(num_hypotheses // 4, 16)


def gumbel(shape, generator: torch.Generator | None, device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log U), U uniform in (0, 1)."""
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(torch.clamp(u, min=tiny)))


def _pick(x: torch.Tensor, i: torch.Tensor, dims: int) -> torch.Tensor:
    """x[..., i, <dims trailing axes>] per leading index, i of shape (...)."""
    i = i.reshape(i.shape + (1,) * (dims + 1))
    return torch.take_along_dim(x, i, dim=-dims - 1).squeeze(-dims - 1)


def _sample(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """p (..., M, 2), idx (..., K, k) -> the sampled points (..., K, k, 2)."""
    return torch.take_along_dim(p[..., None, :, :], idx[..., None], dim=-2)


def ransac_essential(
    p1: torch.Tensor,  # (..., M, 2) normalized points, frame A
    p2: torch.Tensor,  # (..., M, 2) normalized points, frame B
    mask: torch.Tensor,  # (..., M) bool — valid correspondences
    inlier_thresh: float,
    num_hypotheses: int = 256,
    sample_size: int = 8,
    refit_schedule: tuple = (16.0, 4.0, 1.0),
    lo_rounds: int = 1,
    refit_rounds: int = 2,
    gumbel_min: torch.Tensor | None = None,  # (..., num_hypotheses, M)
    gumbel_lo: torch.Tensor | None = None,  # (..., [lo_rounds,] lo_hypotheses(num_hypotheses), M)
) -> RansacResult:
    """Batched RANSAC + LO resampling + annealed refit + cheirality pose.
    Leading axes "..." are independent problems (streams), solved together:
    each linear-algebra stage is one batched call over all of them. Each LO
    round resamples the current best's consensus set and keeps its best
    only if that improves the MSAC score."""
    lead, m = p1.shape[:-2], p1.shape[-2]
    dev = p1.device
    thresh2 = inlier_thresh**2
    lo_k = lo_hypotheses(num_hypotheses)
    lo_shape = (*lead, lo_k, m) if lo_rounds == 1 else (*lead, lo_rounds, lo_k, m)
    if gumbel_min is None:
        gumbel_min = gumbel((*lead, num_hypotheses, m), None, dev)
    if gumbel_lo is None:
        gumbel_lo = gumbel(lo_shape, None, dev)
    if gumbel_min.shape != (*lead, num_hypotheses, m) or gumbel_lo.shape != lo_shape:
        raise ValueError(
            f"Gumbel noise must be {(*lead, num_hypotheses, m)} and {lo_shape}, got "
            f"{tuple(gumbel_min.shape)} and {tuple(gumbel_lo.shape)}")
    P1, P2 = p1[..., None, :, :], p2[..., None, :, :]  # a hypothesis axis

    def msac_score(d2):
        return torch.sum(torch.where(mask[..., None, :], torch.clamp(d2, max=thresh2), 0.0), dim=-1)

    # Minimal hypotheses: Gumbel top-k draws distinct valid points per row.
    logits = torch.where(mask, 0.0, -torch.inf)
    idx = top_k(logits[..., None, :] + gumbel_min, sample_size)[1]  # (..., K, 8)
    E = epipolar.estimate_essential(_sample(p1, idx), _sample(p2, idx))  # (..., K, 3, 3)
    scores = msac_score(epipolar.sampson_distance(E, P1, P2))  # (..., K)
    best = torch.argmin(scores, dim=-1)
    E_best = _pick(E, best, 2)
    score_best = _pick(scores, best, 0)

    # LO: 16-point resamples of the best hypothesis's consensus set, a round
    # at a time.
    for r in range(lo_rounds):
        d2b = epipolar.sampson_distance(E_best, p1, p2)
        in_gate = (d2b < 4.0 * thresh2) & mask
        lo_logits = torch.where(torch.any(in_gate, dim=-1, keepdim=True),
                                torch.where(in_gate, 0.0, -torch.inf), logits)
        g = gumbel_lo if lo_rounds == 1 else gumbel_lo[..., r, :, :]
        lo_idx = top_k(lo_logits[..., None, :] + g, 2 * sample_size)[1]
        E_lo = epipolar.estimate_essential(_sample(p1, lo_idx), _sample(p2, lo_idx))
        lo_scores = msac_score(epipolar.sampson_distance(E_lo, P1, P2))
        lo_best = torch.argmin(lo_scores, dim=-1)
        lo_score = _pick(lo_scores, lo_best, 0)
        improve = lo_score < score_best
        E_best = torch.where(improve[..., None, None], _pick(E_lo, lo_best, 2), E_best)
        score_best = torch.where(improve, lo_score, score_best)

    # Score-guarded, Cauchy-weighted refits, every gate width in one solve.
    mults = torch.tensor(refit_schedule, dtype=p1.dtype, device=dev)[:, None]  # (R, 1)
    for _ in range(refit_rounds):
        d2 = epipolar.sampson_distance(E_best, p1, p2)[..., None, :]  # (..., 1, M)
        gate = (d2 < thresh2 * mults) & mask[..., None, :]  # (..., R, M)
        w = gate * 1.0 / (1.0 + d2 / (thresh2 * mults))
        enough = torch.sum(gate, dim=-1) >= sample_size
        E_refit = epipolar.estimate_essential(P1, P2, weights=w.to(p1.dtype), project=False)
        score_new = torch.where(
            enough, msac_score(epipolar.sampson_distance(E_refit, P1, P2)), torch.inf)
        rbest = torch.argmin(score_new, dim=-1)
        r_score = _pick(score_new, rbest, 0)
        accept = r_score < score_best
        E_best = torch.where(accept[..., None, None], _pick(E_refit, rbest, 2), E_best)
        score_best = torch.where(accept, r_score, score_best)

    E_proj, R1, R2, t_unit = epipolar.project_and_decompose(E_best)
    inliers = (epipolar.sampson_distance(E_proj, p1, p2) < thresh2) & mask
    R, t, n_good = epipolar.choose_pose_by_cheirality(R1, R2, t_unit, p1, p2, weights=inliers)
    return RansacResult(
        E=E_proj, R=R, t=t, inliers=inliers,
        num_inliers=torch.sum(inliers, dim=-1).to(torch.int32),
        num_cheirality=n_good.to(torch.int32),
    )

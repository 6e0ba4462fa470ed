"""LightGlue in the port (`models/lightglue.py`) and the batched pairwise
path (`frontend/pairwise.pairwise_pose_batched`) against the plain
reference `tests/lightglue_reference.py`, on the CPU, at the published
widths (d = 256, 4 heads of 64, MLP 512) with seeded random weights and
K <= 64 keypoints a side.

Tolerances: both sides compute in float32 with TF32 off, but in another
order (scaled_dot_product_attention and fused linear layers against a
written-out softmax and separate products), so the log-assignment scores
differ by rounding, relative to the largest |score| of the pair: up to
~2e-6 at 1-2 layers and ~1.4e-6 at 9 (measured). The bars, relative to that
largest |score|, are 1e-5 and 4e-5: well below the ~1e-3 that one TF32
product (10 mantissa bits) gives.
"""

import dataclasses

import numpy as np
import pytest
import torch

import lightglue_reference as ref
from maveric_slam_tpu_torch import config as tconfig
from maveric_slam_tpu_torch.data import synthetic
from maveric_slam_tpu_torch.frontend import extractor, pairwise
from maveric_slam_tpu_torch.geometry import ransac
from maveric_slam_tpu_torch.models import lightglue as lg
from maveric_slam_tpu_torch.models import superpoint as sp
from maveric_slam_tpu_torch.utils import profiling
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

SIZE = (320, 96)  # (W, H)
HEADS = 4


def _cfg(n_layers, seed=11):
    return dataclasses.replace(tconfig.LightGlueConfig(), n_layers=n_layers, weights_seed=seed)


def _pairs(p, k, seed=0):
    """P pairs of K keypoints: image 1 holds image 0's descriptors in
    another order with noise, at other positions."""
    g = torch.Generator().manual_seed(seed)
    scale = torch.tensor(SIZE, dtype=torch.float32)
    xy0, xy1 = torch.rand(p, k, 2, generator=g) * scale, torch.rand(p, k, 2, generator=g) * scale
    d0 = torch.nn.functional.normalize(torch.randn(p, k, 256, generator=g), dim=-1)
    perm = torch.stack([torch.randperm(k, generator=g) for _ in range(p)])
    d1 = torch.take_along_dim(d0, perm[..., None], dim=1) + 0.2 * torch.randn(p, k, 256, generator=g)
    return xy0, xy1, d0, torch.nn.functional.normalize(d1, dim=-1)


def _peaked(weights, n_layers):
    """The last assignment head made decisive, so that matches pass the
    filter: final_proj 3 I, matchability bias +8."""
    w = dict(weights)
    p = f"log_assignment.{n_layers - 1}"
    w[f"{p}.final_proj.weight"] = 3.0 * torch.eye(256)
    w[f"{p}.final_proj.bias"] = torch.zeros(256)
    w[f"{p}.matchability.bias"] = torch.full((1,), 8.0)
    return w


def _reference(weights, xy0, xy1, d0, d1, n0, n1, n_layers):
    return ref.lightglue(weights, xy0[:n0], xy1[:n1], d0[:n0], d1[:n1], SIZE, n_layers, HEADS, 0.1)


def _assert_pair(out, p, want, n0, n1, k, rel):
    """Pair p of the port's (padded) output against the reference's
    unpadded answer, on the valid slots, within `rel` x the largest |score|."""
    s, m0, _ = want
    got = out.scores[p]
    tol = rel * float(s.abs().max())
    np.testing.assert_allclose(got[:n0, :n1].numpy(), s[:n0, :n1].numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(got[:n0, k].numpy(), s[:n0, n1].numpy(), rtol=0, atol=tol)
    np.testing.assert_allclose(got[k, :n1].numpy(), s[n0, :n1].numpy(), rtol=0, atol=tol)
    assert torch.equal(out.matches0[p, :n0], m0)
    assert (out.matches0[p, n0:] == -1).all()
    assert not (out.matches0[p] >= n1).any()


def test_weights_are_the_published_layout():
    """cvg/LightGlue's names and shapes, drawn as the reference draws them;
    adaptive depth and width (the published confidences) are refused."""
    w = lg.init_weights(_cfg(9), 3)
    want = ref.init_weights(9, 256, HEADS, 3)
    assert sorted(w) == sorted(want) and all(torch.equal(w[k], want[k]) for k in w)
    assert w["transformers.8.self_attn.Wqkv.weight"].shape == (768, 256)
    assert w["transformers.0.cross_attn.ffn.0.weight"].shape == (512, 512)
    assert "token_confidence.7.token.0.weight" in w and "token_confidence.8.token.0.weight" not in w
    for published in ({"depth_confidence": 0.95}, {"width_confidence": 0.99}):
        with pytest.raises(ValueError, match="adaptive"):
            lg.LightGlue(dataclasses.replace(tconfig.LightGlueConfig(), **published), device="cpu")


@pytest.mark.parametrize("n_layers", [1, 2])
def test_assignment_scores_against_reference(n_layers):
    m = lg.LightGlue(_cfg(n_layers), device="cpu")
    xy0, xy1, d0, d1 = _pairs(2, 40)
    mask = torch.ones(2, 40, dtype=torch.bool)
    out = m(xy0, xy1, d0, d1, mask, mask, SIZE)
    for p in range(2):
        want = _reference(m.weights, xy0[p], xy1[p], d0[p], d1[p], 40, 40, n_layers)
        _assert_pair(out, p, want, 40, 40, 40, 1e-5)


def test_mutual_argmax_before_the_threshold_equals_reference():
    """With random weights no match passes the filter, but the mutual
    argmax before its threshold is the reference's, and masked rows and
    columns never take part."""
    m = lg.LightGlue(_cfg(2), device="cpu")
    xy0, xy1, d0, d1 = _pairs(2, 40, seed=5)
    mask0 = torch.arange(40)[None] < torch.tensor([[40], [31]])
    mask1 = torch.arange(40)[None] < torch.tensor([[33], [40]])
    out = m(xy0, xy1, d0, d1, mask0, mask1, SIZE)
    assert (out.matches0 == -1).all()
    for p, (n0, n1) in enumerate([(40, 33), (31, 40)]):
        s, _, ms0 = _reference(m.weights, xy0[p], xy1[p], d0[p], d1[p], n0, n1, 2)
        want = torch.where(ms0 > 0, s[:n0, :n1].argmax(1), -1)
        assert int((want >= 0).sum()) >= 5
        assert torch.equal(out.mutual0[p, :n0], want)
        assert (out.mutual0[p, n0:] == -1).all() and not (out.mutual0[p] >= n1).any()


def test_matches_equal_reference():
    cfg = _cfg(2)
    w = _peaked(lg.init_weights(cfg, cfg.weights_seed), 2)
    m = lg.LightGlue(cfg, device="cpu", weights=w)
    xy0, xy1, d0, d1 = _pairs(2, 48, seed=1)
    mask = torch.ones(2, 48, dtype=torch.bool)
    out = m(xy0, xy1, d0, d1, mask, mask, SIZE)
    for p in range(2):
        want = _reference(w, xy0[p], xy1[p], d0[p], d1[p], 48, 48, 2)
        assert int((want[1] >= 0).sum()) >= 5  # the filter has matches to keep
        _assert_pair(out, p, want, 48, 48, 48, 1e-5)


def test_padded_slots_are_masked():
    """K0 != K1 valid, with garbage in the padded slots: the valid slots
    read the unpadded reference's answer, and padded slots never match."""
    cfg = _cfg(2)
    w = _peaked(lg.init_weights(cfg, cfg.weights_seed), 2)
    m = lg.LightGlue(cfg, device="cpu", weights=w)
    k, n0, n1 = 48, 37, 29
    xy0, xy1, d0, d1 = _pairs(1, k, seed=2)
    mask0, mask1 = torch.arange(k)[None] < n0, torch.arange(k)[None] < n1
    g = torch.Generator().manual_seed(9)
    d0p, d1p = d0.clone(), d1.clone()
    d0p[:, n0:] = 5.0 * torch.randn(1, k - n0, 256, generator=g)
    d1p[:, n1:] = d0[:, n0 - (k - n1):n0]  # padded copies of image 0's points: tempting matches
    out = m(xy0, xy1, d0p, d1p, mask0, mask1, SIZE)
    want = _reference(w, xy0[0], xy1[0], d0[0], d1[0], n0, n1, 2)
    assert int((want[1] >= 0).sum()) >= 5
    _assert_pair(out, 0, want, n0, n1, k, 1e-5)
    assert torch.isinf(out.scores[0, n0:k]).all() and torch.isinf(out.scores[0, :, n1:k]).all()


def test_batched_rows_equal_single_calls():
    m = lg.LightGlue(_cfg(2), device="cpu")
    xy0, xy1, d0, d1 = _pairs(3, 32, seed=3)
    mask0 = torch.arange(32)[None] < torch.tensor([[32], [20], [27]])
    mask1 = torch.arange(32)[None] < torch.tensor([[25], [32], [9]])
    out = m(xy0, xy1, d0, d1, mask0, mask1, SIZE)
    for p in range(3):
        one = m(xy0[p:p + 1], xy1[p:p + 1], d0[p:p + 1], d1[p:p + 1], mask0[p:p + 1],
                mask1[p:p + 1], SIZE)
        fin = torch.isfinite(one.scores[0])
        assert torch.equal(fin, torch.isfinite(out.scores[p]))
        # rows of a batch of 3 or 1: the same products, up to the GEMM's blocking
        np.testing.assert_allclose(out.scores[p][fin].numpy(), one.scores[0][fin].numpy(),
                                   rtol=0, atol=1e-5)
        assert torch.equal(out.matches0[p], one.matches0[0])


def test_nine_layers_against_reference():
    m = lg.LightGlue(_cfg(9), device="cpu")
    xy0, xy1, d0, d1 = _pairs(1, 24, seed=4)
    mask0, mask1 = torch.arange(24)[None] < 24, torch.arange(24)[None] < 19
    out = m(xy0, xy1, d0, d1, mask0, mask1, SIZE)
    want = _reference(m.weights, xy0[0], xy1[0], d0[0], d1[0], 24, 19, 9)
    _assert_pair(out, 0, want, 24, 19, 24, 4e-5)


@pytest.fixture(scope="module")
def scene():
    """Golden features of three frames of the 96x320 orbit."""
    cam = tconfig.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=48.0, width=320, height=96)
    d = tconfig.DEFAULT_CONFIG
    cfg = dataclasses.replace(d, camera=cam, frontend=dataclasses.replace(d.frontend, height=96, width=320),
                              ransac=dataclasses.replace(d.ransac, inlier_thresh=3.0 / 400.0))
    poses = synthetic.orbit_poses(96)
    frames = {k: torch.from_numpy(synthetic.render_box_room(cfg.working_camera.K, poses[k], 96, 320))
              for k in (0, 1, 3)}
    return cfg, sp.load_params(device="cpu"), frames


def test_batched_dot_equals_pairwise_pose(scene):
    cfg, params, frames = scene
    pairs = [(0, 1), (0, 3)]
    k, n_hyp = cfg.frontend.max_keypoints, cfg.ransac.num_hypotheses
    g = torch.Generator().manual_seed(5)
    gmin = torch.stack([ransac.gumbel((n_hyp, k), g, "cpu") for _ in pairs])
    glo = torch.stack([ransac.gumbel((ransac.lo_hypotheses(n_hyp), k), g, "cpu") for _ in pairs])
    f0 = pairwise.extract_features(params, torch.stack([frames[a] for a, _ in pairs]), cfg)
    f1 = pairwise.extract_features(params, torch.stack([frames[b] for _, b in pairs]), cfg)
    got = pairwise.pairwise_pose_batched(f0, f1, cfg, "dot", gmin, glo)
    assert got.log_assignment is None and got.valid.all()
    for p, (a, b) in enumerate(pairs):
        want = pairwise.pairwise_pose(params, frames[a], frames[b], cfg, gmin[p], glo[p])
        assert int(got.num_matches[p]) == int(want.num_matches) > 30
        assert int(got.num_inliers[p]) == int(want.num_inliers) > 30
        for name in ("R", "t", "E"):
            np.testing.assert_allclose(getattr(got, name)[p].numpy(), getattr(want, name).numpy(),
                                       rtol=0, atol=1e-6)


def test_lightglue_pairs_without_matches_are_invalid_not_nan(scene):
    """Random weights keep no match past the filter: every pair is marked
    not valid, with a finite identity pose."""
    cfg, params, frames = scene
    f = pairwise.extract_features(params, torch.stack([frames[0], frames[1]]), cfg)
    f0 = extractor.GoldenFeatures(*(x[:1] for x in f))
    f1 = extractor.GoldenFeatures(*(x[1:] for x in f))
    m = lg.LightGlue(_cfg(1), device="cpu")
    out = pairwise.pairwise_pose_batched(f0, f1, cfg, m, generator=torch.Generator().manual_seed(1))
    assert out.log_assignment.shape == (1, 1001, 1001)
    assert not out.valid.any() and int(out.num_matches[0]) < 8
    assert torch.equal(out.R[0], torch.eye(3)) and torch.isfinite(out.t).all()


def test_counters_and_spans_rise_once_a_call():
    m = lg.LightGlue(_cfg(2), device="cpu")
    xy0, xy1, d0, d1 = _pairs(3, 16, seed=6)
    mask0 = torch.arange(16)[None] < torch.tensor([[16], [10], [12]])
    mask1 = torch.ones(3, 16, dtype=torch.bool)
    feats0 = extractor.GoldenFeatures(xy0, mask0.float(), d0, mask0, mask0.sum(1))
    feats1 = extractor.GoldenFeatures(xy1, mask1.float(), d1, mask1, mask1.sum(1))
    cfg = dataclasses.replace(tconfig.DEFAULT_CONFIG, frontend=dataclasses.replace(
        tconfig.DEFAULT_CONFIG.frontend, height=96, width=320, max_keypoints=16))
    timer = profiling.Timer()
    with timer.recording():
        for call in (1, 2):
            pairwise.pairwise_pose_batched(feats0, feats1, cfg, m,
                                           generator=torch.Generator().manual_seed(call))
            assert m.counters == {"pairs": 3 * call, "layers_run": 6 * call,
                                  "keypoints": (38 + 48) * call}
    assert dict(timer.counts) == {
        "pairwise.batch": 2, "pairwise.match": 2, "pairwise.ransac": 2, "lightglue.position": 2,
        "lightglue.self": 4, "lightglue.cross": 4, "lightglue.assign": 2, "lightglue.filter": 2}

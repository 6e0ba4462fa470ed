"""The port's golden pairwise pipeline against the JAX package on the CPU:
NMS (heatmap and quadrant), the golden extractor, the NN matchers,
`pairwise_pose` with JAX's own RANSAC noise, and the `extract` / `pairwise`
CLIs, on synthetic 96x320 orbit frames (fx = 400, 96 frames a turn, as in
tests/test_synthetic_accuracy.py), at the bars of ROADMAP.md item 9.

JAX's `pairwise_pose` passes its PRNG key straight to its RANSAC, which
draws Gumbel noise over split(key, 256) for the minimal hypotheses and over
split(fold_in(key, 1), 64) for the LO resamples (geometry/ransac.py:81-88,
:116-121); `jax_pairwise_noise` rebuilds it for the port.
"""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_nms import nms_fast_numpy
from jax_spread import eagerly, within_jax_spread
from maveric_slam_tpu import config as jconfig
from maveric_slam_tpu.cli import extract as jextract_cli
from maveric_slam_tpu.frontend import extractor as jextractor
from maveric_slam_tpu.frontend import pairwise as jpairwise
from maveric_slam_tpu.models import superpoint as jsp
from maveric_slam_tpu.ops import matching as jmatching
from maveric_slam_tpu.ops import nms as jnms
from maveric_slam_tpu.ops import softmax_topn as jst
from maveric_slam_tpu_torch import config as tconfig
from maveric_slam_tpu_torch.cli import extract as textract_cli
from maveric_slam_tpu_torch.cli import pairwise as tpairwise_cli
from maveric_slam_tpu_torch.data import kitti as tkitti
from maveric_slam_tpu_torch.data import synthetic
from maveric_slam_tpu_torch.frontend import extractor as textractor
from maveric_slam_tpu_torch.frontend import pairwise as tpairwise
from maveric_slam_tpu_torch.models import superpoint as tsp
from maveric_slam_tpu_torch.ops import matching as tmatching
from maveric_slam_tpu_torch.ops import nms as tnms
from maveric_slam_tpu_torch.ops import softmax_topn as tst
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

H, W = 96, 320
PAIRS = [(0, 1), (0, 4)]  # consecutive, and a few frames apart


def _config(mod):
    cam = mod.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=48.0, width=W, height=H)
    d = mod.DEFAULT_CONFIG
    return dataclasses.replace(
        d, camera=cam, frontend=dataclasses.replace(d.frontend, height=H, width=W),
        ransac=dataclasses.replace(d.ransac, inlier_thresh=3.0 / 400.0))


JCFG, TCFG = _config(jconfig), _config(tconfig)


def jax_pairwise_noise(key, num_hypotheses, lo_k, m):
    """The Gumbel noise JAX's `pairwise_pose(..., key)` draws: (gumbel_min,
    gumbel_lo) for M = m correspondences."""
    g = jax.vmap(lambda kk: jax.random.gumbel(kk, (m,)))
    return (np.asarray(g(jax.random.split(key, num_hypotheses))),
            np.asarray(g(jax.random.split(jax.random.fold_in(key, 1), lo_k))))


@pytest.fixture(scope="module")
def frames():
    poses = synthetic.orbit_poses(96)
    K = TCFG.working_camera.K
    return {k: synthetic.render_box_room(K, poses[k], H, W) for k in (0, 1, 4)}


@pytest.fixture(scope="module")
def params():
    jp = jsp.load_params()
    return jp, tsp.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


@pytest.fixture(scope="module")
def heatmaps(frames, params):
    """JAX's golden heatmap of each frame, (H, W) f32."""
    jp, _ = params
    out = {}
    for k, f in frames.items():
        semi_q, _, sc = jsp.superpoint_int8(jp, jnp.asarray(f)[None])
        out[k] = np.asarray(jextractor._unfold_heatmap(semi_q[0].astype(jnp.float32) * sc["semi_scale"]))
    return out


def test_unfold_heatmap(frames, params, heatmaps):
    """The port's heatmap from the same int8 logits: within 3 ulp of JAX's
    (XLA's and PyTorch's exp round differently: ROADMAP.md Faults (j))."""
    _, tp = params
    for k, f in frames.items():
        semi_q, _, sc = tsp.superpoint_int8(tp, torch.from_numpy(f)[None])
        heat = textractor._unfold_heatmap(semi_q[0].to(torch.float32) * sc["semi_scale"])
        np.testing.assert_allclose(heat.numpy(), heatmaps[k], rtol=1e-6, atol=0)


def _tie_heatmaps():
    """Seeded quantized heatmaps (exact ties everywhere) and a stack of two."""
    rng = np.random.default_rng(3)
    q = (rng.integers(0, 6, size=(2, 40, 56)) / 8.0).astype(np.float32)
    return q


def test_heatmap_nms_exact(heatmaps):
    """Masks equal to JAX's on the frames' heatmaps, on quantized heatmaps
    full of ties, and per stream on a (2, H, W) stack."""
    for heat in list(heatmaps.values()) + list(_tie_heatmaps()):
        want = np.asarray(jnms.heatmap_nms(heat, dist=4, conf_thresh=0.015, border=4))
        got = tnms.heatmap_nms(torch.from_numpy(heat), dist=4, conf_thresh=0.015, border=4)
        np.testing.assert_array_equal(got.numpy(), want)
    stack = _tie_heatmaps()
    got = tnms.heatmap_nms(torch.from_numpy(stack), dist=2, conf_thresh=0.1, border=3)
    for s in range(2):
        np.testing.assert_array_equal(
            got[s].numpy(), np.asarray(jnms.heatmap_nms(stack[s], dist=2, conf_thresh=0.1, border=3)))


def test_heatmap_nms_against_greedy_oracle(heatmaps):
    """Isolated peaks (no two within the window): the local-max mask equals
    the greedy oracle's survivors exactly. On a frame's heatmap: every local
    maximum is a greedy survivor within 1 px, as tests/test_feature_ops.py
    holds the JAX mask."""
    rng = np.random.default_rng(5)
    heat = np.zeros((96, 320), np.float32)
    ys, xs = np.meshgrid(np.arange(6, 90, 10), np.arange(6, 314, 10), indexing="ij")
    ys = ys + rng.integers(-1, 2, ys.shape)
    xs = xs + rng.integers(-1, 2, xs.shape)
    heat[ys, xs] = rng.uniform(0.02, 1.0, ys.shape).astype(np.float32)
    heat += rng.uniform(0, 0.01, heat.shape).astype(np.float32)  # below conf_thresh
    mask = tnms.heatmap_nms(torch.from_numpy(heat)).numpy()
    y, x = np.where(heat >= 0.015)
    out, _ = nms_fast_numpy(np.stack([x, y, heat[y, x]]).astype(np.float64), 96, 320, 4)
    want = np.zeros_like(mask)
    want[out[1].astype(int), out[0].astype(int)] = True
    np.testing.assert_array_equal(mask, want)

    heat = heatmaps[0]
    mask = tnms.heatmap_nms(torch.from_numpy(heat)).numpy()
    y, x = np.where(heat >= 0.015)
    out, _ = nms_fast_numpy(np.stack([x, y, heat[y, x]]).astype(np.float64), H, W, 4)
    keep = out[:, (out[0] >= 4) & (out[0] < W - 4) & (out[1] >= 4) & (out[1] < H - 4)]
    want = {(int(a), int(b)) for a, b in zip(keep[0], keep[1])}
    got = {(int(a), int(b)) for b, a in zip(*np.where(mask))}

    def near(p, s):
        return any((p[0] + dx, p[1] + dy) in s for dx in range(-1, 2) for dy in range(-1, 2))

    assert got and all(near(p, want) for p in got)


def test_quadrant_nms_exact(frames, params):
    """On each frame's detector grid (JAX's jnp grid fed to both), and per
    stream on a (S, Hc, Wc) stack, with ties planted between neighbours."""
    jp, _ = params
    grids = []
    for f in frames.values():
        semi_q, _, sc = jsp.superpoint_int8(jp, jnp.asarray(f)[None])
        g = jst.approx_softmax_grid(semi_q[0], sc["semi_scale"])
        grids.append((np.asarray(g.probs), np.asarray(g.indices)))
    probs = np.stack([p for p, _ in grids])
    idx = np.stack([i for _, i in grids])
    probs[0, 5, 6] = probs[0, 5, 7] = probs[0, 6, 6] = 0.9  # planted ties
    idx[0, 5, 6], idx[0, 5, 7], idx[0, 6, 6] = 63, 56, 7
    got = tnms.quadrant_nms(tst.SoftmaxGrid(torch.from_numpy(probs), torch.from_numpy(idx)))
    n_sup = 0
    for s in range(probs.shape[0]):
        want = jnms.quadrant_nms(jst.SoftmaxGrid(probs[s], idx[s]), min_dist=4)
        np.testing.assert_array_equal(got.indices[s].numpy(), np.asarray(want.indices))
        np.testing.assert_array_equal(got.probs[s].numpy(), np.asarray(want.probs))
        n_sup += int(((np.asarray(want.indices) == 64) & (idx[s] != 64)).sum())
    assert n_sup > 0


def test_extract_quantized_with_nms(frames, params):
    """apply_nms=True: indices exact, probs at the detector's bar (rtol 1e-6),
    xy where a cell keeps its keypoint (JAX's CPU path recomputes xy from the
    suppressed grid, the port keeps the pre-NMS per-cell value), the same
    top-N cells; the batched call equals the single calls."""
    jp, tp = params
    imgs = np.stack([frames[0], frames[4]])
    batched = textractor.extract_quantized_batched(tp, torch.from_numpy(imgs), TCFG, apply_nms=True)
    for s, f in enumerate(imgs):
        want = jextractor.extract_quantized(jp, jnp.asarray(f), JCFG, apply_nms=True)
        got = textractor.extract_quantized(tp, torch.from_numpy(f), TCFG, apply_nms=True)
        plain = textractor.extract_quantized(tp, torch.from_numpy(f), TCFG)
        idx = np.asarray(want.indices)
        np.testing.assert_array_equal(got.indices.numpy(), idx)
        np.testing.assert_allclose(got.probs.numpy(), np.asarray(want.probs), rtol=1e-6, atol=0)
        v = idx != 64
        assert 0 < v.sum() < (plain.indices.numpy() != 64).sum()
        np.testing.assert_allclose(got.xy.numpy()[v], np.asarray(want.xy)[v], atol=1e-3)
        # The same cells; their order follows probs, which differ by an ulp.
        sel = got.top.cells.numpy()[got.top.mask.numpy()]
        assert set(sel) == set(np.asarray(want.top.cells)[np.asarray(want.top.mask)])
        for a, b in zip(got, textractor.select(batched, s)):
            if isinstance(a, torch.Tensor):
                assert torch.equal(a, b)


@pytest.fixture(scope="module")
def golden(frames, params):
    jp, tp = params
    return {k: (jextractor.extract_golden(jp, jnp.asarray(f), JCFG),
                textractor.extract_golden(tp, torch.from_numpy(f), TCFG)) for k, f in frames.items()}


def test_extract_golden(golden):
    """xy, mask and num exact, conf rtol 1e-6, desc rtol 1e-5."""
    for want, got in golden.values():
        assert int(got.num) == int(want.num) > 100
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        np.testing.assert_array_equal(got.xy.numpy(), np.asarray(want.xy))
        np.testing.assert_allclose(got.conf.numpy(), np.asarray(want.conf), rtol=1e-6, atol=0)
        np.testing.assert_allclose(got.desc.numpy(), np.asarray(want.desc), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("a,b", PAIRS)
def test_nn_matchers(golden, a, b):
    """Index and mask exact for both matchers: on JAX's descriptors fed to
    both, and on each package's own features."""
    (ja, ta), (jb, tb) = golden[a], golden[b]
    inputs = [((ja.desc, jb.desc, ja.mask, jb.mask), tuple(
        torch.from_numpy(np.asarray(x)) for x in (ja.desc, jb.desc, ja.mask, jb.mask))),
        ((ja.desc, jb.desc, ja.mask, jb.mask), (ta.desc, tb.desc, ta.mask, tb.mask))]
    for jargs, targs in inputs:
        for jfn, tfn, thresh in ((jmatching.nn_match_dot, tmatching.nn_match_dot, 0.8),
                                 (jmatching.nn_match_two_way, tmatching.nn_match_two_way, 0.7)):
            want = jfn(*jargs, thresh)
            got = tfn(*targs, thresh)
            m = np.asarray(want.mask)
            assert m.sum() > 20
            np.testing.assert_array_equal(got.mask.numpy(), m)
            np.testing.assert_array_equal(got.index.numpy()[m], np.asarray(want.index)[m])
            np.testing.assert_allclose(got.score.numpy()[m], np.asarray(want.score)[m],
                                       rtol=0, atol=1e-5)


@pytest.mark.parametrize("a,b", PAIRS)
def test_pairwise_pose_with_jax_noise(frames, params, a, b):
    """With JAX's noise injected, num_matches and num_inliers exact, and R, t,
    E within the tracker's bar (ROADMAP.md Faults (c)): twice JAX's own
    jitted-vs-eager spread, or 1e-4 where the spread is smaller (on frames
    0 -> 4 the spread is 1.9e-4 in t and the port equals the eager step to
    2e-8)."""
    jp, tp = params
    key = jax.random.PRNGKey(7)
    want = jpairwise.pairwise_pose(jp, jnp.asarray(frames[a]), jnp.asarray(frames[b]), JCFG, key=key)
    n_hyp = TCFG.ransac.num_hypotheses
    gmin, glo = jax_pairwise_noise(key, n_hyp, max(n_hyp // 4, 16), TCFG.frontend.max_keypoints)
    got = tpairwise.pairwise_pose(tp, torch.from_numpy(frames[a]), torch.from_numpy(frames[b]),
                                  TCFG, torch.from_numpy(gmin), torch.from_numpy(glo))
    assert int(got.num_matches) == int(want.num_matches) > 30
    assert int(got.num_inliers) == int(want.num_inliers) > 30
    eager = eagerly(jpairwise.pairwise_pose, jp, jnp.asarray(frames[a]), jnp.asarray(frames[b]), JCFG,
                    key=key)
    within_jax_spread(got, want, eager, 1e-4, ("R", "t", "E"))


def test_pairwise_pose_seeded_generator(frames, params):
    """Without injected noise the samples come from the caller's generator:
    the same seed gives the same pose."""
    _, tp = params
    out = [tpairwise.pairwise_pose(tp, torch.from_numpy(frames[0]), torch.from_numpy(frames[1]),
                                   TCFG, generator=torch.Generator().manual_seed(3))
           for _ in range(2)]
    assert torch.equal(out[0].R, out[1].R) and int(out[0].num_inliers) > 30


@pytest.fixture(scope="module")
def pngs(tmp_path_factory, frames):
    import cv2

    d = tmp_path_factory.mktemp("frames")
    paths = []
    for k in (0, 1):
        p = str(d / f"{k:06d}.png")
        cv2.imwrite(p, (frames[k] * 255).round().astype(np.uint8))
        paths.append(p)
    return paths


def test_load_frame_equals_jax(pngs):
    from maveric_slam_tpu.data import kitti as jkitti

    for p in pngs:
        np.testing.assert_array_equal(tkitti.load_frame(p), jkitti.load_frame(p))


def test_kitti_readers_equal_jax(pngs, tmp_path):
    """ImageSequence, VideoStreamer (image-directory mode), read_poses and
    relative_transforms of the port's copy equal the JAX package's."""
    from maveric_slam_tpu.data import kitti as jkitti

    d = os.path.dirname(pngs[0])
    for skip in (1, 2):
        want = list(jkitti.ImageSequence(d, 48, 160, skip=skip))
        got = list(tkitti.ImageSequence(d, 48, 160, skip=skip))
        assert len(got) == len(want) > 0
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    got, want = list(tkitti.VideoStreamer(d, 48, 160)), list(jkitti.VideoStreamer(d, 48, 160))
    assert len(got) == len(want) == len(pngs)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(4)
    path = tmp_path / "poses.txt"
    path.write_text("\n".join(" ".join(f"{v:.9e}" for v in row) for row in rng.normal(size=(5, 12))) + "\n\n")
    poses = tkitti.read_poses(str(path))
    np.testing.assert_array_equal(poses, jkitti.read_poses(str(path)))
    for g, w in zip(tkitti.relative_transforms(poses), jkitti.relative_transforms(poses)):
        np.testing.assert_array_equal(g, w)


def test_extract_cli_equals_jax(pngs, tmp_path, monkeypatch):
    """The npz arrays and the C header text equal the JAX CLI's bit for bit."""
    out = {}
    for name, cli in (("jax", jextract_cli), ("port", textract_cli)):
        args = [*pngs, "--out", str(tmp_path / f"{name}.npz"), "--gt", str(tmp_path / f"{name}_gt.npz"),
                "--c-header", str(tmp_path / f"{name}.h")]
        if name == "port":
            args += ["--device", "cpu"]
        monkeypatch.setattr(sys, "argv", [f"{name}-extract", *args])
        cli.main()
        out[name] = [tmp_path / f"{name}{s}" for s in (".npz", "_gt.npz", ".h")]
    for j, t in zip(out["jax"][:2], out["port"][:2]):
        with np.load(j) as a, np.load(t) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    assert out["jax"][2].read_bytes() == out["port"][2].read_bytes()


def test_pairwise_cli(pngs, tmp_path):
    """The port's CLI on the CPU: a 3x4 [R|t] with a rotation and a unit t,
    and the match picture."""
    npy, viz = str(tmp_path / "T.npy"), str(tmp_path / "m.png")
    tpairwise_cli.main([*pngs, "--outfile", npy, "--viz", viz, "--device", "cpu", "--seed", "1"])
    T = np.load(npy)
    assert T.shape == (3, 4)
    np.testing.assert_allclose(T[:, :3] @ T[:, :3].T, np.eye(3), atol=1e-5)
    assert abs(np.linalg.norm(T[:, 3]) - 1.0) < 1e-5
    assert os.path.getsize(viz) > 0


def test_clis_default_to_cuda(pngs, tmp_path):
    """Without --device the CLIs ask for CUDA and refuse to fall back."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        textract_cli.main([pngs[0], "--out", str(tmp_path / "f.npz")])
    with pytest.raises(RuntimeError, match="CUDA"):
        tpairwise_cli.main(pngs)

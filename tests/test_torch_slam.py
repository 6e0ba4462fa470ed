"""The port's single-device SlamSystem against the JAX package's on the
CPU, over the closing synthetic orbit of tests/test_synthetic_accuracy.py
(96x320, fx = 400, 96 frames a turn). The port is fed the JAX engine's own
RANSAC noise:

- tracking: the JAX engine's tracker starts from PRNGKey(0) and splits its
  key once a step (frontend/tracker.py:118); `jax_engine_noise` rebuilds
  each step's Gumbel noise as tests/test_torch_tracker.py does;
- loop verification: the engine splits PRNGKey(seed) once a verification
  (slam.py:971) and passes the half to its RANSAC.

The JAX engine loads its vocabulary through `refdata`, which needs the
reference's header; here its loader is replaced, inside the test, by one
that builds the same `Vocabulary` from the cached arrays.

Parts: (a) the two engines over frames 0-12 at fetch_delay 0 and 3;
(b) loop verification alone on two revisit pairs; (c) the port alone over
the 125-frame closing orbit; and the `track` CLI. The JAX engine and its
loop verification run in this file only (an XLA:CPU compile crash here
takes no other file down).
"""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maveric_slam_tpu import config as jconfig
from maveric_slam_tpu import slam as jslam
from maveric_slam_tpu.frontend import extractor as jextractor
from maveric_slam_tpu.loopclosure import vocab as jvocab
from maveric_slam_tpu.models import superpoint as jsp
from maveric_slam_tpu_torch import config as tconfig
from maveric_slam_tpu_torch import slam as tslam
from maveric_slam_tpu_torch.cli import track as track_cli
from maveric_slam_tpu_torch.data import kitti, synthetic
from maveric_slam_tpu_torch.models import superpoint as tsp
from maveric_slam_tpu_torch.utils import evaluation, trajectory
from jax_spread import eagerly, within_jax_spread
from test_torch_loopclosure import jax_vocabulary
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

H, W, ORBIT_N = 96, 320, 96
N_PARITY = 13  # part (a): frames 0-12, BA windows at frames 4, 8 and 12
N_ORBIT = 125  # part (c): ~1.3 turns, the last ~30 frames revisit mapped poses
# JAX's own jit/eager spread along part (a)'s odometry chain: the largest
# gap between the JAX engine jitted and with jit disabled over the 12 steps,
# at fetch_delay 0 and 3 (1.66e-3 in R at step 3; 0.150 and 0.142 in t:
# `python tools/torch_smoke_vs_jax.py slam --frames 13 --eager
# [--fetch-delay 3]`). The bar on each odometry step is twice it (Faults (c)).
SPREAD_R, SPREAD_T = 1.66e-3, 0.150
# Part (c)'s reference: the JAX engine (jit) on the same frames with its own
# noise, `python tools/torch_smoke_vs_jax.py slam` (the same run as
# SYNTH_ACCURACY.json): ATE 1.1266 m full, 1.5543 m odometry only; with jit
# disabled 1.7940 / 1.8044 m, the same loop closures.
JAX_LOOPS = [(110, 12, 36), (114, 16, 57), (120, 24, 100), (124, 28, 100)]


def _config(mod):
    cam = mod.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=48.0, width=W, height=H)
    d = mod.DEFAULT_CONFIG
    return dataclasses.replace(
        d, camera=cam, frontend=dataclasses.replace(d.frontend, height=H, width=W),
        ransac=dataclasses.replace(d.ransac, inlier_thresh=3.0 / 400.0))


JCFG, TCFG = _config(jconfig), _config(tconfig)


def orbit(n):
    """(frames, ground truth) of tests/test_synthetic_accuracy.py's orbit."""
    base = synthetic.orbit_poses(ORBIT_N, radius=8.0)
    gt = np.stack([base[k % ORBIT_N] for k in range(n)])
    return [synthetic.render_box_room(TCFG.working_camera.K, p, H, W) for p in gt], gt


def ransac_noise(key, m=100):
    """The Gumbel noise JAX's `ransac_essential(key, ...)` draws over M = m
    points: over split(key, 256) and split(fold_in(key, 1), 64)."""
    g = jax.vmap(lambda k: jax.random.gumbel(k, (m,)))
    return (np.array(g(jax.random.split(key, 256))),
            np.array(g(jax.random.split(jax.random.fold_in(key, 1), 64))))


def jax_engine_noise(n_steps, n_verifications, seed=0):
    """(the tracking noise of each step, the noise of each loop
    verification) of a JAX SlamSystem(seed=seed)."""
    steps, key = [], jax.random.PRNGKey(0)
    for _ in range(n_steps):
        k, key = jax.random.split(key)
        steps.append(ransac_noise(k))
    verifications, key = [], jax.random.PRNGKey(seed)
    for _ in range(n_verifications):
        key, sub = jax.random.split(key)
        verifications.append(ransac_noise(sub))
    return steps, verifications


def _recorded(slam):
    """The engine with every unpacked step kept in `slam.views`."""
    slam.views = []
    unpack = slam._packer.unpack

    def keep(flat):
        v = unpack(flat)
        slam.views.append(v)
        return v

    slam._packer.unpack = keep
    return slam


@pytest.fixture(scope="module")
def params():
    jp = jsp.load_params()
    return jp, tsp.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def run_jax(jp, frames, fetch_delay=0, windows=None):
    """The JAX engine over the frames (its vocabulary loaded from the cache);
    `windows`, if a list, receives each window BA's (input, output)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvocab, "load_reference_vocabulary", jax_vocabulary)
        if windows is not None:
            solve = jslam._window_ba_packed

            def keep(flat, *a):
                out = solve(flat, *a)
                windows.append((np.asarray(flat), np.asarray(out)))
                return out

            mp.setattr(jslam, "_window_ba_packed", keep)
        slam = _recorded(jslam.SlamSystem(jp, JCFG, ba_every=4, enable_loop_closure=True,
                                          fetch_delay=fetch_delay))
        for f in frames:
            slam.process(f)
        slam.close()
    return slam


def run_port(tp, frames, fetch_delay=0):
    """The port over the frames on the CPU with the JAX engine's noise."""
    steps, verifications = jax_engine_noise(len(frames) - 1, 64)
    slam = _recorded(tslam.SlamSystem(tp, TCFG, ba_every=4, enable_loop_closure=True,
                                      fetch_delay=fetch_delay, device="cpu",
                                      verify_noise=lambda k: verifications[k]))
    slam.process(frames[0])
    for f, noise in zip(frames[1:], steps):
        slam.process(f, *noise)
    slam.close()
    return slam


@pytest.fixture(scope="module")
def engines(params):
    """Part (a): {fetch_delay: (JAX engine, port engine)} over frames 0-12,
    and the JAX engine's window BA problems at fetch_delay 0."""
    jp, tp = params
    frames, _ = orbit(N_PARITY)
    windows = []
    runs = {fd: (run_jax(jp, frames, fd, windows if fd == 0 else None), run_port(tp, frames, fd))
            for fd in (0, 3)}
    return runs, windows


def _word_pairs(view):
    ok = view.cells_new >= 0
    return sorted(zip(view.cells_new[ok].tolist(), view.word_ids[ok].tolist()))


@pytest.mark.parametrize("fetch_delay", [0, 3])
def test_engine_counts_words_and_sightings_exact(engines, fetch_delay):
    """Per frame: matches, inliers and valid equal; the visual word of every
    selected cell and the pool's sighting table equal; the same keyframes.
    Word ids are compared cell by cell: the order of the top-N list follows
    probs that differ by an ulp between the packages (ROADMAP Faults (k),
    (l)), which swaps two features on a few frames."""
    j, t = engines[0][fetch_delay]
    assert len(j.views) == len(t.views) == N_PARITY - 1
    for k, (a, b) in enumerate(zip(j.views, t.views)):
        for name in ("num_matches", "num_inliers", "valid"):
            assert int(getattr(a, name)) == int(getattr(b, name)), (k, name)
        assert bool(b.valid) and int(b.num_inliers) > 40
        assert _word_pairs(a) == _word_pairs(b), k
        np.testing.assert_array_equal(a.sightings, b.sightings, str(k))
    assert j.kf_frames == t.kf_frames and len(t.kf_frames) >= 4
    assert [s["inliers"] for s in j.stats] == [s["inliers"] for s in t.stats]


@pytest.mark.parametrize("fetch_delay", [0, 3])
def test_engine_odometry_within_reference_spread(engines, fetch_delay):
    """Each odometry step (R, t), along each engine's own chain, within
    twice JAX's jit/eager spread along the same chain (Faults (c))."""
    j, t = engines[0][fetch_delay]
    for k, ((jR, jt), (tR, tt)) in enumerate(zip(j.rel_poses, t.rel_poses)):
        assert np.abs(tR - jR).max() <= 2 * SPREAD_R, (k, np.abs(tR - jR).max())
        assert np.abs(tt - jt).max() <= 2 * SPREAD_T, (k, np.abs(tt - jt).max())


def test_engine_window_ba_within_reference_spread(engines):
    """The port's window BA on each of the JAX engine's own window problems:
    poses within twice JAX's jit/eager spread on that window, or 1e-4
    (Faults (i))."""
    _, windows = engines
    assert len(windows) == 3
    for w, (flat, want) in enumerate(windows):
        got = tslam._window_ba_packed(torch.from_numpy(flat.copy()), TCFG, 10, 2).numpy()
        eager = eagerly(jslam._window_ba_packed.__wrapped__, jnp.asarray(flat), JCFG, 10, 2)
        within_jax_spread(got, want, eager, 1e-4, {f"window {w} R": slice(0, 72),
                                                   f"window {w} t": slice(72, 96)})


def _loop_entry(jp, frame):
    """A keyframe entry (descriptors, mask, xy) from JAX's extractor."""
    img = synthetic.render_box_room(TCFG.working_camera.K,
                                    synthetic.orbit_poses(ORBIT_N, radius=8.0)[frame % ORBIT_N], H, W)
    x = jextractor.extract_quantized(jp, jnp.asarray(img), JCFG)
    cells = np.asarray(x.top.cells)
    return (np.asarray(x.desc_q).reshape(-1, 256)[cells].astype(np.float32),
            (cells >= 0).astype(np.float32), np.asarray(x.xy).reshape(-1, 2)[cells])


@pytest.mark.parametrize("pair", [(12, 108), (24, 120)])
def test_loop_verification_matches_jax(params, pair):
    """Part (b): `_verify_loop_device` on a revisit pair (the second frame
    sees the first's view again), with the engine's first verification noise:
    inlier counts and masks equal, R and t within twice JAX's jit/eager
    spread or 1e-4 (Faults (c); an exact revisit has no baseline, so its
    translation direction is noise), the flow median within 1e-5."""
    jp, _ = params
    flat = np.concatenate([a.ravel() for f in pair for a in _loop_entry(jp, f)])
    _, sub = jax.random.split(jax.random.PRNGKey(0))
    want = np.asarray(jslam._verify_loop_device(jnp.asarray(flat), sub, JCFG, 100))
    got = tslam._verify_loop_device(torch.from_numpy(flat), TCFG, 100,
                                    *(torch.from_numpy(g) for g in ransac_noise(sub))).numpy()
    assert got[0] == want[0] >= 30
    np.testing.assert_array_equal(got[14:114], want[14:114])
    eager = eagerly(jslam._verify_loop_device.__wrapped__, jnp.asarray(flat), sub, JCFG, 100)
    within_jax_spread(got, want, eager, 1e-4, {"R": slice(1, 10), "t": slice(10, 13)})
    assert abs(got[13] - want[13]) <= 1e-5


def test_closing_orbit_125_frames(params):
    """Part (c): the port alone over the 125-frame closing orbit with the JAX
    engine's noise: tests/test_synthetic_accuracy.py's assertions, and the
    JAX engine's loop closures (frame pairs and inlier counts). Its ATE is
    not held to the JAX engine's (ROADMAP Faults (l): 2.72 m full, 3.36 m
    odometry only, against JAX's 1.127 / 1.554 m jitted and 1.794 / 1.804 m
    with jit disabled; over 16 seeds of each engine's own noise the two
    distributions agree); the 2.0 m bar of that test is not met either."""
    _, tp = params
    frames, gt = orbit(N_ORBIT)
    slam = run_port(tp, frames)
    st = slam.stats
    assert sum(s["valid"] for s in st) == len(st) == N_ORBIT - 1
    assert int(np.median([s["inliers"] for s in st])) >= 40
    assert [(e.frame, e.matched_frame, e.num_inliers) for e in slam.loop_events] == JAX_LOOPS
    for e in slam.loop_events:
        assert abs((e.frame - e.matched_frame) - ORBIT_N) <= 6 and e.num_inliers >= 30
    full = evaluation.ate(slam.trajectory(), gt)["ate_rmse"]
    odo = evaluation.ate(slam.odometry_trajectory(), gt)["ate_rmse"]
    assert full < 0.85 * odo, (full, odo)


def test_track_cli_writes_poses_and_metrics(tmp_path, monkeypatch):
    """`cli.track --device cpu` over 12 rendered frames written as PNGs,
    with --gt: one pose row a frame, and metrics.json equal to
    `evaluation.ate` / `rpe` of the engine's poses."""
    import cv2

    cfg = tconfig.DEFAULT_CONFIG  # the CLI's: 192x640, KITTI's camera rescaled
    gt = synthetic.orbit_poses(ORBIT_N, radius=8.0)[:12]
    frames = [synthetic.render_box_room(cfg.working_camera.K, p, cfg.frontend.height, cfg.frontend.width)
              for p in gt]
    img_dir, out = tmp_path / "images", tmp_path / "out"
    img_dir.mkdir()
    for k, f in enumerate(frames):
        cv2.imwrite(str(img_dir / f"{k:06d}.png"), (f * 255).round().astype(np.uint8))
    trajectory.save_kitti_poses(str(tmp_path / "gt.txt"), gt)
    kept = []
    traj = tslam.SlamSystem.trajectory
    monkeypatch.setattr(tslam.SlamSystem, "trajectory", lambda self: kept.append(traj(self)) or kept[-1])
    track_cli.main([str(img_dir), "--out-dir", str(out), "--gt", str(tmp_path / "gt.txt"),
                    "--device", "cpu", "--seed", "1"])
    poses = kitti.read_poses(str(out / "poses.txt"))
    assert poses.shape == (12, 4, 4) and len(kept) == 1
    np.testing.assert_allclose(poses, kept[0], rtol=1e-6, atol=1e-6)
    gt_read = kitti.read_poses(str(tmp_path / "gt.txt"))
    with open(out / "metrics.json") as f:
        metrics = json.load(f)
    assert metrics == {**evaluation.ate(kept[0], gt_read), **evaluation.rpe(kept[0], gt_read)}
    assert metrics["ate_rmse"] < 0.5 and metrics["rpe_rot_deg_mean"] < 1.0, metrics
    assert (out / "trajectory.ply").read_text().startswith("ply")

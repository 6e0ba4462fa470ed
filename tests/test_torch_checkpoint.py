"""The port's checkpoint/resume (maveric_slam_tpu_torch/utils/checkpoint.py)
on the CPU, over tests/test_torch_slam.py's 96x320 closing orbit with loop
closure on and BA every 4 frames:

(a) the port saves at frame 6 and a fresh engine resumes over frames 7-12,
    drawing its RANSAC noise from the restored generators: bitwise equal to
    the unbroken run in everything a checkpoint holds (tracker state and
    generators, poses, the track table, the LCD database and its cursor,
    the pool, the keyframe store with depths, loop edges, stats, loop
    events) and in `trajectory()` / `odometry_trajectory()`;
(b) tests/test_checkpoint.py's loop-edge case: retained loop edges and the
    database cursor survive a restore;
(c) against JAX: the JAX engine saves at frame 6 with its own `save`; the
    port restores it (every array bitwise equal to what JAX saved) and
    continues over frames 7-12 with the JAX engine's noise: counts and
    words equal to the unbroken JAX run's, odometry within
    tests/test_torch_slam.py's bars;
(d) a save at fetch_delay 3 with work in flight raises;
(e) the `track` CLI on 10 PNGs with --device cpu: --checkpoint, and a
    SIGKILL after a mid-run checkpoint followed by --resume writes
    poses.txt byte-equal to the unbroken run's.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from maveric_slam_tpu import slam as jslam
from maveric_slam_tpu.loopclosure import vocab as jvocab
from maveric_slam_tpu.utils import checkpoint as jcheckpoint
from maveric_slam_tpu_torch import config as tconfig
from maveric_slam_tpu_torch import slam as tslam
from maveric_slam_tpu_torch.data import synthetic
from maveric_slam_tpu_torch.models import superpoint as tsp
from maveric_slam_tpu_torch.utils import checkpoint
from test_torch_loopclosure import jax_vocabulary
from test_torch_slam import (JCFG, N_PARITY, ORBIT_N, SPREAD_R, SPREAD_T, TCFG, _recorded,
                             _word_pairs, jax_engine_noise, orbit, params)  # noqa: F401
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAVE_AT = 6  # the checkpoint holds frames 0-6; the resumed run takes 7-12


def assert_same_engine(a, b):
    """Everything a checkpoint holds bitwise equal (dtypes included), and
    the two trajectories."""
    (xa, ma), (xb, mb) = checkpoint.engine_state(a), checkpoint.engine_state(b)
    assert sorted(xa) == sorted(xb)
    for k in xa:
        assert xa[k].dtype == xb[k].dtype, k
        np.testing.assert_array_equal(xa[k], xb[k], err_msg=k)
    assert ma == mb
    for fn in ("trajectory", "odometry_trajectory"):
        np.testing.assert_array_equal(getattr(a, fn)(), getattr(b, fn)(), err_msg=fn)


def port_engine(tp, **kw):
    return tslam.SlamSystem(tp, TCFG, ba_every=4, enable_loop_closure=True, device="cpu", **kw)


@pytest.fixture(scope="module")
def frames():
    return orbit(N_PARITY)[0]


def test_port_resume_bitwise(params, frames, tmp_path):
    """(a)"""
    _, tp = params
    a = port_engine(tp)
    for k, f in enumerate(frames):
        a.process(f)
        if k == SAVE_AT:
            checkpoint.save(a, str(tmp_path))
    b = port_engine(tp)
    checkpoint.restore(b, str(tmp_path))
    assert b.frame_idx == SAVE_AT and b.db.next_slot == len(b.kf_frames) - 1
    for f in frames[SAVE_AT + 1:]:
        b.process(f)
    assert len(a.kf_frames) >= 4 and len(a.tracks.observations) > 0
    assert all(e is None or "depth_ok" in e for e in b.kf_store)
    assert_same_engine(a, b)


def test_loop_edges_and_cursor_roundtrip(params, frames, tmp_path):
    """(b) tests/test_checkpoint.py:63's case on the port: synthetic
    retained loop edges and the database cursor survive a restore."""
    _, tp = params
    a = port_engine(tp)
    for f in frames[:4]:
        a.process(f)
    rng = np.random.default_rng(0)
    for k in range(3):
        R = np.eye(3) + 0.01 * rng.standard_normal((3, 3))
        a.loop_edges.append((k, k + 10, R.astype(np.float32), rng.standard_normal(3).astype(np.float32)))
    checkpoint.save(a, str(tmp_path))
    b = port_engine(tp)
    checkpoint.restore(b, str(tmp_path))
    assert len(b.loop_edges) == 3
    for (fi, fj, R, t), (gi, gj, S, u) in zip(a.loop_edges, b.loop_edges):
        assert (fi, fj) == (gi, gj)
        np.testing.assert_array_equal(R, S)
        np.testing.assert_array_equal(t, u)
    assert b.db.next_slot == a.db.next_slot == len(a.kf_frames) - 1
    assert_same_engine(a, b)


@pytest.fixture(scope="module")
def jax_run(params, frames, tmp_path_factory):
    """The JAX engine over frames 0-12 (its vocabulary from the cache), its
    checkpoint written by its own `save` after frame 6."""
    jp, _ = params
    path = str(tmp_path_factory.mktemp("jax_ckpt"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvocab, "load_reference_vocabulary", jax_vocabulary)
        slam = _recorded(jslam.SlamSystem(jp, JCFG, ba_every=4, enable_loop_closure=True))
        for k, f in enumerate(frames):
            slam.process(f)
            if k == SAVE_AT:
                jcheckpoint.save(slam, path)
        slam.close()
    return slam, path


def test_jax_checkpoint_restores_into_port(params, frames, jax_run, tmp_path):
    """(c) The port restores the JAX engine's checkpoint bitwise and goes on
    with the JAX engine's noise as the JAX engine did."""
    j, path = jax_run
    _, tp = params
    t = _recorded(port_engine(tp))
    checkpoint.restore(t, path)
    # Every array JAX saved, as the port holds it now (the port's own save
    # of the restored engine): bitwise equal, dtypes included. JAX's PRNG
    # keys are read and ignored; the port adds its generators.
    meta = json.load(open(os.path.join(path, "meta.json")))
    with np.load(os.path.join(path, meta["state_file"])) as z:
        want = dict(z)
    got, got_meta = checkpoint.engine_state(t)
    assert sorted(set(want) - {"rng_key", "tracker_key"}) == sorted(
        set(got) - {"tracker_generator", "verify_generator"})
    for k in got:
        if k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert {k: got_meta[k] for k in meta if k != "state_file"} == {
        k: v for k, v in meta.items() if k != "state_file"}

    steps, _ = jax_engine_noise(len(frames) - 1, 0)
    for k in range(SAVE_AT + 1, len(frames)):
        t.process(frames[k], *steps[k - 1])
    t.close()
    resumed = j.views[SAVE_AT:]
    assert len(t.views) == len(resumed) == len(frames) - SAVE_AT - 1
    for k, (a, b) in enumerate(zip(resumed, t.views)):
        for name in ("num_matches", "num_inliers", "valid"):
            assert int(getattr(a, name)) == int(getattr(b, name)), (k, name)
        assert _word_pairs(a) == _word_pairs(b), k
        np.testing.assert_array_equal(a.sightings, b.sightings, str(k))
    assert j.kf_frames == t.kf_frames
    for k in range(SAVE_AT, len(frames) - 1):
        (jR, jt), (tR, tt) = j.rel_poses[k], t.rel_poses[k]
        assert np.abs(tR - jR).max() <= 2 * SPREAD_R, (k, np.abs(tR - jR).max())
        assert np.abs(tt - jt).max() <= 2 * SPREAD_T, (k, np.abs(tt - jt).max())


def test_save_refuses_work_in_flight(params, frames, tmp_path):
    """(d) At fetch_delay 3 the engine holds three frames after each call:
    a save then raises, and succeeds once `finish` has drained them."""
    _, tp = params
    slam = port_engine(tp, fetch_delay=3)
    for f in frames[:5]:
        slam.process(f)
    assert slam._pending
    with pytest.raises(ValueError, match="in flight"):
        checkpoint.save(slam, str(tmp_path))
    assert not os.path.exists(tmp_path / "meta.json")
    slam.finish()
    checkpoint.save(slam, str(tmp_path))
    assert json.load(open(tmp_path / "meta.json"))["frame_idx"] == 4


def _track(image_dir, *args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "maveric_slam_tpu_torch.cli.track", str(image_dir), "--device", "cpu",
         *args], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def test_cli_sigkill_and_resume(tmp_path):
    """(e) tests/test_fault_injection.py's cases on the port's CLI (at its
    DEFAULT_CONFIG, 192x640, on the CPU): --checkpoint leaves frame 9's
    state; a run killed after a checkpoint at frame 3 or later and then
    resumed writes the unbroken run's poses.txt byte for byte."""
    import cv2

    cfg = tconfig.DEFAULT_CONFIG
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for k, p in enumerate(synthetic.orbit_poses(ORBIT_N, radius=8.0)[:10]):
        f = synthetic.render_box_room(cfg.working_camera.K, p, cfg.frontend.height, cfg.frontend.width)
        cv2.imwrite(str(img_dir / f"{k:06d}.png"), (f * 255).round().astype(np.uint8))

    p = _track(img_dir, "--out-dir", str(tmp_path / "unbroken"), "--checkpoint", str(tmp_path / "final"))
    out, _ = p.communicate(timeout=600)
    assert p.returncode == 0, out[-3000:]
    assert json.load(open(tmp_path / "final" / "meta.json"))["frame_idx"] == 9

    ckpt = tmp_path / "ckpt"
    victim = _track(img_dir, "--out-dir", str(tmp_path / "junk"), "--checkpoint", str(ckpt),
                    "--checkpoint-every", "2")
    deadline, frame = time.time() + 600, -1
    while time.time() < deadline and frame < 3:
        if victim.poll() is not None:
            pytest.fail("the run finished before it could be killed")
        try:
            frame = json.load(open(ckpt / "meta.json"))["frame_idx"]
        except (FileNotFoundError, json.JSONDecodeError):
            pass
        time.sleep(0.05)
    victim.send_signal(signal.SIGKILL)
    victim.communicate()
    assert frame >= 3 and victim.returncode == -signal.SIGKILL

    p = _track(img_dir, "--out-dir", str(tmp_path / "resumed"), "--resume", str(ckpt))
    out, _ = p.communicate(timeout=600)
    assert p.returncode == 0, out[-3000:]
    assert "resumed at frame" in out
    a = (tmp_path / "unbroken" / "poses.txt").read_bytes()
    assert a == (tmp_path / "resumed" / "poses.txt").read_bytes()
    assert len(a.splitlines()) == 10

"""Checkpoint and resume of the port's mesh-mode SlamSystem
(maveric_slam_tpu_torch/utils/checkpoint.py, collective in mesh mode) on
the CPU, over tests/test_torch_slam.py's 96x320 orbit, frames 0-12 (BA
every 4, loop closure on), saved after frame 6:

(a) a 2-rank save restored into 2 fresh ranks that run frames 7-12 is
    bitwise equal to the unbroken 2-rank run, on every rank, in everything
    `checkpoint.engine_state` holds (the gathered ring and pool included)
    and in both trajectories; each rank's `replica_digest` matches;
(b) a 1-rank mesh's save restored into the single engine is bitwise equal
    to the unbroken 1-rank mesh, and the single engine's save restored into
    a 1-rank mesh to the unbroken single engine;
(c) the 2-rank checkpoint restored into 4 ranks: right after the restore,
    every rank's gathered `engine_state` is bitwise the saved arrays; a
    checkpoint whose ring does not divide over the mesh raises ValueError;
(d) the JAX package's mesh engine (`mesh=make_mesh(2)`) saves after frame
    6 with its own `save`; the port's 2-rank mesh restores it and runs
    frames 7-12 with the JAX engine's noise: counts, (cell, word) pairs and
    sightings equal to the unbroken JAX run's, odometry within
    tests/test_torch_slam.py's bars;
(e) `cli.track --mesh 2 --device cpu --checkpoint-every 4` on PNGs,
    killed with SIGKILL (its whole process group) after a mid-run
    checkpoint and then run with `--resume`, writes poses.txt byte-equal
    to the unbroken mesh run's; so does a run of two processes with
    torchrun's environment that checkpoints at its end and one that
    resumes from there.
The ranks import neither JAX nor the JAX package (tests/torch_mesh_worker.py).
"""

import dataclasses
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
from maveric_slam_tpu.models import superpoint as jsp
from maveric_slam_tpu.parallel import mesh as jmesh
from maveric_slam_tpu.utils import checkpoint as jcheckpoint
from maveric_slam_tpu_torch import config as tconfig
from maveric_slam_tpu_torch.data import synthetic
from maveric_slam_tpu_torch.parallel import mesh as tmesh
import torch_mesh_worker as worker
from test_torch_loopclosure import jax_vocabulary
from test_torch_multihost import _run_ranks
from test_torch_slam import (JCFG, N_PARITY, ORBIT_N, SPREAD_R, SPREAD_T, TCFG, _recorded,
                             _word_pairs, jax_engine_noise, orbit)
import torch_threads

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SAVE_AT = 6  # the checkpoints hold frames 0-6; the resumed runs take 7-12
SPAWN_TIMEOUT_S = 300


def mesh_run(n, **kw):
    """Every rank's `worker.engine` result on an n-rank gloo mesh (one
    thread a rank)."""
    return tmesh.spawn(worker.mesh_engine_with, n, args=(dict(config=TCFG, **kw),), device="cpu",
                       threads=1, timeout_s=SPAWN_TIMEOUT_S)


def single_run(**kw):
    """`worker.engine` alone in this process, on one thread as the ranks."""
    return worker.engine(TCFG, **kw)


def saved_fingerprint(path):
    meta = json.load(open(os.path.join(path, "meta.json")))
    with np.load(os.path.join(path, meta["state_file"])) as z:
        return worker.fingerprint(dict(z)), {k: v for k, v in meta.items() if k != "state_file"}


def assert_same_run(a, b):
    """Everything a checkpoint holds bitwise equal (dtypes and shapes
    included), equal metas and replica digests, both trajectories."""
    assert a["state"] == b["state"]
    assert a["meta"] == b["meta"]
    np.testing.assert_array_equal(a["digest"], b["digest"])
    for name in ("trajectory", "odometry"):
        np.testing.assert_array_equal(a[name], b[name], err_msg=name)


@pytest.fixture(scope="module")
def frames():
    return orbit(N_PARITY)[0]


@pytest.fixture(scope="module")
def two(frames, tmp_path_factory):
    """The unbroken 2-rank run (saving after frame 6) and its resume."""
    path = str(tmp_path_factory.mktemp("mesh2"))
    unbroken = mesh_run(2, frames=frames, save_at=SAVE_AT, save_dir=path)
    resumed = mesh_run(2, frames=frames, restore_dir=path)
    return unbroken, resumed, path


def test_mesh_resume_bitwise(two):
    """(a)"""
    unbroken, resumed, _ = two
    assert unbroken[0]["windows"] == [4, 8, 12] and resumed[0]["windows"] == [8, 12]
    assert len(unbroken[0]["kf_frames"]) >= 4 and unbroken[0]["next_slot"] > 0
    for a, b in zip(unbroken, resumed):
        assert_same_run(a, b)
        assert a["stats"] == b["stats"] and a["loops"] == b["loops"]


def test_mesh_ranks_and_digests_agree(two):
    """(a) Every rank of both runs holds the same whole state."""
    unbroken, resumed, _ = two
    for runs in (unbroken, resumed):
        for r in runs[1:]:
            assert_same_run(runs[0], r)
    np.testing.assert_array_equal(resumed[0]["restored_digest"], resumed[1]["restored_digest"])


def test_mesh_save_writes_the_single_engine_format(two):
    """(a) The 2-rank checkpoint is the whole state: the resumed ranks
    gathered exactly the saved arrays back, with a single engine's keys."""
    _, resumed, path = two
    saved, meta = saved_fingerprint(path)
    for r in resumed:
        assert r["restored"] == saved and r["restored_meta"] == meta
    assert saved["db_multihot"][:2] == ("int8", (TCFG.loop.max_db_frames, TCFG.loop.vocab_size))
    assert saved["db_valid"][0] == "bool" and saved["pool_first_seen"][1] == (TCFG.loop.vocab_size,)


@pytest.fixture(scope="module")
def one_and_single(frames, tmp_path_factory):
    """(b) The 1-rank mesh and the single engine, each saving after frame
    6, and each checkpoint resumed by the other."""
    mesh_path = str(tmp_path_factory.mktemp("mesh1"))
    single_path = str(tmp_path_factory.mktemp("single"))
    mesh1 = mesh_run(1, frames=frames, save_at=SAVE_AT, save_dir=mesh_path)[0]
    single = single_run(frames=frames, save_at=SAVE_AT, save_dir=single_path)
    single_from_mesh = single_run(frames=frames, restore_dir=mesh_path)
    mesh_from_single = mesh_run(1, frames=frames, restore_dir=single_path)[0]
    return mesh1, single, single_from_mesh, mesh_from_single


def test_one_rank_mesh_checkpoint_resumes_in_single_engine(one_and_single):
    """(b)"""
    mesh1, _, single_from_mesh, _ = one_and_single
    assert_same_run(mesh1, single_from_mesh)


def test_single_engine_checkpoint_resumes_in_one_rank_mesh(one_and_single):
    """(b) ... and the single engine and the 1-rank mesh are one engine."""
    mesh1, single, _, mesh_from_single = one_and_single
    assert_same_run(single, mesh_from_single)
    assert_same_run(single, mesh1)


def test_two_rank_checkpoint_reshards_into_four(frames, two):
    """(c)"""
    _, _, path = two
    saved, meta = saved_fingerprint(path)
    four = mesh_run(4, frames=frames[:SAVE_AT + 1], restore_dir=path)
    for r in four:
        assert r["restored"] == saved and r["restored_meta"] == meta
        np.testing.assert_array_equal(r["restored_digest"], four[0]["restored_digest"])


def test_restore_refuses_a_ring_that_does_not_divide(frames, tmp_path):
    """(c) A single engine with a 4095-frame ring saves; a 2-rank mesh
    (whose own ring is 4096) cannot take its rows."""
    odd = dataclasses.replace(TCFG, loop=dataclasses.replace(TCFG.loop, max_db_frames=4095))
    worker.engine(odd, frames[:2], save_at=1, save_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="ValueError: the checkpoint's 4095 LCD ring frames do "
                                           "not divide over a mesh of 2 ranks"):
        mesh_run(2, frames=frames[:2], restore_dir=str(tmp_path))


@pytest.fixture(scope="module")
def jax_mesh(frames, tmp_path_factory):
    """The JAX engine on a 2-device mesh over frames 0-12 (its vocabulary
    from the cache), saved after frame 6 by its own `save`; the port's
    2-rank mesh resumed from that checkpoint with the JAX engine's noise."""
    path = str(tmp_path_factory.mktemp("jax_mesh"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvocab, "load_reference_vocabulary", jax_vocabulary)
        j = _recorded(jslam.SlamSystem(jsp.load_params(), JCFG, ba_every=4, enable_loop_closure=True,
                                       mesh=jmesh.make_mesh(2)))
        for k, f in enumerate(frames):
            j.process(f)
            if k == SAVE_AT:
                jcheckpoint.save(j, path)
        j.close()
    steps, _ = jax_engine_noise(len(frames) - 1, 0)
    port = mesh_run(2, frames=frames, step_noise=steps, restore_dir=path)
    return j, port, path


def test_jax_mesh_checkpoint_restores_into_port_mesh(jax_mesh):
    """(d) Every array JAX's mesh saved, as the port's 2 ranks hold it right
    after the restore (JAX's PRNG keys are read and ignored)."""
    _, port, path = jax_mesh
    saved, meta = saved_fingerprint(path)
    for r in port:
        got = r["restored"]
        assert sorted(set(saved) - {"rng_key", "tracker_key"}) == sorted(
            set(got) - {"tracker_generator", "verify_generator"})
        assert all(got[k] == saved[k] for k in got if k in saved)
        assert {k: r["restored_meta"][k] for k in meta} == meta


def test_jax_mesh_checkpoint_resumes_within_bars(jax_mesh):
    """(d) Frames 7-12 on the port's mesh against the unbroken JAX mesh run:
    tests/test_torch_slam.py's bars."""
    j, port, _ = jax_mesh
    t = port[0]
    resumed = j.views[SAVE_AT:]
    assert len(t["views"]) == len(resumed) == N_PARITY - SAVE_AT - 1
    for k, (a, b) in enumerate(zip(resumed, t["views"])):
        for name in ("num_matches", "num_inliers", "valid"):
            assert int(getattr(a, name)) == int(b[name]), (k, name)
        assert _word_pairs(a) == _word_pairs(_View(b)), k
        np.testing.assert_array_equal(a.sightings, b["sightings"], str(k))
    assert j.kf_frames == t["kf_frames"]
    for k in range(SAVE_AT, N_PARITY - 1):
        (jR, jt), (tR, tt) = j.rel_poses[k], t["rel"][k]
        assert np.abs(tR - jR).max() <= 2 * SPREAD_R, (k, np.abs(tR - jR).max())
        assert np.abs(tt - jt).max() <= 2 * SPREAD_T, (k, np.abs(tt - jt).max())
    assert_same_run(port[0], port[1])


class _View:
    def __init__(self, d):
        self.__dict__.update(d)


def _track(image_dir, *args):
    """The track CLI over 2 ranks on the CPU, in a process group of its own
    (so that a SIGKILL takes the ranks with it, as a preemption would)."""
    env = torch_threads.subprocess_env(PYTHONPATH=REPO)
    return subprocess.Popen(
        [sys.executable, "-m", "maveric_slam_tpu_torch.cli.track", str(image_dir), "--device", "cpu",
         "--mesh", "2", *args], env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        start_new_session=True)


@pytest.fixture(scope="module")
def img_dir(tmp_path_factory):
    """8 orbit frames at the CLI's DEFAULT_CONFIG (192x640) as PNGs."""
    import cv2

    cfg = tconfig.DEFAULT_CONFIG
    d = tmp_path_factory.mktemp("images")
    for k, p in enumerate(synthetic.orbit_poses(ORBIT_N, radius=8.0)[:8]):
        f = synthetic.render_box_room(cfg.working_camera.K, p, cfg.frontend.height, cfg.frontend.width)
        cv2.imwrite(str(d / f"{k:06d}.png"), (f * 255).round().astype(np.uint8))
    return d


def test_cli_mesh_sigkill_and_resume(img_dir, tmp_path):
    """(e) The unbroken mesh run; a run killed after a checkpoint at frame
    3 and resumed writes the same poses.txt byte for byte."""
    p = _track(img_dir, "--out-dir", str(tmp_path / "unbroken"))
    out, _ = p.communicate(timeout=600)
    assert p.returncode == 0, out[-3000:]
    assert "mesh of 2 ranks over gloo" in out

    ckpt = tmp_path / "ckpt"
    victim = _track(img_dir, "--out-dir", str(tmp_path / "junk"), "--checkpoint", str(ckpt),
                    "--checkpoint-every", "4")
    deadline, frame = time.time() + 600, -1
    while time.time() < deadline and frame < 3:
        if victim.poll() is not None:
            pytest.fail("the run finished before it could be killed")
        try:
            frame = json.load(open(ckpt / "meta.json"))["frame_idx"]
        except (FileNotFoundError, json.JSONDecodeError):
            pass
        time.sleep(0.05)
    os.killpg(victim.pid, signal.SIGKILL)
    victim.communicate()
    assert frame == 3 and victim.returncode == -signal.SIGKILL
    assert not (tmp_path / "junk" / "poses.txt").exists()

    p = _track(img_dir, "--out-dir", str(tmp_path / "resumed"), "--resume", str(ckpt))
    out, _ = p.communicate(timeout=600)
    assert p.returncode == 0, out[-3000:]
    assert out.count("resumed at frame 4") == 1  # rank 0 prints, rank 1 does not
    a = (tmp_path / "unbroken" / "poses.txt").read_bytes()
    assert a == (tmp_path / "resumed" / "poses.txt").read_bytes()
    assert len(a.splitlines()) == 8


def test_cli_mesh_checkpoint_under_torchrun_environment(img_dir, tmp_path):
    """(e) Two processes with torchrun's environment (the same threads in
    every run): frames 0-4 unbroken, and frames 0-2 with --checkpoint, then
    --resume from there: byte-equal poses.txt."""
    ckpt = str(tmp_path / "ckpt")

    def track(frames, out, *args):
        return _run_ranks([sys.executable, "-m", "maveric_slam_tpu_torch.cli.track", str(img_dir),
                           "--device", "cpu", "--mesh", "2", "--max-frames", str(frames),
                           "--out-dir", str(tmp_path / out), *args], 2)

    runs = [track(5, "unbroken"), track(3, "first", "--checkpoint", ckpt),
            track(5, "resumed", "--resume", ckpt)]
    for (code0, out0), (code1, out1) in runs:
        assert code0 == 0 and code1 == 0, out0 + out1
        assert "wrote" in out0 and "wrote" not in out1
    assert json.load(open(os.path.join(ckpt, "meta.json")))["frame_idx"] == 2
    assert "resumed at frame 3" in runs[2][0][1]
    a = (tmp_path / "unbroken" / "poses.txt").read_bytes()
    assert a == (tmp_path / "resumed" / "poses.txt").read_bytes() and len(a.splitlines()) == 5

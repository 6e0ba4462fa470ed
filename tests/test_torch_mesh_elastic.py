"""The port's elastic recovery of the mesh-mode engine
(maveric_slam_tpu_torch/utils/elastic.py `MeshElasticRunner`) on the CPU:
tests/test_elastic.py's four scenarios at 2 gloo ranks, on frames 0-11 of
tests/test_torch_slam.py's 96x320 orbit (tests/test_elastic.py's KITTI
frames are not in the repository), with loop closure on and BA every 4, so that the
frame-sharded LCD ring and the word-sharded pool are checkpointed every 4
frames and resharded into each fresh group. A crash in rank 1 and a hang
in rank 0 are each detected and recovered with exactly one restart of the
whole group, to a trajectory bitwise equal to the unbroken run's; a
corrupted state is detected; a permanent fault spends the restart budget
and raises. The ranks import neither JAX nor the JAX package
(tests/torch_mesh_worker.py)."""

import numpy as np
import pytest

from maveric_slam_tpu_torch.utils import elastic
import torch_mesh_worker as worker
from test_torch_slam import TCFG, orbit
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

RANKS = 2
HANG_DEADLINE_S = 15.0  # a step at 96x320 takes well under a second on one thread


def runner(tmp_path=None, **kw):
    kw.setdefault("checkpoint_every", 4)
    return elastic.MeshElasticRunner(
        RANKS, TCFG, checkpoint_dir=None if tmp_path is None else str(tmp_path), device="cpu",
        threads=1, attempt_timeout_s=300, ba_every=4, enable_loop_closure=True, **kw)


@pytest.fixture(scope="module")
def frames():
    return orbit(12)[0]


@pytest.fixture(scope="module")
def unbroken(frames):
    r = runner()
    run = r.run(frames)
    assert r.restarts == 0 and r.failures == []
    assert [a["failure"] for a in r.attempts] == [None]
    assert sorted(r.attempts[0]["saves"]) == [3, 7, 11]
    r.close()
    return run


def test_unbroken_run_holds_the_sharded_state(unbroken):
    """The run that every recovery is held against went through BA windows
    and keyframes, so the checkpoints held a written ring and pool."""
    assert len(unbroken.trajectory) == 12 and np.isfinite(unbroken.trajectory).all()
    assert len(unbroken.kf_frames) >= 3 and all(s["valid"] for s in unbroken.stats)


def test_crash_recovers_to_identical_trajectory(frames, tmp_path, unbroken):
    r = runner(tmp_path, fault_hook=worker.Fault(("crash", 0, 1, 7)))
    run = r.run(frames)
    assert r.restarts == 1
    assert r.failures[0].startswith("frame 7: rank 1:") and "injected device fault" in r.failures[0]
    first, second = r.attempts
    assert first["failed_at"] == 7 and second["resumed_at"] == 3 and second["failure"] is None
    np.testing.assert_array_equal(run.trajectory, unbroken.trajectory)
    np.testing.assert_array_equal(run.odometry, unbroken.odometry)
    assert run.stats == unbroken.stats and run.kf_frames == unbroken.kf_frames


def test_hang_detected_and_recovered(frames, tmp_path, unbroken):
    """Rank 0's step at frame 10 never returns: the rank's detector raises
    at the deadline (rank 1, blocked in a collective, does too), the group
    is killed and a fresh one resumes from frame 7's checkpoint."""
    r = runner(tmp_path, fault_hook=worker.Fault(("hang", 0, 0, 10)),
               step_timeout_s=HANG_DEADLINE_S)
    run = r.run(frames)
    assert r.restarts == 1
    assert r.failures[0].startswith("frame 10: rank ")
    assert f"exceeded {HANG_DEADLINE_S}s" in r.failures[0]
    assert r.attempts[0]["failed_at"] == 10 and r.attempts[1]["resumed_at"] == 7
    np.testing.assert_array_equal(run.trajectory, unbroken.trajectory)


def test_state_corruption_detected(frames, tmp_path):
    r = runner(tmp_path, fault_hook=worker.Fault(("corrupt", 0, 1, 5)), max_restarts=0)
    with pytest.raises(elastic.StateCorruption, match="frame 5: rank 1: non-rigid rotation"):
        r.run(frames)
    assert r.restarts == 1


def test_restart_budget_exhausts(frames, tmp_path):
    r = runner(tmp_path, fault_hook=worker.Fault(("crash", None, 1, 5)), max_restarts=2)
    with pytest.raises(elastic.StepCrash, match="frame 5: rank 1: RuntimeError"):
        r.run(frames)
    assert r.restarts == 3  # the budget (2) + the final raising attempt
    assert r.failures == ["frame 5: rank 1: RuntimeError('injected device fault')"] * 3
    assert [a["resumed_at"] for a in r.attempts] == [-1, 3, 3]

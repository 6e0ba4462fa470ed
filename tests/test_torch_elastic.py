"""The port's failure detection and elastic recovery
(maveric_slam_tpu_torch/utils/elastic.py) on the CPU: tests/test_elastic.py's
four scenarios, on frames 0-9 of tests/test_torch_slam.py's 96x320 orbit.
An injected crash and a hung step are each detected and recovered from the
last checkpoint, and the finished trajectory equals the unbroken run's
bitwise (the RANSAC noise comes from the generators, which the checkpoint
restores); a corrupted state is detected; a permanent fault exhausts the
restart budget."""

import threading

import numpy as np
import pytest

from maveric_slam_tpu_torch.models import superpoint as tsp
from maveric_slam_tpu_torch.utils import elastic
from test_torch_slam import TCFG, orbit
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

KW = dict(ba_every=0, enable_loop_closure=False, device="cpu")
HANG_DEADLINE_S = 15.0  # a step at 96x320 takes well under a second


@pytest.fixture(scope="module")
def params():
    return tsp.load_params(device="cpu")


@pytest.fixture(scope="module")
def frames():
    return orbit(10)[0]


@pytest.fixture(scope="module")
def unbroken(params, frames):
    runner = elastic.ElasticRunner(params, TCFG, checkpoint_every=4, **KW)
    system = runner.run(frames)
    assert runner.restarts == 0 and runner.failures == []
    runner.close()
    return system.trajectory()


def test_crash_recovers_to_identical_trajectory(params, frames, tmp_path, unbroken):
    fired = []

    def hook(i, img):
        if i == 7 and not fired:
            fired.append(i)
            raise RuntimeError("injected device fault")

    runner = elastic.ElasticRunner(params, TCFG, checkpoint_dir=str(tmp_path), checkpoint_every=4,
                                   fault_hook=hook, **KW)
    system = runner.run(frames)
    assert runner.restarts == 1
    assert "frame 7" in runner.failures[0] and "injected device fault" in runner.failures[0]
    np.testing.assert_array_equal(system.trajectory(), unbroken)


def test_hang_detected_and_recovered(params, frames, tmp_path, unbroken):
    """The first engine's step at frame 6 blocks until the run is over, past
    the 15 s deadline (tests/test_torch_mesh_elastic.py's: no wall clock
    under load reaches it); the engine recovery builds is honest (a
    transient wedge). The wedged step is released and joined at the end."""
    wedged, release = [], threading.Event()
    runner = elastic.ElasticRunner(params, TCFG, checkpoint_dir=str(tmp_path), checkpoint_every=4,
                                   step_timeout_s=HANG_DEADLINE_S, **KW)
    process = runner.system.process

    def sluggish(image):
        if runner.system.frame_idx + 1 == 6 and not wedged:
            wedged.append(threading.current_thread())
            release.wait()
        return process(image)

    runner.system.process = sluggish
    try:
        system = runner.run(frames)
    finally:
        release.set()
        for t in wedged:
            t.join(HANG_DEADLINE_S)
    assert wedged and not any(t.is_alive() for t in wedged)
    assert runner.restarts == 1
    assert "frame 6" in runner.failures[0] and f"exceeded {HANG_DEADLINE_S}s" in runner.failures[0]
    np.testing.assert_array_equal(system.trajectory(), unbroken)


def test_state_corruption_detected(params, frames):
    runner = elastic.ElasticRunner(params, TCFG, checkpoint_every=0, max_restarts=0, **KW)
    runner.system.process(frames[0])
    runner.system.process(frames[1])
    elastic.FailureDetector.validate(runner.system)
    runner.system.poses[-1][:3, :3] *= 3.0  # breaks det(R) == 1
    with pytest.raises(elastic.StateCorruption, match="frame 1"):
        elastic.FailureDetector.validate(runner.system)
    runner.system.poses[-1][0, 3] = np.nan
    with pytest.raises(elastic.StateCorruption, match="non-finite pose at frame 1"):
        elastic.FailureDetector.validate(runner.system)
    runner.close()


def test_restart_budget_exhausts(params, frames, tmp_path):
    def hook(i, img):
        if i == 5:
            raise RuntimeError("permanent fault")

    runner = elastic.ElasticRunner(params, TCFG, checkpoint_dir=str(tmp_path), checkpoint_every=4,
                                   max_restarts=2, fault_hook=hook, **KW)
    with pytest.raises(elastic.StepCrash, match="permanent fault"):
        runner.run(frames)
    assert runner.restarts == 3  # the budget (2) + the final raising attempt
    assert runner.failures == [f"frame 5: fault hook: RuntimeError('permanent fault')"] * 3

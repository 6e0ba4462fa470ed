"""A whole run on the CPU at 96x320, with the look for a card skipped:
sound, it is correct; with each fault that the cell can have planted in
the timed path, and with the control, it is not. The control on the
card at the cell's own size is `test_control_on_the_card`."""

import json
import os
import subprocess
import sys
import time

import pytest
import torch

from slam_bench import controls, harness

from .conftest import cpu_threads

STREAMS = {"streams": 2, "sample_steps": 2, "warm_steps": 2}
ENGINE = {"warm_frames": 100, "sample_frames": 16, "sample_ba": 4, "sample_pg": 4}


def _run(at_root, bench, small, workload, traffic, plant, seconds):
    cpu_threads()
    res = harness.resolve(bench, workload, at_root)
    res.config = small
    res.traffic = {**res.traffic, **traffic}
    with controls.restored(harness.port_modules()):
        return harness.run_cell(res, 2**33 + 11, seconds, False, torch.device("cpu"),
                                time.perf_counter(), plant=plant)


@pytest.mark.parametrize("plant", ["none", "state_unchanged", "answer_altered", "one_slot_altered",
                                   "half_batch", "control_int4"])
def test_streams_cell(at_root, bench, small, plant):
    out = _run(at_root, bench, small, "kitti192_streams16", STREAMS, controls.PLANTS[plant], 2.0)
    assert out["correct"] == (plant == "none"), out["numbers"]


@pytest.mark.parametrize("plant", ["none", "state_unchanged", "answer_altered", "one_slot_altered",
                                   "ba_unchanged", "pg_unchanged"])
def test_engine_cell(at_root, bench, small, plant):
    out = _run(at_root, bench, small, "kitti192_engine_patrol", ENGINE, controls.PLANTS[plant], 3.0)
    assert out["correct"] == (plant == "none"), out["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["kitti192_engine_patrol", "kitti376_streams16",
                                      "kitti192_streams16"])
def test_control_on_the_card(at_root, workload):
    """The control on three seeds at the cell's own size: never correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "slam_bench/controls.py", "--workload", workload, "--plant", "control_int4",
         "--seeds", str(2**33 + 1), str(2**33 + 2), str(2**33 + 3), "--seconds", "6"],
        cwd=at_root, capture_output=True, text=True, timeout=900, env={**os.environ})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert len(lines) == 3
    assert not any(x["correct"] for x in lines), [x["numbers"] for x in lines]

"""Shared set-up of the benchmark's tests: they run from the root of the
checkout, on the CPU, at the small size of `data/sp_test_96x320.json`."""

import json
import os
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
DATA = Path(__file__).resolve().parent / "data"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


@pytest.fixture
def at_root(monkeypatch):
    monkeypatch.chdir(ROOT)
    return ROOT


@pytest.fixture
def bench():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def small():
    """The CPU tests' configuration: sp_kitti_192x640 at 96x320."""
    return json.loads((DATA / "sp_test_96x320.json").read_text())


def cpu_threads():
    import torch

    torch.set_num_threads(min(4, os.cpu_count() or 1))

"""The PyTorch port's scaffold: config parity with the JAX package, import
isolation (no JAX in the port), and that no entry point falls back to the
CPU on its own."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from maveric_slam_tpu import config as jax_config
from maveric_slam_tpu_torch import config as torch_config
from maveric_slam_tpu_torch.ops.backend import resolve_device

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_config_asdict_equal():
    assert dataclasses.asdict(torch_config.DEFAULT_CONFIG) == dataclasses.asdict(
        jax_config.DEFAULT_CONFIG
    )
    np.testing.assert_array_equal(
        torch_config.DEFAULT_CONFIG.working_camera.K,
        jax_config.DEFAULT_CONFIG.working_camera.K,
    )


def test_port_imports_no_jax():
    """Importing the port and every submodule loads neither jax nor the JAX
    package (run in a fresh interpreter: this test process has both)."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import maveric_slam_tpu_torch as m\n"
        "names = [n.name for n in pkgutil.walk_packages(m.__path__, m.__name__ + '.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')"
        " or k == 'maveric_slam_tpu' or k.startswith('maveric_slam_tpu.'))\n"
        "assert len(names) >= 20, names\n"
        "print('BAD', bad)\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_resolve_device():
    assert resolve_device("cpu") == torch.device("cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device("cuda")


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    from maveric_slam_tpu_torch.frontend.tracker import Tracker
    from maveric_slam_tpu_torch.models import superpoint as sp

    with pytest.raises(RuntimeError, match="CUDA"):
        sp.load_params()
    params = sp.load_params(device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        Tracker(params, torch_config.DEFAULT_CONFIG)


def test_unported_options_raise():
    from maveric_slam_tpu_torch.models import superpoint as sp

    params = sp.load_params(device="cpu")
    img = torch.zeros(1, 16, 16)
    for stem in ("interpret", "on"):  # "interpret" is a JAX-only mode
        with pytest.raises(ValueError, match="stem"):
            sp.superpoint_int8(params, img, stem=stem)


def test_kernel_wrappers_validate_inputs():
    from maveric_slam_tpu_torch.ops.kernels import detector, match, nullspace, stem, svd3

    with pytest.raises(TypeError):
        detector.detector_postproc(torch.zeros(80, 65), torch.tensor(1.0))
    with pytest.raises(ValueError):
        detector.detector_postproc(torch.zeros(81, 65, dtype=torch.int8), torch.tensor(1.0))
    with pytest.raises(ValueError, match="grid"):
        detector.detector_postproc(torch.zeros(2, 160, 65, dtype=torch.int8), torch.tensor(1.0),
                                   grid_w=80, grid_h=3)
    w1a, w1b = stem.stem_weights(torch.zeros(64, 1, 3, 3, dtype=torch.int8),
                                 torch.zeros(64, 64, 3, 3, dtype=torch.int8))
    consts = (torch.tensor(1.0), torch.zeros(64), torch.tensor(1.0), torch.zeros(64), torch.tensor(1.0))
    with pytest.raises(ValueError, match="even"):
        stem.fused_stem(torch.zeros(1, 8, 7), w1a, w1b, *consts)
    with pytest.raises(ValueError, match="w1b"):
        stem.fused_stem(torch.zeros(1, 8, 8), w1a, w1b.reshape(9, 64, 64), *consts)
    with pytest.raises(ValueError):
        match.windowed_match(
            torch.zeros(3, 128, dtype=torch.int8), torch.zeros(4, 256, dtype=torch.int8),
            torch.zeros(4), torch.zeros(4, dtype=torch.int32),
            torch.zeros(3, dtype=torch.int32), grid_h=2, grid_w=2,
        )
    with pytest.raises(TypeError):
        nullspace.nullspace_inverse_iteration(torch.zeros(2, 9, 9, dtype=torch.float64))
    with pytest.raises(ValueError):
        svd3.svd3(torch.zeros(2, 3, 4))

"""int8 SuperPoint: the port's f32-carried im2col path against the JAX
package's layered path (stem="off"), bitwise, on synthetic frames."""

import numpy as np
import pytest
import torch

from maveric_slam_tpu.data import synthetic as jsynthetic
from maveric_slam_tpu.models import superpoint as jsp
from maveric_slam_tpu_torch.data import synthetic as tsynthetic
from maveric_slam_tpu_torch.models import superpoint as tsp
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

H, W = 96, 320
K = np.array([[400.0, 0, 160.0], [0, 400.0, 48.0], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def frames():
    poses = tsynthetic.orbit_poses(96)
    return np.stack([tsynthetic.render_box_room(K, poses[k], H, W) for k in (0, 7)])


@pytest.fixture(scope="module")
def params():
    jp = jsp.load_params()
    return jp, tsp.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def test_synthetic_renders_equal(frames):
    poses = jsynthetic.orbit_poses(96)
    np.testing.assert_array_equal(frames[1], jsynthetic.render_box_room(K, poses[7], H, W))


def test_load_params_equals_params_from_numpy(params):
    _, tp = params
    loaded = tsp.load_params(device="cpu")
    assert loaded.keys() == tp.keys()
    for k in loaded:
        assert torch.equal(loaded[k], tp[k]), k


def test_int8_net_bitwise(frames, params):
    jp, tp = params
    semi_j, desc_j, sc_j = jsp.superpoint_int8(jp, frames, stem="off")
    semi_t, desc_t, sc_t = tsp.superpoint_int8(tp, torch.from_numpy(frames))
    assert semi_t.shape == (2, 12, 40, 65) and desc_t.shape == (2, 12, 40, 256)
    assert semi_t.dtype == torch.int8 and desc_t.dtype == torch.int8
    np.testing.assert_array_equal(semi_t.numpy(), np.asarray(semi_j))
    np.testing.assert_array_equal(desc_t.numpy(), np.asarray(desc_j))
    assert float(sc_t["semi_scale"]) == float(sc_j["semi_scale"])
    assert float(sc_t["desc_scale"]) == float(sc_j["desc_scale"])


def test_accumulator_maxima_equal_and_exact(frames, params):
    jp, tp = params
    ref = jsp.int8_accumulator_maxima(jp, frames)
    got = tsp.int8_accumulator_maxima(tp, torch.from_numpy(frames))
    assert got.keys() == ref.keys()
    for name in got:
        assert float(got[name]) == float(ref[name]), name
        assert float(got[name]) < 2**24, name

"""The fused SuperPoint stem: the port's stage 1 and int8 net with
`stem="auto"` against the JAX package's Pallas stem run in interpret mode,
bit for bit, on synthetic 96x320 frames.

On the CPU the port's `fused_stem` runs its plain version (the layered
stage 1); tests/test_torch_cuda.py holds the CUDA kernel against it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maveric_slam_tpu.models import superpoint as jsp
from maveric_slam_tpu.ops import pallas_kernels
from maveric_slam_tpu_torch.data import synthetic
from maveric_slam_tpu_torch.models import superpoint as tsp
from maveric_slam_tpu_torch.ops.kernels import stem
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

H, W = 96, 320
K = np.array([[400.0, 0, 160.0], [0, 400.0, 48.0], [0, 0, 1]], np.float32)


@pytest.fixture(scope="module")
def frames():
    poses = synthetic.orbit_poses(96)
    return np.stack([synthetic.render_box_room(K, poses[k], H, W) for k in (0, 7)])


@pytest.fixture(scope="module")
def params():
    jp = jsp.load_params()
    return jp, tsp.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def _jax_stem(jp, images):
    """pallas_kernels.fused_stem in interpret mode, with the requant
    constants formed as superpoint_int8 forms them (superpoint.py:262-269)."""
    s = jp["input_scale"]
    o1a = jp["conv1a_oscale"]
    b1_q = jnp.round(jp["conv1a_b"] / (s * jp["conv1a_wscale"]))
    m1 = (s * jp["conv1a_wscale"]) / o1a
    b2_q = jnp.round(jp["conv1b_b"] / (o1a * jp["conv1b_wscale"]))
    m2 = (o1a * jp["conv1b_wscale"]) / jp["conv1b_oscale"]
    return np.asarray(pallas_kernels.fused_stem(
        jnp.asarray(images), jp["conv1a_w"], jp["conv1b_w"], s, b1_q, m1, b2_q, m2,
        interpret=True))


@pytest.mark.parametrize("kind", ["orbit", "saturating"])
def test_stage1_bitwise_vs_pallas_interpret(frames, params, kind):
    """Orbit frames, and all-0 / all-1 images where the quantize clip and
    the requant clips bind."""
    jp, tp = params
    images = frames if kind == "orbit" else np.stack(
        [np.zeros((H, W), np.float32), np.ones((H, W), np.float32)])
    got = stem.fused_stem(torch.from_numpy(images), *tsp.stem_args(tp))
    ref = _jax_stem(jp, images)
    assert got.shape == (2, H // 2, W // 2, 64) and got.dtype == torch.int8
    np.testing.assert_array_equal(got.numpy(), ref)


def test_int8_net_auto_bitwise_vs_interpret(frames, params):
    jp, tp = params
    semi_j, desc_j, sc_j = jsp.superpoint_int8(jp, frames, stem="interpret")
    semi_t, desc_t, sc_t = tsp.superpoint_int8(tp, torch.from_numpy(frames))  # stem="auto"
    np.testing.assert_array_equal(semi_t.numpy(), np.asarray(semi_j))
    np.testing.assert_array_equal(desc_t.numpy(), np.asarray(desc_j))
    assert float(sc_t["semi_scale"]) == float(sc_j["semi_scale"])
    assert float(sc_t["desc_scale"]) == float(sc_j["desc_scale"])


def test_odd_width_takes_layered_path(frames, params):
    """W odd: both packages run stage 1 as layered convs under "auto", and
    the port's stem kernel module is not called."""
    jp, tp = params
    img = np.ascontiguousarray(frames[:1, :, :W - 1])
    before = stem.launches
    semi_t, desc_t, _ = tsp.superpoint_int8(tp, torch.from_numpy(img), stem="auto")
    semi_j, desc_j, _ = jsp.superpoint_int8(jp, img, stem="auto")
    assert stem.launches == before
    np.testing.assert_array_equal(semi_t.numpy(), np.asarray(semi_j))
    np.testing.assert_array_equal(desc_t.numpy(), np.asarray(desc_j))


def test_stem_weights_layout(params):
    """The kernel's packed w1b, read back by the B-fragment rule of
    mma.m16n8k32: at [2 * (3u + v) + h][q][4g + tig][8jj + 4r + e] sits
    w1b[o][i][u][v] with o = 8 * (2q + jj) + g and i = 32h + 16r + 4tig + e.
    Unpacked that way, and by `w1b_oihw`, it is OIHW again exactly."""
    _, tp = params
    w = tp["conv1b_w"].numpy()
    wk = tp["stem_w1b"].numpy()
    assert wk.shape == (18, 4, 32, 16) and wk.dtype == np.int8
    ks, q, lane, byte = np.indices(wk.shape)
    tap, h = ks // 2, ks % 2
    g, tig = lane // 4, lane % 4
    jj, r, e = byte // 8, (byte // 4) % 2, byte % 4
    unpacked = np.full_like(w, -1)
    unpacked[8 * (2 * q + jj) + g, 32 * h + 16 * r + 4 * tig + e, tap // 3, tap % 3] = wk
    np.testing.assert_array_equal(unpacked, w)
    assert torch.equal(stem.w1b_oihw(tp["stem_w1b"]), tp["conv1b_w"])
    u, v = 2, 1
    assert torch.equal(tp["stem_w1a"][3 * u + v], tp["conv1a_w"][:, 0, u, v].to(torch.int32))

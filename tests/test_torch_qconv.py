"""SuperPoint's layers after the stem through `ops.kernels.qconv`: the
wrapper's plain version against the f32-carried `_qconv` (+ the 2x2 pool)
bit for bit, the weight layout, and the wrapper's checks. On the CPU.

tests/test_torch_cuda.py holds the CUDA kernel against the plain version.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from maveric_slam_tpu_torch.models import superpoint as sp
from maveric_slam_tpu_torch.ops.kernels import qconv

NAMES = [name for name, _, _, _ in sp._AFTER_STEM]
INPUT_SCALE = {name: src for name, src, _, _ in sp._AFTER_STEM}


@pytest.fixture(scope="module")
def params():
    return sp.load_params(device="cpu")


def _activations(shape, seed):
    """int8 NHWC activations in [0, 127], as every layer's input is (a ReLU's)."""
    return torch.from_numpy(np.random.default_rng(seed).integers(0, 128, shape, dtype=np.int8))


@pytest.mark.parametrize("relu", [True, False])
@pytest.mark.parametrize("shape", [(2, 12, 20), (1, 7, 9)])
@pytest.mark.parametrize("name", NAMES)
def test_plain_equals_qconv_of_superpoint(params, name, shape, relu):
    """The wrapper on CPU tensors equals `_qconv` (+ F.max_pool2d where the
    layer may pool) on the f32 NCHW carrier, with the ReLU on and off."""
    cout, cin, k, _ = params[f"{name}_w"].shape
    x = _activations(shape + (cin,), seed=len(name) * 31 + shape[1])
    acc, _ = sp._qconv(x.permute(0, 3, 1, 2).to(torch.float32), params, name,
                       params[f"{INPUT_SCALE[name]}_oscale"], relu)
    args = sp.qconv_args(params, name)
    for pool in [False, True] if (cin, cout, k) in qconv.POOLED else [False]:
        ref = F.max_pool2d(acc, 2) if pool else acc
        got = qconv.qconv(x, *args, relu=relu, pool=pool)
        assert got.dtype == torch.int8 and got.is_contiguous()
        assert torch.equal(got, ref.permute(0, 2, 3, 1).to(torch.int8)), pool


@pytest.mark.parametrize("name", NAMES)
def test_weights_unpack_to_oihw(params, name):
    """`qconv_oihw` undoes `qconv_weights`; one weight sits where the
    docstring says: output channel n, k = 32ks + 16r + 4tig + e."""
    w = params[f"{name}_w"]
    cout, cin, k, _ = w.shape
    packed = params[f"{name}_qw"]
    assert torch.equal(qconv.qconv_oihw(packed, cin, cout, k), w)
    n, u, v, i = cout - 1, k - 1, 0, cin - 3
    kk = (u * k + v) * cin + i
    ks, r, tig, e = kk // 32, (kk // 16) % 2, (kk // 4) % 4, kk % 4
    npairs = packed.shape[2]
    grp, q, jj, g = n // (16 * npairs), (n // 16) % npairs, (n // 8) % 2, n % 8
    assert packed[grp, ks, q, 4 * g + tig, 8 * jj + 4 * r + e] == w[n, i, u, v]


def test_padded_channels_are_zero(params):
    """convPb's 65 channels padded to 80 with zero weights."""
    w = params["convPb_qw"]
    assert w.shape == (1, 8, 5, 32, 16)
    full = w.reshape(1, 8, 5, 8, 4, 2, 2, 4).permute(0, 2, 5, 3, 1, 6, 4, 7).reshape(80, 256)
    assert not full[65:].any()


def test_wrapper_raises(params):
    """Wrong dtype, layout, channel count, weight layout, or a pool the
    layer does not take."""
    args = sp.qconv_args(params, "conv3b")
    x = _activations((1, 4, 6, 128), 0)
    with pytest.raises(TypeError):
        qconv.qconv(x.to(torch.float32), *args)
    with pytest.raises(ValueError, match="contiguous"):
        qconv.qconv(x.permute(0, 3, 1, 2).contiguous().permute(0, 2, 3, 1), *args)
    with pytest.raises(ValueError, match="cin=32"):
        qconv.qconv(_activations((1, 4, 6, 32), 0), *args)
    with pytest.raises(ValueError, match="qconv_weights"):
        qconv.qconv(x, args[0][:, :-1], *args[1:])
    with pytest.raises(ValueError, match="pool=True"):
        qconv.qconv(_activations((1, 4, 6, 128), 0), *sp.qconv_args(params, "convPa"), pool=True)
    with pytest.raises(TypeError):
        qconv.qconv(x, args[0], args[1].double(), *args[2:])
    with pytest.raises(ValueError, match="no qconv layer"):
        qconv.qconv_weights(torch.zeros(32, 64, 3, 3, dtype=torch.int8))


def test_net_takes_the_wrapper_once_a_layer(params, monkeypatch):
    """`superpoint_int8` runs every layer after the stem through the
    wrapper: ten calls, conv2b and conv3b pooled, the heads without ReLU."""
    calls = []
    real = qconv.qconv

    def spy(x, w, b, m, k, relu=True, pool=False):
        calls.append((tuple(x.shape), b.shape[0], k, relu, pool))
        return real(x, w, b, m, k, relu=relu, pool=pool)

    monkeypatch.setattr(qconv, "qconv", spy)
    semi, desc, _ = sp.superpoint_int8(params, torch.rand(1, 16, 24))
    assert semi.shape == (1, 2, 3, 65) and desc.shape == (1, 2, 3, 256)
    assert [c[1:] for c in calls] == [
        (64, 3, True, False), (64, 3, True, True), (128, 3, True, False), (128, 3, True, True),
        (128, 3, True, False), (128, 3, True, False), (256, 3, True, False), (65, 1, False, False),
        (256, 3, True, False), (256, 1, False, False)]

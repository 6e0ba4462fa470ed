"""Fused SuperPoint stage 1 (CUDA `csrc/stem.cu`) and its plain PyTorch
version, the layered stage 1.

Port of maveric_slam_tpu/ops/pallas_kernels.py fused_stem.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


C = 64  # channels of conv1a and conv1b


# stem_weights' w1b: OIHW split as o = 16q + 8jj + g, i = 32h + 16r + 4tig + e,
# then ordered [u, v, h | q | g, tig | jj, r, e] = [k-step][n-pair][lane][16 bytes].
_W1B_SPLIT = (4, 2, 8, 2, 2, 4, 4, 3, 3)  # q, jj, g, h, r, tig, e, u, v
_W1B_ORDER = (7, 8, 3, 0, 2, 5, 1, 4, 6)
_W1B_SHAPE = (18, 4, 32, 16)


def stem_weights(w1a_oihw: torch.Tensor, w1b_oihw: torch.Tensor):
    """The kernel's weight layout, made once when the params are loaded,
    from OIHW int8: w1a (9, 64) int32 [tap][out], tap = 3 * row + col; w1b
    (18, 4, 32, 16) int8 in the B-fragment order of mma.m16n8k32: k-step
    ks = 2 * tap + h covers input channels 32h .. 32h + 31 of one tap; lane
    (g, tig) = 4g + tig holds, for n-tiles j = 2q + jj (output channel
    8j + g), the words {b0, b1} of input channels 32h + 16r + 4tig + e,
    r = 0, 1, e = 0..3, at bytes 8jj + 4r + e."""
    w1a = w1a_oihw.reshape(C, 9).T.to(torch.int32).contiguous()
    w1b = w1b_oihw.reshape(_W1B_SPLIT).permute(_W1B_ORDER).reshape(_W1B_SHAPE).contiguous()
    return w1a, w1b


def w1b_oihw(w1b: torch.Tensor) -> torch.Tensor:
    """`stem_weights`' w1b back to OIHW (64, 64, 3, 3)."""
    split = [_W1B_SPLIT[k] for k in _W1B_ORDER]
    inverse = [_W1B_ORDER.index(k) for k in range(len(_W1B_ORDER))]
    return w1b.reshape(split).permute(inverse).reshape(C, C, 3, 3)


def _requant(acc, bias_q, m):
    return torch.clamp(torch.round((acc + bias_q.reshape(-1, 1, 1)) * m), 0.0, 127.0)


def fused_stem_plain(images, w1a, w1b, input_scale, b1_q, m1, b2_q, m2):
    """Stage 1 as layered ops: quantize, conv1a and conv1b each as im2col +
    one f32 matmul (exact on these integers, TF32 off) with requant, then a
    2x2 max-pool. Same arguments and result as `fused_stem`."""
    wq1a = w1a.T.to(torch.float32)  # (64, 9): the (in, row, col) im2col order
    wq1b = w1b_oihw(w1b).reshape(C, 9 * C).to(torch.float32)
    s, h, w = images.shape
    x = torch.clamp(torch.round(images[:, None] / input_scale), -128, 127)
    x = _requant((wq1a @ F.unfold(x, 3, padding=1)).reshape(s, C, h, w), b1_q, m1)
    x = _requant((wq1b @ F.unfold(x, 3, padding=1)).reshape(s, C, h, w), b2_q, m2)
    return F.max_pool2d(x, 2).permute(0, 2, 3, 1).to(torch.int8).contiguous()


def fused_stem(images, w1a, w1b, input_scale, b1_q, m1, b2_q, m2):
    """(S, H, W) f32 images in [0, 1], H and W even -> (S, H/2, W/2, 64)
    int8 NHWC, the pooled conv1b activations. w1a, w1b: `stem_weights`'
    layout; input_scale, m1, m2: () f32; b1_q, b2_q: (64,) f32 quantized
    biases. CPU tensors take the plain version; CUDA tensors launch the
    kernel."""
    if images.ndim != 3 or images.shape[1] % 2 or images.shape[2] % 2:
        raise ValueError(f"images must be (S, H, W) with H and W even, got {tuple(images.shape)}")
    if images.dtype != torch.float32:
        raise TypeError(f"images must be float32, got {images.dtype}")
    if w1a.shape != (9, C) or w1a.dtype != torch.int32:
        raise ValueError(f"w1a must be (9, {C}) int32, got {tuple(w1a.shape)} {w1a.dtype}")
    if w1b.shape != _W1B_SHAPE or w1b.dtype != torch.int8:
        raise ValueError(f"w1b must be {_W1B_SHAPE} int8, got {tuple(w1b.shape)} {w1b.dtype}")
    args = (images, w1a, w1b, input_scale, b1_q, m1, b2_q, m2)
    dev = images.device
    if any(t.device != dev for t in args):
        raise ValueError("all inputs must be on one device")
    return fused_stem_plain(*args)
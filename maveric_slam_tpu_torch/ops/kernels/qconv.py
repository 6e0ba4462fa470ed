"""SuperPoint's int8 layers after the stem as one CUDA kernel a layer
(`csrc/qconv.cu`), and its plain PyTorch version.

Replaces no TPU kernel: the JAX package leaves these layers to XLA. The
plain version is the port's f32-carried path (`F.unfold` + one f32 matrix
product + requant, + 2x2 max-pool), exact on these integers with TF32 off.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from . import _build

launches = 0  # kernel launches since the last reset (see ops.kernels)

# (cin, cout, k) of the layers the kernel takes -> channels of its n-group:
# the block's share of cout, the weights' padding unit.
GROUP_CHANNELS = {
    (64, 64, 3): 64,     # conv2a, conv2b
    (64, 128, 3): 128,   # conv3a
    (128, 128, 3): 128,  # conv3b, conv4a, conv4b
    (128, 256, 3): 128,  # convPa, convDa
    (256, 65, 1): 80,    # convPb: 65 channels padded with zero weights
    (256, 256, 1): 128,  # convDb
}
POOLED = {(64, 64, 3), (128, 128, 3)}  # conv2b and conv3b pool in the epilogue


def _geometry(cin: int, cout: int, k: int):
    """(n-groups, k-steps, n-pairs a group) of a layer's packed weights."""
    bn = GROUP_CHANNELS[(cin, cout, k)]
    return -(-cout // bn), k * k * cin // 32, bn // 16


def qconv_weights(w_oihw: torch.Tensor) -> torch.Tensor:
    """The kernel's weight layout, made once when the params are loaded,
    from OIHW int8 (cout, cin, k, k): (n-groups, k-steps, n-pairs, 32, 16)
    int8 in the B-fragment order of mma.m16n8k32. Output channels are
    padded with zeros to whole n-groups; channel n = 16(P ng + q) + 8jj + g,
    P n-pairs a group; k-step ks covers k = 32ks .. 32ks + 31 of k = (u k + v) cin + i
    (tap (u, v), input channel i); lane 4g + tig holds at bytes 8jj + 4r + e
    the weight of k = 32ks + 16r + 4tig + e for n-tile 2q + jj, channel g."""
    cout, cin, kh, kw = w_oihw.shape
    if (cin, cout, kh) not in GROUP_CHANNELS or kh != kw:
        raise ValueError(f"no qconv layer takes OIHW weights of shape {tuple(w_oihw.shape)}")
    ng, ksteps, npairs = _geometry(cin, cout, kh)
    wk = torch.zeros(ng * npairs * 16, kh, kw, cin, dtype=torch.int8, device=w_oihw.device)
    wk[:cout] = w_oihw.to(torch.int8).permute(0, 2, 3, 1)
    wk = wk.reshape(ng, npairs, 2, 8, ksteps, 2, 4, 4)  # ng, q, jj, g | ks, r, tig, e
    return wk.permute(0, 4, 1, 3, 6, 2, 5, 7).reshape(ng, ksteps, npairs, 32, 16).contiguous()


def qconv_oihw(w: torch.Tensor, cin: int, cout: int, k: int) -> torch.Tensor:
    """`qconv_weights`' layout back to OIHW int8 (cout, cin, k, k), in one
    permute: the k-step splits into (u, v, 32-channel block cb) and input
    channel i = 32cb + 16r + 4tig + e."""
    ng, _, npairs = _geometry(cin, cout, k)
    wk = w.reshape(ng, k, k, cin // 32, npairs, 8, 4, 2, 2, 4)  # ng, u, v, cb, q, g, tig, jj, r, e
    wk = wk.permute(0, 4, 7, 5, 3, 8, 6, 9, 1, 2).contiguous()  # ng, q, jj, g | cb, r, tig, e, u, v
    return wk.reshape(ng * npairs * 16, cin, k, k)[:cout]


def qconv_plain(x, w, bias_q, m, k: int, relu: bool, pool: bool):
    """The layer as the f32-carried path: NCHW f32 carrier, im2col
    (`F.unfold`) and one f32 matrix product, the requant
    clip(round((acc + bias_q) * m), 0 or -128, 127), then the 2x2 max-pool.
    Same arguments and result as `qconv`."""
    n, h, wd, cin = x.shape
    cout = bias_q.shape[0]
    wmat = qconv_oihw(w, cin, cout, k).reshape(cout, cin * k * k).to(torch.float32)
    xf = x.permute(0, 3, 1, 2).contiguous().to(torch.float32)
    cols = F.unfold(xf, kernel_size=k, padding=k // 2) if k > 1 else xf.reshape(n, cin, h * wd)
    acc = (wmat @ cols).reshape(n, cout, h, wd)
    q = torch.clamp(torch.round((acc + bias_q.reshape(-1, 1, 1)) * m), 0.0 if relu else -128.0, 127.0)
    if pool:
        q = F.max_pool2d(q, 2)
    return q.permute(0, 2, 3, 1).to(torch.int8).contiguous()


def qconv(x, w, bias_q, m, k: int, relu: bool = True, pool: bool = False):
    """One int8 convolution layer after the stem, 3x3 SAME or 1x1, with the
    requant, ReLU (`relu`) and 2x2 max-pool (`pool`, conv2b and conv3b).

    x: (S, H, W, cin) int8 NHWC, contiguous. w: `qconv_weights` of the
    layer's OIHW weights. bias_q: (cout,) f32 quantized bias round(b /
    (s_in s_w)); m: () f32 multiplier s_in s_w / s_out. Returns (S, H', W',
    cout) int8 NHWC, H' x W' = H x W, or floor(H/2) x floor(W/2) pooled.
    CPU tensors take the plain version; CUDA tensors launch the kernel."""
    if x.ndim != 4 or x.dtype != torch.int8:
        raise TypeError(f"x must be (S, H, W, C) int8, got {tuple(x.shape)} {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous NHWC (channels last in memory)")
    if bias_q.ndim != 1 or bias_q.dtype != torch.float32:
        raise TypeError(f"bias_q must be (cout,) float32, got {tuple(bias_q.shape)} {bias_q.dtype}")
    if m.numel() != 1 or m.dtype != torch.float32:
        raise TypeError(f"m must be one float32, got {tuple(m.shape)} {m.dtype}")
    s, h, wd, cin = x.shape
    cout = bias_q.shape[0]
    if (cin, cout, k) not in GROUP_CHANNELS or (pool and (cin, cout, k) not in POOLED):
        raise ValueError(f"no qconv layer takes cin={cin}, cout={cout}, k={k}, pool={pool}")
    ng, ksteps, npairs = _geometry(cin, cout, k)
    if w.shape != (ng, ksteps, npairs, 32, 16) or w.dtype != torch.int8:
        raise ValueError(f"w must be ({ng}, {ksteps}, {npairs}, 32, 16) int8 (qconv_weights), "
                         f"got {tuple(w.shape)} {w.dtype}")
    dev = x.device
    if any(t.device != dev for t in (w, bias_q, m)):
        raise ValueError("all inputs must be on one device")
    if dev.type == "cpu":
        return qconv_plain(x, w, bias_q, m, k, relu, pool)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    w, bias_q, m = w.contiguous(), bias_q.contiguous(), m.reshape(()).contiguous()
    if x.data_ptr() % 16 or w.data_ptr() % 16:
        raise ValueError("x and w must be 16-byte aligned (the kernel moves 16-byte vectors)")
    ho, wo = (h // 2, wd // 2) if pool else (h, wd)
    out = torch.empty(s, ho, wo, cout, dtype=torch.int8, device=dev)
    global launches
    with torch.cuda.device(dev):
        err = _build.library().qconv(
            x.data_ptr(), w.data_ptr(), bias_q.data_ptr(), m.data_ptr(), out.data_ptr(),
            s, h, wd, cin, cout, k, int(pool), int(relu), _build.stream_of(x))
    _build.check(err, "qconv")
    launches += 1
    return out

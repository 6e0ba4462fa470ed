"""SuperPoint (port of maveric_slam_tpu/models/superpoint.py): the int8
path the engine runs, and the float path.

The network is the reference's per-tensor qint8 graph (all zero points 0):
int8 activations times int8 weights, summed, plus the int32-quantized bias,
requantized with one f32 multiplier and round-half-even. Layout at the
public functions is the JAX package's: images (N, H, W), grids NHWC.

Exactness. As in the JAX package the int8 values are carried as f32: a
product of two int8 values is exact in f32 and so is every partial sum
below 2^24 (`int8_accumulator_maxima` audits that bound). A convolution is
an im2col (`F.unfold`) followed by one f32 matrix product with TF32 off
(set at package import), i.e. plain dot products, exact in that range. A
cuDNN f32 convolution is NOT used: it may pick Winograd or FFT algorithms,
which are not exact on integers. The CPU path runs the same code, so the
CPU tests hold it bitwise against the JAX package.

Stage 1 (conv1a, conv1b, 2x2 pool) runs by default as the fused stem
kernel (`ops/kernels/stem.py`, CUDA `csrc/stem.cu`; its plain version, the
layered stage 1, on the CPU), bitwise equal to the layered path.

The float path (`superpoint_float`, the dequantized weights `{name}_wf`) is
`lax.conv` outside any Pallas kernel in the JAX package; here it is the
same im2col + matrix product in f32 with TF32 off, so that the card and
the CPU differ only in the order of the products' sums (a cuDNN
convolution may pick a Winograd or FFT algorithm).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.backend import resolve_device
from ..ops.kernels import stem as stem_kernel

_ENCODER = ["conv1a", "conv1b", "conv2a", "conv2b", "conv3a", "conv3b", "conv4a", "conv4b"]
_HEADS = ["convPa", "convPb", "convDa", "convDb"]
LAYERS = _ENCODER + _HEADS

# The weights file shipped with the JAX package, read by path (not imported),
# at the root of the checkout four directories above this file.
DEFAULT_WEIGHTS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))),
    "maveric_slam_tpu", "data", "superpoint_weights.npz",
)

Params = Dict[str, torch.Tensor]


def _scalar(v, device) -> torch.Tensor:
    return torch.tensor(np.float32(v), dtype=torch.float32, device=device)


def _layer_params(name: str, w_oihw: np.ndarray, bias, wscale, oscale, device,
                  wf_oihw=None) -> Params:
    w = np.asarray(w_oihw, np.int8)
    if wf_oihw is None:  # the JAX package's dequantization, in numpy
        wf_oihw = w.astype(np.float32) * wscale
    return {
        f"{name}_w": torch.from_numpy(w.copy()).to(device),  # (O, I, KH, KW) int8
        # f32 carrier of the int8 weight as an im2col matrix (O, I*KH*KW).
        f"{name}_wq": torch.from_numpy(w.reshape(w.shape[0], -1).astype(np.float32)).to(device),
        # The dequantized f32 weight as an im2col matrix (the float path).
        f"{name}_wf": torch.from_numpy(np.asarray(wf_oihw, np.float32).reshape(w.shape[0], -1)
                                       .copy()).to(device),
        f"{name}_b": torch.from_numpy(np.asarray(bias, np.float32).copy()).to(device),
        f"{name}_wscale": _scalar(wscale, device),
        f"{name}_oscale": _scalar(oscale, device),
    }


def _requant_consts(in_scale, w_scale, bias, out_scale):
    """The requant's quantized bias round(b / (s_in*s_w)) and multiplier
    M = s_in*s_w/s_out, in f32, in the JAX package's order."""
    return torch.round(bias / (in_scale * w_scale)), (in_scale * w_scale) / out_scale


def _with_stem(params: Params) -> Params:
    """Adds stage 1's arguments of the fused stem kernel: its weight layout
    and the conv1a/conv1b requant constants, formed once here."""
    w1a, w1b = stem_kernel.stem_weights(params["conv1a_w"], params["conv1b_w"])
    b1, m1 = _requant_consts(params["input_scale"], params["conv1a_wscale"],
                             params["conv1a_b"], params["conv1a_oscale"])
    b2, m2 = _requant_consts(params["conv1a_oscale"], params["conv1b_wscale"],
                             params["conv1b_b"], params["conv1b_oscale"])
    params.update(stem_w1a=w1a, stem_w1b=w1b, stem_b1=b1, stem_m1=m1, stem_b2=b2, stem_m2=m2)
    return params


def stem_args(params: Params):
    """The arguments after the images of `ops.kernels.stem.fused_stem`."""
    return (params["stem_w1a"], params["stem_w1b"], params["input_scale"], params["stem_b1"],
            params["stem_m1"], params["stem_b2"], params["stem_m2"])


def load_params(path: str | None = None, device=None) -> Params:
    """Weights from the extracted npz (OIHW int8 weights, f32 biases and
    per-tensor scales), on `device` (None: CUDA)."""
    dev = resolve_device(device)
    raw = np.load(path or DEFAULT_WEIGHTS)
    params: Params = {"input_scale": _scalar(raw["input_scale"], dev)}
    for name in LAYERS:
        params.update(_layer_params(name, raw[f"{name}_w"], raw[f"{name}_b"],
                                    raw[f"{name}_wscale"], raw[f"{name}_oscale"], dev))
    return _with_stem(params)


def params_from_numpy(jax_params: Dict[str, np.ndarray], device=None) -> Params:
    """The port's params from the JAX package's `load_params()` dict, its
    arrays taken to numpy (HWIO int8 weights `{name}_w`, HWIO f32 weights
    `{name}_wf` (dequantized here when absent), `{name}_b`, `{name}_wscale`,
    `{name}_oscale`, `input_scale`)."""
    dev = resolve_device(device)
    params: Params = {"input_scale": _scalar(jax_params["input_scale"], dev)}
    for name in LAYERS:
        w_oihw = np.transpose(np.asarray(jax_params[f"{name}_w"]), (3, 2, 0, 1))
        wf = jax_params.get(f"{name}_wf")
        params.update(_layer_params(name, w_oihw, jax_params[f"{name}_b"],
                                    jax_params[f"{name}_wscale"],
                                    jax_params[f"{name}_oscale"], dev,
                                    None if wf is None else np.transpose(np.asarray(wf), (3, 2, 0, 1))))
    return _with_stem(params)


def _requant(acc, in_scale, w_scale, bias, out_scale, relu: bool):
    """Exact-integer f32 accumulator (N, O, ...) -> qint8 values (as f32):
    bias quantized at s_in*s_w, one multiplier M = s_in*s_w/s_out,
    round-half-even (torch.round), clip to [0 or -128, 127]."""
    bias_q, m = _requant_consts(in_scale, w_scale, bias, out_scale)
    shape = (-1,) + (1,) * (acc.ndim - 2)
    q = torch.round((acc + bias_q.reshape(shape)) * m)
    return torch.clamp(q, 0.0 if relu else -128.0, 127.0)


def _im2col_conv(x: torch.Tensor, wmat: torch.Tensor, k: int) -> torch.Tensor:
    """Conv of NCHW `x` with an im2col weight matrix (O, I*k*k), 3x3 SAME or
    1x1: one matrix product. Returns (N, O, H, W)."""
    n, _, h, w = x.shape
    cols = F.unfold(x, kernel_size=k, padding=k // 2) if k > 1 else x.reshape(n, x.shape[1], h * w)
    return (wmat @ cols).reshape(n, wmat.shape[0], h, w)


def _conv_acc(x: torch.Tensor, params: Params, name: str) -> torch.Tensor:
    """Integer-exact conv accumulator of NCHW f32-carried int8 `x` (f32)."""
    return _im2col_conv(x, params[f"{name}_wq"], params[f"{name}_w"].shape[-1])


def superpoint_float(params: Params, images: torch.Tensor, dtype=torch.float32):
    """Float inference on (N, H, W) grayscale images in [0, 1] (H, W
    multiples of 8) with the dequantized weights, in `dtype`; the input is
    first put on the quantized model's grid (round(x / s_in) * s_in).

    Returns semi (N, H/8, W/8, 65) logits and desc (N, H/8, W/8, 256)
    unnormalized descriptors.
    """
    s_in = params["input_scale"].to(dtype)
    x = torch.round(images[:, None].to(dtype) / s_in) * s_in

    def conv(x, name, relu=True):
        y = _im2col_conv(x, params[f"{name}_wf"].to(dtype), params[f"{name}_w"].shape[-1])
        y = y + params[f"{name}_b"].to(dtype)[:, None, None]
        return torch.relu(y) if relu else y

    for name in _ENCODER:
        x = conv(x, name)
        if name in ("conv1b", "conv2b", "conv3b"):
            x = F.max_pool2d(x, 2)
    semi = conv(conv(x, "convPa"), "convPb", relu=False)
    desc = conv(conv(x, "convDa"), "convDb", relu=False)
    return semi.permute(0, 2, 3, 1).contiguous(), desc.permute(0, 2, 3, 1).contiguous()


def _qconv(x, params, name, in_scale, relu):
    acc = _conv_acc(x, params, name)
    q = _requant(acc, in_scale, params[f"{name}_wscale"], params[f"{name}_b"],
                 params[f"{name}_oscale"], relu)
    return q, params[f"{name}_oscale"]


def superpoint_int8(params: Params, images: torch.Tensor, stem: str = "auto"):
    """Quantized inference on (N, H, W) grayscale images in [0, 1].

    Returns semi_q (N, H/8, W/8, 65) int8, desc_q (N, H/8, W/8, 256) int8
    and {"semi_scale", "desc_scale"} () f32 tensors.
    stem: "auto" runs stage 1 through `ops.kernels.stem.fused_stem` (the
    CUDA kernel for CUDA tensors) when H and W are even, and as layered
    convs otherwise, as the JAX package decides; "off" forces the layered
    stage 1. ("interpret" is a JAX-only mode.)
    """
    if stem not in ("auto", "off"):
        raise ValueError(f"stem must be 'auto' or 'off', got {stem!r}")
    even = images.shape[-2] % 2 == 0 and images.shape[-1] % 2 == 0
    stage1 = stem_kernel.fused_stem if stem == "auto" and even else stem_kernel.fused_stem_plain
    x = stage1(images, *stem_args(params)).permute(0, 3, 1, 2).to(torch.float32)  # NCHW
    sc = params["conv1b_oscale"]
    x, sc = _qconv(x, params, "conv2a", sc, True)
    x, sc = _qconv(x, params, "conv2b", sc, True)
    x = F.max_pool2d(x, 2)
    x, sc = _qconv(x, params, "conv3a", sc, True)
    x, sc = _qconv(x, params, "conv3b", sc, True)
    x = F.max_pool2d(x, 2)
    x, sc = _qconv(x, params, "conv4a", sc, True)
    x, sc = _qconv(x, params, "conv4b", sc, True)
    pa, sca = _qconv(x, params, "convPa", sc, True)
    semi_q, semi_scale = _qconv(pa, params, "convPb", sca, False)
    da, scd = _qconv(x, params, "convDa", sc, True)
    desc_q, desc_scale = _qconv(da, params, "convDb", scd, False)
    return (
        semi_q.permute(0, 2, 3, 1).to(torch.int8).contiguous(),
        desc_q.permute(0, 2, 3, 1).to(torch.int8).contiguous(),
        {"semi_scale": semi_scale, "desc_scale": desc_scale},
    )


def int8_accumulator_maxima(params: Params, images: torch.Tensor) -> Dict[str, torch.Tensor]:
    """Per layer, max |integer accumulator + quantized bias| of the int8
    graph. Each must stay below 2^24 for the f32-carried path to be exact."""
    s = params["input_scale"]
    x = torch.clamp(torch.round(images[:, None] / s), -128, 127)
    maxima: Dict[str, torch.Tensor] = {}

    def qconv(x, name, in_scale, relu):
        acc = _conv_acc(x, params, name)
        bias_q, _ = _requant_consts(in_scale, params[f"{name}_wscale"], params[f"{name}_b"],
                                    params[f"{name}_oscale"])
        maxima[name] = torch.amax(torch.abs(acc + bias_q.reshape(-1, 1, 1)))
        q = _requant(acc, in_scale, params[f"{name}_wscale"], params[f"{name}_b"],
                     params[f"{name}_oscale"], relu)
        return q, params[f"{name}_oscale"]

    sc = s
    for name in _ENCODER:
        x, sc = qconv(x, name, sc, True)
        if name in ("conv1b", "conv2b", "conv3b"):
            x = F.max_pool2d(x, 2)
    pa, sca = qconv(x, "convPa", sc, True)
    qconv(pa, "convPb", sca, False)
    da, scd = qconv(x, "convDa", sc, True)
    qconv(da, "convDb", scd, False)
    return maxima


def grid_to_patch_major(grid: torch.Tensor) -> torch.Tensor:
    """(N, Hc, Wc, C) -> (N, Hc*Wc, C) in the reference's baked patch order,
    patch = col * Hc + row."""
    n, hc, wc, c = grid.shape
    return grid.permute(0, 2, 1, 3).reshape(n, wc * hc, c)

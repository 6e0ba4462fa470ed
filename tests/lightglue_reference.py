"""A plain reference of LightGlue (Lindenberger, Sarlin and Pollefeys, ICCV
2023, arXiv:2306.13643), after cvg/LightGlue's `lightglue.py`, for the
tests of `maveric_slam_tpu_torch/models/lightglue.py`.

Plain `torch` in float32, with TF32 off for matmuls and cuDNN while it
runs, one pair at a time, written out: attention is softmax(q k^T / sqrt(hd))
followed by its product with v; no kernels, no batching, no padding. It
imports neither JAX, nor the JAX package, nor the port. Weights are a dict
in cvg/LightGlue's layout, drawn by `init_weights` as its docstring says.

Departures from cvg/LightGlue: every layer runs and every keypoint is kept
(no adaptive depth or width: depth_confidence = width_confidence = -1); no
flash or mixed-precision path; float32 only.
"""

from __future__ import annotations

import math

import torch


def init_weights(n_layers: int, dim: int, heads: int, seed: int) -> dict:
    """Every parameter, a name at a time in sorted order, from one CPU
    generator seeded `seed`: a Linear's weight and bias (2u - 1) /
    sqrt(fan_in), u uniform in [0, 1) (PyTorch's default init), LayerNorm 1
    and 0, the Fourier features' Wr N(0, 1)."""
    hd, m = dim // heads, 2 * dim
    shapes = {"posenc.Wr.weight": (hd // 2, 2)}
    for i in range(n_layers):
        for blk, lins in (("self_attn", [("Wqkv", 3 * dim, dim), ("out_proj", dim, dim)]),
                          ("cross_attn", [("to_qk", dim, dim), ("to_v", dim, dim),
                                          ("to_out", dim, dim)])):
            for name, fo, fi in lins + [("ffn.0", m, m), ("ffn.3", dim, m)]:
                shapes[f"transformers.{i}.{blk}.{name}.weight"] = (fo, fi)
                shapes[f"transformers.{i}.{blk}.{name}.bias"] = (fo,)
            shapes[f"transformers.{i}.{blk}.ffn.1.weight"] = (m,)
            shapes[f"transformers.{i}.{blk}.ffn.1.bias"] = (m,)
        for name, fo in (("matchability", 1), ("final_proj", dim)):
            shapes[f"log_assignment.{i}.{name}.weight"] = (fo, dim)
            shapes[f"log_assignment.{i}.{name}.bias"] = (fo,)
        if i < n_layers - 1:
            shapes[f"token_confidence.{i}.token.0.weight"] = (1, dim)
            shapes[f"token_confidence.{i}.token.0.bias"] = (1,)
    g = torch.Generator().manual_seed(int(seed))
    out = {}
    for name in sorted(shapes):
        shape = shapes[name]
        if ".ffn.1." in name:
            out[name] = torch.ones(shape) if name.endswith("weight") else torch.zeros(shape)
        elif name == "posenc.Wr.weight":
            out[name] = torch.randn(shape, generator=g)
        else:
            fan_in = shapes[name.rsplit(".", 1)[0] + ".weight"][1]
            out[name] = (torch.rand(shape, generator=g) * 2.0 - 1.0) / math.sqrt(fan_in)
    return out


def _lin(W, name, x):
    return x @ W[name + ".weight"].T + W[name + ".bias"]


def _ffn(W, p, x, msg):
    h = _lin(W, p + ".ffn.0", torch.cat([x, msg], -1))
    mu = h.mean(-1, keepdim=True)
    var = ((h - mu) ** 2).mean(-1, keepdim=True)
    h = (h - mu) / torch.sqrt(var + 1e-5) * W[p + ".ffn.1.weight"] + W[p + ".ffn.1.bias"]
    h = 0.5 * h * (1.0 + torch.erf(h / math.sqrt(2.0)))  # exact GELU
    return x + _lin(W, p + ".ffn.3", h)


def _attend(q, k, v):
    """(h, n, hd) x (h, m, hd) -> softmax(q k^T / sqrt(hd)) v."""
    a = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(q.shape[-1]), dim=-1)
    return a @ v


def _rotary(W, kpts, size):
    w, h = float(size[0]), float(size[1])
    kn = (kpts - torch.tensor([w / 2, h / 2], dtype=kpts.dtype, device=kpts.device)) / (max(w, h) / 2)
    f = kn @ W["posenc.Wr.weight"].T  # (n, hd / 2)
    return torch.cos(f).repeat_interleave(2, -1), torch.sin(f).repeat_interleave(2, -1)


def _rot(t, cos, sin):
    x1, x2 = t[..., 0::2], t[..., 1::2]
    half = torch.stack([-x2, x1], -1).flatten(-2)
    return t * cos + half * sin


def _self(W, i, x, cos, sin, heads):
    p = f"transformers.{i}.self_attn"
    n, d = x.shape
    qkv = _lin(W, p + ".Wqkv", x).reshape(n, heads, d // heads, 3).transpose(0, 1)
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    ctx = _attend(_rot(q, cos, sin), _rot(k, cos, sin), v)  # (h, n, hd)
    msg = _lin(W, p + ".out_proj", ctx.transpose(0, 1).reshape(n, d))
    return _ffn(W, p, x, msg)


def _cross(W, i, x0, x1, heads):
    p = f"transformers.{i}.cross_attn"

    def split(t):
        return t.reshape(t.shape[0], heads, -1).transpose(0, 1)

    qk0, qk1 = split(_lin(W, p + ".to_qk", x0)), split(_lin(W, p + ".to_qk", x1))
    v0, v1 = split(_lin(W, p + ".to_v", x0)), split(_lin(W, p + ".to_v", x1))
    sim = qk0 @ qk1.transpose(-1, -2) / math.sqrt(qk0.shape[-1])  # (h, n0, n1), once
    m0 = torch.softmax(sim, -1) @ v1
    m1 = torch.softmax(sim.transpose(-1, -2), -1) @ v0
    out0 = _lin(W, p + ".to_out", m0.transpose(0, 1).reshape(x0.shape))
    out1 = _lin(W, p + ".to_out", m1.transpose(0, 1).reshape(x1.shape))
    return _ffn(W, p, x0, out0), _ffn(W, p, x1, out1)


def lightglue(W: dict, kpts0, kpts1, desc0, desc1, size, n_layers: int, heads: int,
              threshold: float):
    """One pair: kpts (n, 2) pixels, desc (n, d), both images (W, H).
    Returns (scores (n0 + 1, n1 + 1) log-assignment with the dustbins last,
    matches0 (n0,) with -1 for none, mscores0 (n0,))."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cos0, sin0 = _rotary(W, kpts0, size)
    cos1, sin1 = _rotary(W, kpts1, size)
    x0, x1 = desc0.float(), desc1.float()
    for i in range(n_layers):
        x0 = _self(W, i, x0, cos0, sin0, heads)
        x1 = _self(W, i, x1, cos1, sin1, heads)
        x0, x1 = _cross(W, i, x0, x1, heads)
    p = f"log_assignment.{n_layers - 1}"
    d = x0.shape[-1]
    md0, md1 = _lin(W, p + ".final_proj", x0) / d**0.25, _lin(W, p + ".final_proj", x1) / d**0.25
    z0, z1 = _lin(W, p + ".matchability", x0)[:, 0], _lin(W, p + ".matchability", x1)[:, 0]
    sim = md0 @ md1.T
    logsig = torch.nn.functional.logsigmoid
    n0, n1 = sim.shape
    scores = torch.zeros(n0 + 1, n1 + 1, dtype=sim.dtype, device=sim.device)
    scores[:n0, :n1] = (torch.log_softmax(sim, 1) + torch.log_softmax(sim, 0)
                        + logsig(z0)[:, None] + logsig(z1)[None, :])
    scores[:n0, n1] = logsig(-z0)
    scores[n0, :n1] = logsig(-z1)
    core = scores[:n0, :n1]
    v0, m0 = core.max(1)
    m1 = core.max(0).indices
    mutual = m1[m0] == torch.arange(n0, device=core.device)
    ms0 = torch.where(mutual, v0.exp(), 0.0)
    keep = mutual & (ms0 > threshold)
    return scores, torch.where(keep, m0, -1), ms0

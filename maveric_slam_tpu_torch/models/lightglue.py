"""LightGlue, the learned matcher of SuperPoint features (Lindenberger,
Sarlin and Pollefeys, ICCV 2023, arXiv:2306.13643), on the pairwise path.

The equations are those of cvg/LightGlue's `lightglue.py` with its
`superpoint` settings (`config.LightGlueConfig`): 9 layers of a self block
(rotary encoding from learnable Fourier features of the keypoints, 4 heads
of 64) and a bidirectional cross block, each followed by an MLP on
[x, message] (512 -> 512 -> LayerNorm -> GELU -> 256) added back to x; then
the matchability head, the dual-softmax log-assignment and the mutual
filter. Float32 throughout (`mp` False; TF32 stays off, as the package
sets it): the projections are cuBLAS GEMMs and attention is
`scaled_dot_product_attention`.

The parameters carry cvg/LightGlue's names (`posenc.Wr.weight`,
`transformers.{i}.self_attn.Wqkv.weight`, `...cross_attn.to_qk.weight`,
`log_assignment.{i}.final_proj.weight`, `token_confidence.{i}.token.0.weight`,
...), so its published state dict is a `weights` argument once its
`self_attn.{i}` / `cross_attn.{i}` keys are renamed to
`transformers.{i}.self_attn` / `.cross_attn`, as its own loader does. Those
weights are not in the repository: `init_weights` draws them from a seed.

Where it departs from cvg/LightGlue:
- every layer runs and every point is kept (depth_confidence and
  width_confidence -1; the token-confidence heads are held, never run);
- a batch of P pairs at a fixed capacity K a side: a frame with fewer
  keypoints is padded and its `mask` masks the padded slots out of every
  softmax, the assignment and the filter (they never match). cvg/LightGlue
  pads only for its compiled path and slices the padding off before the
  assignment; here the assignment's padded entries are -inf;
- the self block runs both images of every pair as one batch of 2P, and
  the cross block's two directions as one attention call (q = the image's
  qk, k and v = the other image's).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import torch
import torch.nn.functional as F

from ..config import LightGlueConfig
from ..utils.profiling import span

GAMMA = 1.0  # LearnableFourierPositionalEncoding's gamma: Wr ~ N(0, GAMMA**-2)
MLP_FACTOR = 2  # the MLP's hidden width is 2 x descriptor_dim


def weight_shapes(config: LightGlueConfig) -> Dict[str, tuple]:
    """Every parameter's name and shape, in cvg/LightGlue's layout."""
    d, n = config.descriptor_dim, config.n_layers
    hd, m = d // config.num_heads, MLP_FACTOR * d
    shapes = {"posenc.Wr.weight": (hd // 2, 2)}

    def linear(name, fan_out, fan_in):
        shapes[f"{name}.weight"] = (fan_out, fan_in)
        shapes[f"{name}.bias"] = (fan_out,)

    def ffn(prefix):
        linear(f"{prefix}.ffn.0", m, m)
        shapes[f"{prefix}.ffn.1.weight"] = (m,)  # LayerNorm
        shapes[f"{prefix}.ffn.1.bias"] = (m,)
        linear(f"{prefix}.ffn.3", d, m)

    for i in range(n):
        s, c = f"transformers.{i}.self_attn", f"transformers.{i}.cross_attn"
        linear(f"{s}.Wqkv", 3 * d, d)
        linear(f"{s}.out_proj", d, d)
        ffn(s)
        linear(f"{c}.to_qk", d, d)
        linear(f"{c}.to_v", d, d)
        linear(f"{c}.to_out", d, d)
        ffn(c)
        linear(f"log_assignment.{i}.matchability", 1, d)
        linear(f"log_assignment.{i}.final_proj", d, d)
        if i < n - 1:
            linear(f"token_confidence.{i}.token.0", 1, d)
    return shapes


def init_weights(config: LightGlueConfig, seed: int) -> Dict[str, torch.Tensor]:
    """Random weights as PyTorch's default init draws them, from one CPU
    generator seeded `seed`, a parameter at a time in sorted name order: a
    Linear's weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (drawn as
    (2u - 1) / sqrt(fan_in)), LayerNorm's weight 1 and bias 0, and the
    Fourier features' Wr N(0, GAMMA**-2)."""
    g = torch.Generator().manual_seed(int(seed))
    shapes = weight_shapes(config)
    out = {}
    for name in sorted(shapes):
        shape = shapes[name]
        if ".ffn.1." in name:
            out[name] = (torch.ones if name.endswith("weight") else torch.zeros)(shape)
        elif name == "posenc.Wr.weight":
            out[name] = torch.randn(shape, generator=g) * GAMMA**-2
        else:
            fan_in = shapes[name.rsplit(".", 1)[0] + ".weight"][1]
            out[name] = (torch.rand(shape, generator=g) * 2.0 - 1.0) / math.sqrt(fan_in)
    return out


class LightGlueMatches(NamedTuple):
    matches0: torch.Tensor  # (P, K) int64: the matched keypoint of image 1, -1 for none
    mscores0: torch.Tensor  # (P, K) float32: exp of the mutual argmax's log-assignment, 0 for none
    mutual0: torch.Tensor  # (P, K) int64: the mutual argmax before the threshold, -1 for none
    scores: torch.Tensor  # (P, K + 1, K + 1) float32 log-assignment, dustbins last; -inf off the masks


def normalize_keypoints(xy: torch.Tensor, size) -> torch.Tensor:
    """Pixel (x, y) -> (xy - size / 2) / (max(size) / 2), size = (W, H)."""
    w, h = float(size[0]), float(size[1])
    return torch.stack([xy[..., 0] - w / 2, xy[..., 1] - h / 2], -1) / (max(w, h) / 2)


def rotary_encoding(wr: torch.Tensor, kpts_n: torch.Tensor) -> torch.Tensor:
    """The learnable Fourier features: (2, B, 1, K, head_dim), cos and sin of
    Wr kpts, each repeated twice along the last axis."""
    f = kpts_n @ wr.T
    return torch.stack([torch.cos(f), torch.sin(f)], 0).unsqueeze(-3).repeat_interleave(2, dim=-1)


def rotate_half(x: torch.Tensor) -> torch.Tensor:
    """Adjacent pairs (x1, x2) -> (-x2, x1)."""
    x1, x2 = x.unflatten(-1, (-1, 2)).unbind(-1)
    return torch.stack((-x2, x1), dim=-1).flatten(start_dim=-2)


def apply_rotary(enc: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return t * enc[0] + rotate_half(t) * enc[1]


def key_bias(mask: torch.Tensor) -> torch.Tensor:
    """(B, K) valid slots -> (B, 1, 1, K) additive attention bias, 0 or
    -inf. An image with no valid slot attends to all of them (its rows are
    never matched), so that no softmax is over nothing."""
    keep = mask | ~torch.any(mask, dim=-1, keepdim=True)
    return torch.where(keep, 0.0, -torch.inf).to(torch.float32)[:, None, None, :]


def _linear(W, name, x):
    return F.linear(x, W[f"{name}.weight"], W[f"{name}.bias"])


def ffn(W, prefix: str, x: torch.Tensor, message: torch.Tensor) -> torch.Tensor:
    """x + MLP([x, message]): Linear(2d, 2d) -> LayerNorm -> GELU -> Linear(2d, d)."""
    h = _linear(W, f"{prefix}.ffn.0", torch.cat([x, message], -1))
    h = F.layer_norm(h, h.shape[-1:], W[f"{prefix}.ffn.1.weight"], W[f"{prefix}.ffn.1.bias"])
    return x + _linear(W, f"{prefix}.ffn.3", F.gelu(h))


def _heads(t: torch.Tensor, heads: int) -> torch.Tensor:
    """(B, K, d) -> (B, heads, K, d / heads)."""
    return t.unflatten(-1, (heads, -1)).transpose(1, 2)


def _merge(t: torch.Tensor) -> torch.Tensor:
    """(B, heads, K, hd) -> (B, K, heads * hd)."""
    return t.transpose(1, 2).flatten(start_dim=-2)


def self_block(W, i: int, x: torch.Tensor, enc: torch.Tensor, bias: torch.Tensor,
               heads: int) -> torch.Tensor:
    """Layer i's self block on a batch of images x (B, K, d)."""
    p = f"transformers.{i}.self_attn"
    qkv = _linear(W, f"{p}.Wqkv", x).unflatten(-1, (heads, -1, 3)).transpose(1, 2)
    q, k, v = qkv[..., 0], qkv[..., 1], qkv[..., 2]
    q, k = apply_rotary(enc, q), apply_rotary(enc, k)
    ctx = F.scaled_dot_product_attention(q, k, v.contiguous(), attn_mask=bias)
    return ffn(W, p, x, _linear(W, f"{p}.out_proj", _merge(ctx)))


def _swap(t: torch.Tensor) -> torch.Tensor:
    """The halves of a batch of 2P (image 0's, then image 1's) swapped."""
    a, b = t.chunk(2)
    return torch.cat([b, a])


def cross_block(W, i: int, x: torch.Tensor, bias: torch.Tensor, heads: int) -> torch.Tensor:
    """Layer i's cross block on x (2P, K, d), image 0 of every pair first:
    S = qk_0 qk_1^T / sqrt(hd), m_0 = softmax_row(S) v_1 and m_1 =
    softmax_row(S^T) v_0, as one attention call of 2P rows."""
    p = f"transformers.{i}.cross_attn"
    qk = _heads(_linear(W, f"{p}.to_qk", x), heads)
    v = _heads(_linear(W, f"{p}.to_v", x), heads)
    m = F.scaled_dot_product_attention(qk, _swap(qk), _swap(v), attn_mask=_swap(bias))
    return ffn(W, p, x, _linear(W, f"{p}.to_out", _merge(m)))


def log_assignment(W, i: int, x: torch.Tensor, mask0: torch.Tensor,
                   mask1: torch.Tensor) -> torch.Tensor:
    """Layer i's assignment head on x (2P, K, d): (P, K + 1, K + 1) with
    log_softmax_row(sim) + log_softmax_col(sim) + logsigmoid(z_0) +
    logsigmoid(z_1)^T on the valid pairs of slots (-inf elsewhere) and the
    dustbins logsigmoid(-z) in the last column and row."""
    p = f"log_assignment.{i}"
    d = x.shape[-1]
    md = _linear(W, f"{p}.final_proj", x) / d**0.25
    z = _linear(W, f"{p}.matchability", x)[..., 0]
    md0, md1 = md.chunk(2)
    z0, z1 = z.chunk(2)
    sim = md0 @ md1.transpose(-1, -2)  # (P, K, K)
    keep0 = mask0 | ~torch.any(mask0, dim=-1, keepdim=True)
    keep1 = mask1 | ~torch.any(mask1, dim=-1, keepdim=True)
    scores0 = F.log_softmax(sim.masked_fill(~keep1[:, None, :], -torch.inf), dim=2)
    scores1 = F.log_softmax(sim.masked_fill(~keep0[:, :, None], -torch.inf), dim=1)
    core = scores0 + scores1 + F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :]
    core = core.masked_fill(~(mask0[:, :, None] & mask1[:, None, :]), -torch.inf)
    dust0 = torch.where(mask0, F.logsigmoid(-z0), -torch.inf)
    dust1 = torch.where(mask1, F.logsigmoid(-z1), -torch.inf)
    top = torch.cat([core, dust0[:, :, None]], dim=2)
    bottom = torch.cat([dust1, torch.zeros_like(dust1[:, :1])], dim=1)[:, None, :]
    return torch.cat([top, bottom], dim=1)


def filter_matches(scores: torch.Tensor, threshold: float):
    """Mutual argmax over scores[:, :K, :K], kept where exp(score) >
    `threshold` (masked slots read -inf, so they never match). Returns
    (matches0 (P, K) with -1 for none, mscores0, mutual0: the mutual
    argmax before the threshold, -1 for none)."""
    core = scores[:, :-1, :-1]
    max0, max1 = core.max(2), core.max(1)
    m0, m1 = max0.indices, max1.indices
    idx0 = torch.arange(m0.shape[1], device=m0.device)[None]
    # a masked row reads -inf throughout: never mutual
    mutual0 = (idx0 == m1.gather(1, m0)) & torch.isfinite(max0.values)
    mscores0 = torch.where(mutual0, max0.values.exp(), 0.0)
    valid0 = mutual0 & (mscores0 > threshold)
    return torch.where(valid0, m0, -1), mscores0, torch.where(mutual0, m0, -1)


class LightGlue:
    """The matcher with its weights on `device` (None: CUDA): `weights`, a
    dict in cvg/LightGlue's layout, or by default `init_weights(config,
    config.weights_seed)`. Call it on a batch of P pairs.

    `counters` counts since construction, always on: `pairs` matched,
    `layers_run` (n_layers a pair: no early exit) and `keypoints`, the valid
    keypoints of both sides (summed on the device; reading it waits for the
    device)."""

    def __init__(self, config: LightGlueConfig, device=None,
                 weights: Optional[Dict[str, torch.Tensor]] = None):
        if config.depth_confidence != -1 or config.width_confidence != -1:
            raise ValueError(
                "adaptive depth and width need LightGlue's published weights, which are not in "
                "the repository: depth_confidence and width_confidence must be -1")
        if config.input_dim != config.descriptor_dim:
            raise ValueError("input_dim must equal descriptor_dim (no input projection)")
        device = torch.device("cuda" if device is None else device)
        want = weight_shapes(config)
        if weights is None:
            weights = init_weights(config, config.weights_seed)
        got = {k: tuple(v.shape) for k, v in weights.items()}
        if got != want:
            raise ValueError(f"weights do not fit {config}: {sorted(set(got) ^ set(want))[:4]}")
        self.config, self.device = config, device
        self.weights = {k: v.to(device, torch.float32).contiguous() for k, v in weights.items()}
        self._pairs = self._layers = 0
        self._keypoints = torch.zeros((), dtype=torch.int64, device=device)

    @property
    def counters(self) -> Dict[str, int]:
        return {"pairs": self._pairs, "layers_run": self._layers,
                "keypoints": int(self._keypoints)}

    def __call__(self, xy0: torch.Tensor, xy1: torch.Tensor, desc0: torch.Tensor,
                 desc1: torch.Tensor, mask0: torch.Tensor, mask1: torch.Tensor,
                 size) -> LightGlueMatches:
        """xy (P, K, 2) pixel keypoints, desc (P, K, d), mask (P, K) bool;
        both images of size (W, H)."""
        W, cfg = self.weights, self.config
        heads, n = cfg.num_heads, cfg.n_layers
        with span("lightglue.position"):
            enc = rotary_encoding(W["posenc.Wr.weight"],
                                  normalize_keypoints(torch.cat([xy0, xy1]), size))
            mask = torch.cat([mask0, mask1])
            bias = key_bias(mask)
        x = torch.cat([desc0, desc1]).to(torch.float32)
        for i in range(n):
            with span("lightglue.self"):
                x = self_block(W, i, x, enc, bias, heads)
            with span("lightglue.cross"):
                x = cross_block(W, i, x, bias, heads)
        with span("lightglue.assign"):
            scores = log_assignment(W, n - 1, x, mask0, mask1)
        with span("lightglue.filter"):
            matches0, mscores0, mutual0 = filter_matches(scores, cfg.filter_threshold)
        p = xy0.shape[0]
        self._pairs += p
        self._layers += n * p
        self._keypoints += mask.sum()
        return LightGlueMatches(matches0=matches0, mscores0=mscores0, mutual0=mutual0, scores=scores)

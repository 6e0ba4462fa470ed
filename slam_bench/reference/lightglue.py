"""The benchmark's plain reference of LightGlue (Lindenberger, Sarlin and
Pollefeys, ICCV 2023, arXiv:2306.13643), after cvg/LightGlue's
`lightglue.py`, and the comparison of a relocalisation call with it
(`compare_call`), which decides `correct` in the `reloc` client's cells.

Plain `torch` in float32, with TF32 off for matmuls and cuDNN while it
runs, one pair at a time, written out: attention is softmax(q k^T / sqrt(hd))
followed by its product with v; no kernels, no batching, no padding. It
imports nothing of the program, nor JAX. Weights are a dict in
cvg/LightGlue's layout, drawn by `init_weights` from the configuration's
seed as its docstring says.

Departures from cvg/LightGlue: every layer runs and every keypoint is kept
(no adaptive depth or width: depth_confidence = width_confidence = -1); no
flash or mixed-precision path; float32 only.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .check import _rot_deg
from .frozen.geometry import epipolar, ransac

# The lead that makes a row's or a column's argmax safe from rounding: twice
# the limit of `assign_log_gap` in the cells of the `reloc` client, since a
# gap within that limit on every entry moves a lead by at most twice it.
DECIDED_MARGIN = 2e-3


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


def _lead(core: torch.Tensor, dim: int):
    """(argmax, lead over the second best) along `dim`; the lead is inf
    where there is one entry."""
    if core.shape[dim] < 2:
        return core.argmax(dim), torch.full_like(core.amax(dim), math.inf)
    top = core.topk(2, dim=dim)
    first, second = top.values.unbind(dim)
    return top.indices.select(dim, 0), first - second


def decided_mutual(core: torch.Tensor, margin: float):
    """The mutual argmax of (n0, n1) scores before any threshold: for each
    row its column, -1 where not mutual; and whether that is decided, that
    is the row's best and its column's best each lead their second by more
    than `margin`, so that scores within margin / 2 of these give the same
    answer."""
    a, row_lead = _lead(core, 1)
    b, col_lead = _lead(core, 0)
    mutual = b[a] == torch.arange(core.shape[0], device=core.device)
    return torch.where(mutual, a, -1), (row_lead > margin) & (col_lead[a] > margin)


def _slot_rank(mask):
    """The position of each valid slot among the valid slots."""
    return torch.cumsum(mask.long(), 0) - 1


def compare_call(tally, prog: dict, ref_q, ref_c: list, W: dict, block: dict, size, rcfg,
                 ransac_seed: int, device) -> None:
    """One relocalisation call against the reference, into `tally`.

    prog: the program's query features (`q_xy` (K, 2), `q_desc`, `q_mask`),
    its candidates' (`c_xy` (P, K, 2), `c_desc`, `c_mask`), its `matches`
    (P, K), `mutual` (P, K), its mutual argmax before the filter's
    threshold, `num_matches` (P,), `R` (P, 3, 3) and `log_assignment` (P, K +
    1, K + 1). ref_q, ref_c: the reference's own golden features of the
    query and of each candidate. The reference runs its LightGlue on its
    own features with the same weights, and the frozen `ransac_essential`
    on the program's matches (at the reference's keypoints) with the
    program's noise replayed from `ransac_seed`.

    Counts `kpt_diff` (slots whose validity or keypoint differs),
    `match_diff` (matches on one side only) and `mutual_diff` (query slots
    whose mutual argmax before the threshold differs, over the slots where
    the reference's is decided, `decided_mutual` at DECIDED_MARGIN: with
    random weights no match passes the threshold, and these hold the
    filter's argmaxes to the reference all the same); maxima `desc_gap`
    (descriptors over slots valid on both sides) and `assign_log_gap`
    (log-assignment scores over entries valid on both sides, dustbins
    included); each rotation gap of a pair with at least sample_size
    program matches into `pose_rot`. Returns the number of query slots
    whose mutual argmax was decided, and of those mutual."""
    k = prog["q_mask"].shape[-1]
    kpt, desc = 0, 0.0
    sides = [(prog["q_xy"], prog["q_desc"], prog["q_mask"], ref_q)]
    sides += [(prog["c_xy"][p], prog["c_desc"][p], prog["c_mask"][p], r) for p, r in enumerate(ref_c)]
    for xy, d, m, r in sides:
        both = m & r.mask
        kpt += int((m != r.mask).sum()) + int((both & (xy != r.xy).any(-1)).sum())
        if both.any():
            desc = max(desc, float((d[both] - r.desc[both]).abs().max()))
    tally.counts["kpt_diff"] = tally.counts.get("kpt_diff", 0) + kpt
    tally.maxima["desc_gap"] = max(tally.maxima.get("desc_gap", 0.0), desc)

    gap, mdiff, udiff, decided, mutual = 0.0, 0, 0, 0, 0
    n_layers, heads = int(block["n_layers"]), int(block["num_heads"])
    for p, r1 in enumerate(ref_c):
        r0 = ref_q
        scores, m0, _ = lightglue(W, r0.xy[r0.mask], r1.xy[r1.mask], r0.desc[r0.mask],
                                  r1.desc[r1.mask], size, n_layers, heads,
                                  float(block["filter_threshold"]))
        n0, n1 = scores.shape[0] - 1, scores.shape[1] - 1
        s0 = torch.nonzero(prog["q_mask"] & r0.mask)[:, 0]
        s1 = torch.nonzero(prog["c_mask"][p] & r1.mask)[:, 0]
        pos0, pos1 = _slot_rank(r0.mask)[s0], _slot_rank(r1.mask)[s1]
        got = prog["log_assignment"][p]
        if len(s0) and len(s1):
            gap = max(gap, float((got[s0][:, s1] - scores[pos0][:, pos1]).abs().max()))
        if len(s0):
            gap = max(gap, float((got[s0, k] - scores[pos0, n1]).abs().max()))
        if len(s1):
            gap = max(gap, float((got[k, s1] - scores[n0, pos1]).abs().max()))
        slots0, slots1 = torch.nonzero(r0.mask)[:, 0], torch.nonzero(r1.mask)[:, 0]
        ref_pairs = {(int(slots0[i]), int(slots1[j])) for i, j in enumerate(m0.tolist()) if j >= 0}
        pm = prog["matches"][p]
        prog_pairs = {(i, int(j)) for i, j in enumerate(pm.tolist()) if j >= 0}
        mdiff += len(ref_pairs ^ prog_pairs)
        if n0 and n1:
            col, ok = decided_mutual(scores[:n0, :n1], DECIDED_MARGIN)
            want = torch.where(col >= 0, slots1[col.clamp(min=0)], -1)[ok]
            got_mutual = prog["mutual"][p][slots0][ok].long()
            udiff += int((got_mutual != want).sum())
            decided += int(ok.sum())
            mutual += int((want >= 0).sum())
    tally.maxima["assign_log_gap"] = max(tally.maxima.get("assign_log_gap", 0.0), gap)
    tally.counts["match_diff"] = tally.counts.get("match_diff", 0) + mdiff
    tally.counts["mutual_diff"] = tally.counts.get("mutual_diff", 0) + udiff

    # The frozen RANSAC on the program's matches, with its noise replayed.
    P = len(ref_c)
    n_hyp = rcfg.ransac.num_hypotheses
    g = torch.Generator(device=device).manual_seed(int(ransac_seed))
    gmin = ransac.gumbel((P, n_hyp, k), g, device)
    glo = ransac.gumbel((P, ransac.lo_hypotheses(n_hyp), k), g, device)
    K = torch.from_numpy(rcfg.working_camera.K).to(device)
    xy0 = ref_q.xy[None].expand(P, k, 2)
    xy1 = torch.stack([r.xy for r in ref_c])
    match = prog["matches"].long()
    xy1 = torch.take_along_dim(xy1, torch.clamp(match, min=0)[..., None], dim=1)
    res = ransac.ransac_essential(epipolar.normalize_points(xy0, K), epipolar.normalize_points(xy1, K),
                                  match >= 0, inlier_thresh=rcfg.ransac.inlier_thresh,
                                  num_hypotheses=n_hyp, gumbel_min=gmin, gumbel_lo=glo)
    keep = (prog["num_matches"] >= rcfg.ransac.sample_size).cpu().numpy()
    if keep.any():
        rot = _rot_deg(prog["R"].cpu().numpy()[keep], res.R.cpu().numpy()[keep])
        tally.pose_rot.extend(float(x) for x in np.atleast_1d(rot))
    return decided, mutual


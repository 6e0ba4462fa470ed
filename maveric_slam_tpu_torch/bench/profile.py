"""Where a tracking step's time goes on the card (the port's
tools/profile_step.py, profile_batched.py, profile_tail.py and
profile_roofline.py).

    python -m maveric_slam_tpu_torch.bench.profile step
    python -m maveric_slam_tpu_torch.bench.profile batched
    python -m maveric_slam_tpu_torch.bench.profile roofline

- step: each stage of one step as its own call, in step order (init_state,
  the whole track_step, extract_quantized, superpoint_int8, windowed_match,
  normalize_points, ransac_essential, triangulate, refine_pose): host ms a
  call around synchronised calls, launches included, since a single stream
  is bound by its chain of dependent calls.
- batched: at each S, the batched extraction, the batched net, the whole
  tail (`_step_from_feats`) and each of the tail's stages over S streams.
- roofline: each layer of the int8 net on one frame (stage 1 is the fused
  stem kernel; the rest im2col + f32 matmul and the requant): operations,
  least bytes (each input and output once at the dtype the port moves,
  the f32 carriers between layers, and the weights once), device ms over
  many launches from CUDA events and its kernels' busy time from
  torch.profiler, the TFLOP/s and GB/s reached, and which H100 peak bounds
  the layer with its share of that bound against each time. The TPU tool's
  slope protocol (timing loops of two lengths) worked around its runtime's
  barrier; CUDA events time the launches directly.

Prints one JSON line a subcommand.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch
import torch.nn.functional as F

from ..frontend import extractor, tracker as trk
from ..geometry import epipolar, pnp, ransac
from ..models import superpoint as sp
from ..ops import matching
from ..ops.kernels import stem as stem_kernel
from . import common

ITERS = 50
BUSY_CALLS = 20  # a layer's calls under torch.profiler for its device-busy time
PHASE = 12  # orbit frames between two streams' first frames


def _states_and_feats(params, orbit, s, device):
    """Stream states on frames at orbit phases 12 s and each stream's next
    frame's features."""
    cfg = common.config(orbit.h, orbit.w)
    phase = [PHASE * k for k in range(s)]
    img0 = torch.from_numpy(np.stack(orbit.frames(phase))).to(device)
    img1 = torch.from_numpy(np.stack(orbit.frames([p + 1 for p in phase]))).to(device)
    states = trk.init_states_batched(params, img0, cfg)
    return cfg, img1, states, extractor.extract_quantized_batched(params, img1, cfg)


def tail_stages(cfg, states, feats):
    """[(name, call)] of the tail's stages over the S streams of `states`,
    on inputs formed once by the stages before them."""
    fc, mc, rc = cfg.frontend, cfg.matcher, cfg.ransac
    s, n = states.desc.shape[0], fc.num_cells
    dev = states.desc.device
    desc1 = feats.desc_q.reshape(s, n, 256)
    xy1 = feats.xy.reshape(s, n, 2)

    def match():
        return matching.windowed_match(
            states.desc, states.probs, states.indices, desc1, feats.top.cells, feats.top.indices,
            feats.top.mask, grid_h=fc.grid_h, grid_w=fc.grid_w, shift=mc.window_shift,
            radius=mc.window_radius, match_threshold=mc.match_threshold, min_prob=mc.min_prob,
            xy0_cells=states.xy, xy1_cells=xy1)

    m = match()
    K = torch.from_numpy(cfg.working_camera.K).to(dev)

    def normalize():
        return epipolar.normalize_points(m.xy0, K), epipolar.normalize_points(m.xy1, K)

    p1, p2 = normalize()
    gen = torch.Generator(device=dev).manual_seed(0)
    lo_k = ransac.lo_hypotheses(rc.num_hypotheses)
    gmin = ransac.gumbel((s, rc.num_hypotheses, fc.top_n), gen, dev)
    glo = ransac.gumbel((s, lo_k, fc.top_n), gen, dev)

    def rans():
        return ransac.ransac_essential(p1, p2, m.mask, inlier_thresh=rc.inlier_thresh,
                                       num_hypotheses=rc.num_hypotheses, gumbel_min=gmin,
                                       gumbel_lo=glo)

    res = rans()
    X = epipolar.triangulate(res.R, res.t, p1, p2)
    return [
        ("windowed_match", match),
        ("normalize_points", normalize),
        ("ransac_essential", rans),
        ("triangulate", lambda: epipolar.triangulate(res.R, res.t, p1, p2)),
        ("refine_pose", lambda: pnp.refine_pose(K, res.R, res.t, X, m.xy1, res.inliers,
                                                huber_delta=cfg.ba.huber_delta,
                                                damping=cfg.ba.lm_damping)),
    ]


def step(device, h=common.H, w=common.W, iters=ITERS) -> dict:
    device = torch.device(device)
    params = common.load(device)
    orbit = common.Orbit(h, w)
    cfg, img1, states, feats = _states_and_feats(params, orbit, 1, device)
    img0 = torch.from_numpy(orbit.frames([0])[0]).to(device)
    state = trk.init_state(params, img0, cfg)
    stages = [
        ("init_state (extract)", lambda: trk.init_state(params, img0, cfg)),
        ("track_step", lambda: trk.track_step(params, state, img1[0], cfg)),
        ("extract_quantized", lambda: extractor.extract_quantized(params, img1[0], cfg)),
        ("superpoint_int8", lambda: sp.superpoint_int8(params, img1[:1])),
    ] + tail_stages(cfg, states, feats)
    rows = [{"stage": name, "ms": common.median_call_s(fn, device, iters) * 1e3} for name, fn in stages]
    return {"profile": "step", "size": f"{h}x{w}", "rows": rows, "device": common.device_info(device),
            "clock": "host ms a call, mean over back-to-back synchronised runs, launches included"}


def batched(device, h=common.H, w=common.W, streams=(1, 4, 16, 32), iters=20) -> dict:
    device = torch.device(device)
    params = common.load(device)
    orbit = common.Orbit(h, w)
    rows = []
    for s in streams:
        cfg, img1, states, feats = _states_and_feats(params, orbit, s, device)
        gen = torch.Generator(device=device).manual_seed(0)
        stages = [
            ("extract_quantized_batched", lambda: extractor.extract_quantized_batched(params, img1, cfg)),
            ("superpoint_int8", lambda: sp.superpoint_int8(params, img1)),
            ("tail (_step_from_feats)", lambda: trk._step_from_feats(
                states._replace(generator=tuple(gen for _ in range(s))), feats, cfg, None, None)),
        ] + tail_stages(cfg, states, feats)
        for name, fn in stages:
            ms = common.median_call_s(fn, device, iters) * 1e3
            rows.append({"streams": s, "stage": name, "ms": ms, "us_per_frame": ms / s * 1e3})
    return {"profile": "batched", "size": f"{h}x{w}", "rows": rows,
            "device": common.device_info(device),
            "clock": "host ms a call, mean over back-to-back synchronised runs, launches included"}


def net_layers(params, images):
    """[(name, call, operations, least bytes, unit)] of the int8 net's
    layers on `images` (S, H, W), each layer on the output of the one
    before; the figures cover all S images. Least bytes: the layer's input
    and output once (the f32 carriers between layers, the stem's f32 images
    and int8 output), a two-layer head's middle activation written and read
    once, and the weights once."""
    s, h, w = images.shape
    layers = {layer["name"]: layer for layer in common.superpoint_flops(h, w)}

    def nbytes(*tensors):
        return sum(t.numel() * t.element_size() for t in tensors)

    sargs = sp.stem_args(params)
    x1 = stem_kernel.fused_stem(images, *sargs)
    out = [("stage 1 (fused stem kernel)", lambda: stem_kernel.fused_stem(images, *sargs),
            s * (layers["conv1a"]["ops"] + layers["conv1b"]["ops"]), nbytes(images, x1, *sargs),
            "int8 tensor cores")]

    def add(label, names, x, sc, pool=False, relu=(True, True)):
        def call():
            y, scy = x, sc
            for n, r in zip(names, relu):
                y, scy = sp._qconv(y, params, n, scy, r)
            return F.max_pool2d(y, 2) if pool else y

        y = call()
        mid = sum(2 * 4 * s * layers[n]["hc"] * layers[n]["wc"] * layers[n]["cout"] for n in names[:-1])
        weights = nbytes(*(params[f"{n}_{k}"] for n in names for k in ("wq", "b")))
        out.append((label, call, s * sum(layers[n]["ops"] for n in names),
                    nbytes(x, y) + mid + weights, "f32 CUDA cores"))
        return y, params[f"{names[-1]}_oscale"]

    x, sc = x1.permute(0, 3, 1, 2).to(torch.float32), params["conv1b_oscale"]
    x, sc = add("conv2a", ["conv2a"], x, sc)
    x, sc = add("conv2b + pool", ["conv2b"], x, sc, pool=True)
    x, sc = add("conv3a", ["conv3a"], x, sc)
    x, sc = add("conv3b + pool", ["conv3b"], x, sc, pool=True)
    x, sc = add("conv4a", ["conv4a"], x, sc)
    x, sc = add("conv4b", ["conv4b"], x, sc)
    add("convPa + convPb", ["convPa", "convPb"], x, sc, relu=(True, False))
    add("convDa + convDb", ["convDa", "convDb"], x, sc, relu=(True, False))
    return out


def roofline(device, h=common.H, w=common.W, iters=200) -> dict:
    device = torch.device(device)
    params = common.load(device)
    orbit = common.Orbit(h, w)
    images = torch.from_numpy(np.stack(orbit.frames([0]))).to(device)
    rows = []
    for name, fn, ops, least, unit in net_layers(params, images):
        ms = common.event_ms(fn, device, iters)
        busy, kernels = common.device_busy_ms(lambda: [fn() for _ in range(BUSY_CALLS)], device)
        if device.type == "cuda":  # every call launches the same kernels
            common.check(kernels > 0 and kernels % BUSY_CALLS == 0,
                         f"{name}: the profiler recorded {kernels} kernels over {BUSY_CALLS} calls")
        t_ops, t_bytes = ops / common.PEAKS[unit] * 1e3, least / common.HBM_BYTES_PER_S * 1e3
        bound = max(t_ops, t_bytes)
        rows.append({"layer": name, "unit": unit, "gop": ops / 1e9, "least_mb": least / 1e6, "ms": ms,
                     "tflops": ops / ms / 1e9, "gbs": least / ms / 1e6,
                     "bound_by": f"{unit} peak" if t_ops >= t_bytes else "HBM bandwidth",
                     "bound_ms": bound, "share_of_bound": bound / ms,
                     "device_busy_ms": None if busy is None else busy / BUSY_CALLS,
                     "kernels": None if kernels is None else kernels / BUSY_CALLS,
                     "busy_share_of_bound": None if busy is None else bound * BUSY_CALLS / busy})
    total = sum(r["ms"] for r in rows)
    gop = sum(r["gop"] for r in rows)
    busy = [r["device_busy_ms"] for r in rows]
    busy = None if None in busy else sum(busy)
    return {"profile": "roofline", "size": f"{h}x{w}", "streams": 1, "rows": rows,
            "net_ms": total, "net_tflops": gop / total, "net_bound_ms": sum(r["bound_ms"] for r in rows),
            "net_device_busy_ms": busy,
            "device": common.device_info(device),
            "clock": f"ms: CUDA events over {iters} back-to-back calls of each layer alone, on its "
                     f"own input (the device's timeline, gaps waiting on the host included); "
                     f"device_busy_ms: the layer's kernels' time from torch.profiler over "
                     f"{BUSY_CALLS} calls" if device.type == "cuda" else "host clock (CPU control-flow run)"}


def markdown(report: dict) -> str:
    """The roofline as a markdown table."""
    lines = [f"Per-layer roofline, S={report['streams']}, {report['size']}, "
             f"{report['device']['name']} {report['device']['power_limit']}", "",
             "| layer | ms | device busy ms | kernels | GOP | TFLOP/s | least MB | GB/s | bound by "
             "| share of bound (ms / busy) |",
             "|---|---|---|---|---|---|---|---|---|---|"]

    def opt(v, fmt):
        return "not measured" if v is None else format(v, fmt)

    for r in report["rows"]:
        lines.append(f"| {r['layer']} | {r['ms']:.5f} | {opt(r['device_busy_ms'], '.5f')} "
                     f"| {opt(r['kernels'], '.0f')} | {r['gop']:.4f} | {r['tflops']:.2f} "
                     f"| {r['least_mb']:.3f} | {r['gbs']:.1f} | {r['bound_by']} "
                     f"| {100 * r['share_of_bound']:.1f}% / {opt(r['busy_share_of_bound'], '.1%')} |")
    lines.append(f"| net | {report['net_ms']:.5f} | {opt(report['net_device_busy_ms'], '.5f')} | | "
                 f"| {report['net_tflops']:.2f} | | | bound {report['net_bound_ms']:.5f} ms | |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("what", choices=["step", "batched", "roofline"])
    args = ap.parse_args(argv)
    device = common.require_cuda("bench.profile")
    if args.what == "step":
        out = step(device)
    elif args.what == "batched":
        out = batched(device)
    else:
        out = roofline(device)
        print(markdown(out), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

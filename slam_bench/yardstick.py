"""The benchmark's yardstick: the card's peaks, SuperPoint's operation
count, each kernel's least time from its launch arguments, the reduction of
a profiler trace to busy time.

Nothing here imports the program. Every number that a per-layer metric
divides by is computed here from shapes, so that a later change to the
program cannot move it.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Sequence, Tuple

# NVIDIA H100 SXM, data sheet, dense rates at the 700 W limit.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # float32 outside the tensor cores
INT8_OPS_PER_S = 1979e12  # int8 tensor cores
PEAKS = {"int8 tensor cores": INT8_OPS_PER_S, "f32 CUDA cores": F32_OPS_PER_S}

# The program's five hand-written kernels: the C entry point the wrapper
# calls and the device symbol the profiler names.
KERNEL_SYMBOLS = {
    "fused_stem": ("stem_kernel",),
    "detector_postproc": ("detector_kernel",),
    "windowed_match": ("match_kernel",),
    "nullspace_inverse_iteration": ("nullspace_kernel",),
    "svd3": ("svd3_kernel",),
}
MARKER_SYMBOL = "spin_kernel"  # torch.cuda._sleep, the trace's markers


def conv_ops(hc: int, wc: int, cin: int, cout: int, k: int = 3) -> int:
    """Operations (2 a multiply-add) of a k x k convolution at hc x wc."""
    return 2 * hc * wc * cin * cout * k * k


def superpoint_flops(h: int, w: int) -> List[dict]:
    """SuperPoint's convolutions at h x w, layer by layer, with the unit
    each runs on: stage 1 (conv1a, conv1b) on the int8 tensor cores, the
    rest as f32 products. Only the convolutions are counted."""
    layers = [("conv1a", 1, 1, 64, 3), ("conv1b", 1, 64, 64, 3), ("conv2a", 2, 64, 64, 3),
              ("conv2b", 2, 64, 64, 3), ("conv3a", 4, 64, 128, 3), ("conv3b", 4, 128, 128, 3),
              ("conv4a", 8, 128, 128, 3), ("conv4b", 8, 128, 128, 3), ("convPa", 8, 128, 256, 3),
              ("convPb", 8, 256, 65, 1), ("convDa", 8, 128, 256, 3), ("convDb", 8, 256, 256, 1)]
    return [{"name": n, "ops": conv_ops(h // d, w // d, ci, co, k),
             "unit": "int8 tensor cores" if n in ("conv1a", "conv1b") else "f32 CUDA cores"}
            for n, d, ci, co, k in layers]


def frame_least_s(h: int, w: int) -> float:
    """The least time a frame's convolutions could take: each layer's
    operations over the peak of its unit, summed."""
    return sum(layer["ops"] / PEAKS[layer["unit"]] for layer in superpoint_flops(h, w))


def _least(ops: float, peak: float, nbytes: float) -> float:
    return max(ops / peak if ops else 0.0, nbytes / HBM_BYTES_PER_S)


def kernel_least_s(name: str, args: Sequence) -> float:
    """The least time of one launch of a program kernel, from the integer
    arguments of its C entry point: the larger of its operations over the
    peak of its unit and its bytes over HBM bandwidth, each input byte read
    once and each output byte written once."""
    if name == "fused_stem":  # (images, w1a, w1b, s_in, b1, m1, b2, m2, out, S, H, W, stream)
        s, h, w = args[9], args[10], args[11]
        ops = s * (conv_ops(h, w, 1, 64) + conv_ops(h, w, 64, 64))
        nbytes = s * h * w * 4 + 9 * 64 * 4 + 64 * 64 * 9 + s * (h // 2) * (w // 2) * 64
        return _least(ops, INT8_OPS_PER_S, nbytes)
    if name == "detector_postproc":  # (semi, scale, probs, idx, xy, cells, per_stream, gw, deg, stream)
        cells = args[5]
        return _least(0, 1, cells * 65 + 4 + cells * (4 + 4 + 8))
    if name == "windowed_match":  # (d1, d0, p0, i0, c1, score, cell, n, S, gh, gw, ...)
        n, s, c = args[7], args[8], args[9] * args[10]
        nbytes = s * (n * 256 + c * 256 + c * 4 + c * 4 + n * 4) + s * n * (4 + 4)
        return _least(0, 1, nbytes)
    if name == "nullspace_inverse_iteration":  # (A, x, batch, n, iterations, stream)
        b, n = args[2], args[3]
        return _least(0, 1, b * n * n * 4 + b * n * 4)
    if name == "svd3":  # (A, U, s, V, batch, sweeps, stream)
        b = args[4]
        return _least(0, 1, b * 9 * 4 + b * (9 + 3 + 9) * 4)
    raise KeyError(name)


def interval_union_s(intervals: Iterable[Tuple[float, float]]) -> float:
    """Seconds covered by the union of (start, end) intervals in seconds."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def idle_gaps(intervals: Sequence[Tuple[float, float]], t0: float, t1: float) -> List[Tuple[float, float]]:
    """The gaps (start, end) in [t0, t1] that no interval covers."""
    gaps, cur = [], t0
    for s, e in sorted(intervals):
        if s > cur:
            gaps.append((cur, min(s, t1)))
        cur = max(cur, e)
    if cur < t1:
        gaps.append((cur, t1))
    return [g for g in gaps if g[1] > g[0]]


def percentile(values: Sequence[float], q: float) -> float:
    """The q-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default)."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def weighted_values(pairs: Iterable[Tuple[float, int]]) -> List[float]:
    """Each value repeated by its count: a step's latency counts once for
    every frame it delivered."""
    out: List[float] = []
    for v, n in pairs:
        out.extend([v] * int(n))
    return out


def kernel_device_s(events: Sequence[Tuple[str, float, float]], names: Sequence[str]) -> float:
    """Summed seconds of the device events whose name holds one of `names`."""
    return sum(e - s for n, s, e in events if any(k in n for k in names))


def kernel_least_total_s(calls: Sequence[Tuple[str, tuple]], names: Sequence[str]) -> Dict[str, float]:
    """Least seconds of the recorded launches, by kernel."""
    out: Dict[str, float] = {}
    for name, args in calls:
        if name in names:
            out[name] = out.get(name, 0.0) + kernel_least_s(name, args)
    return out

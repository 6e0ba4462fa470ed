"""What the bench's modules share: the scene, the weights, the clocks, the
card's description and the SuperPoint operation count.

The scene is the 192x640 box-room orbit with 192 frames a turn and
fx = fy = 800 (the scene of chip_smoke.py): a step moves the image ~3.3
cells of 8 px, inside the matcher's 4-cell window. Frames are taken in
orbit order; the orbit is closed, so frame ORBIT_N follows frame
ORBIT_N - 1 as any step does. At another size (the tests run 96x320) the
focal length and the frames a turn scale with the width.

Clocks. A step's or a call's time is the host clock around work that ends
in `torch.cuda.synchronize()`. A kernel's or a layer's time is CUDA events
around many launches. On the CPU (the tests' control-flow runs) both are
the host clock, and no result of such a run is a device measurement.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List

import numpy as np
import torch

from ..config import DEFAULT_CONFIG, CameraConfig, SlamConfig
from ..data import synthetic
from ..models import superpoint as sp

H, W = 192, 640
# NVIDIA H100 SXM (data sheet; dense rates at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
INT8_OPS_PER_S = 1979e12  # int8 tensor cores
PEAKS = {"int8 tensor cores": INT8_OPS_PER_S, "f32 CUDA cores": F32_OPS_PER_S}
OUT_DIR = os.path.join("build", "bench")  # reports (git-ignored)
PROFILER_MARKERS = 256  # empty kernels on each side of the work a profiler session counts


def focal(w: int = W) -> float:
    return 800.0 * w / 640


def orbit_n(w: int = W) -> int:
    """Orbit frames a turn at width w: 192 at 640, 96 at 320."""
    return 192 * w // 640


def config(h: int = H, w: int = W) -> SlamConfig:
    """DEFAULT_CONFIG at h x w with the orbit's camera."""
    f = focal(w)
    cam = CameraConfig(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h)
    return dataclasses.replace(
        DEFAULT_CONFIG, camera=cam,
        frontend=dataclasses.replace(DEFAULT_CONFIG.frontend, height=h, width=w),
        ransac=dataclasses.replace(DEFAULT_CONFIG.ransac, inlier_thresh=3.0 / f))


class Orbit:
    """The orbit's frames at h x w, rendered once each on first use, and
    its exact poses (T_w_c)."""

    def __init__(self, h: int = H, w: int = W):
        self.h, self.w, self.n = h, w, orbit_n(w)
        self.poses = synthetic.orbit_poses(self.n)
        self.K = config(h, w).working_camera.K
        self._frames: Dict[int, np.ndarray] = {}

    def frames(self, idx) -> List[np.ndarray]:
        """The frames at orbit indices `idx` (taken modulo a turn)."""
        idx = [int(k) % self.n for k in idx]
        todo = sorted(set(idx) - set(self._frames))
        with ThreadPoolExecutor(8) as pool:
            for k, img in zip(todo, pool.map(
                    lambda k: synthetic.render_box_room(self.K, self.poses[k], self.h, self.w), todo)):
                self._frames[k] = img
        return [self._frames[k] for k in idx]


def ping_pong(frame: int, images: int) -> int:
    """The orbit index shown at `frame` of a stream that runs forward over
    the first `images` orbit frames and back again
    (tests/test_long_sequence.py:31): a revisit every period with no jump."""
    period = 2 * (images - 1)
    k = frame % period
    return k if k < images else period - k


def load(device: torch.device):
    """The weights on `device`; the kernels built before any clock runs."""
    if device.type == "cuda":
        from ..ops.kernels import _build

        _build.library()
    return sp.load_params(device=device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize()


def wall_s(fn: Callable, device: torch.device):
    """(seconds, result) of fn() on the host clock, the device drained on
    both sides."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def median_call_s(fn: Callable, device: torch.device, iters: int, runs: int = 3, warmup: int = 2) -> float:
    """Median over `runs` of the mean host-clock seconds a call over `iters`
    back-to-back calls, each run ending in a synchronize."""
    for _ in range(warmup):
        fn()
    return float(np.median([wall_s(lambda: [fn() for _ in range(iters)], device)[0] / iters
                            for _ in range(runs)]))


def event_ms(fn: Callable, device: torch.device, iters: int, warmup: int = 3) -> float:
    """Milliseconds a call of fn over `iters` back-to-back launches: CUDA
    events on a card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    if device.type != "cuda":
        return wall_s(lambda: [fn() for _ in range(iters)], device)[0] * 1e3 / iters
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _markers() -> None:
    for _ in range(PROFILER_MARKERS):
        torch.cuda._sleep(0)  # an empty spin kernel, which no measured function launches


def device_busy_ms(fn: Callable, device: torch.device) -> tuple:
    """(device-busy ms, kernel launches) of one call of fn from
    torch.profiler; (None, None) on the CPU. In a process that has already
    held a session with many kernels, every later session lost the first
    few of its kernel records, idle time before them or not. So the call
    sits between PROFILER_MARKERS empty kernels on each side, which take the
    loss, and the markers are left out of the count."""
    if device.type != "cuda":
        fn()
        return None, None
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _markers()
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
        _markers()
        torch.cuda.synchronize()
    kern = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation and "spin_kernel" not in e.name]
    return sum(e.time_range.elapsed_us() for e in kern) / 1e3, len(kern)


def device_info(device: torch.device) -> dict:
    """The card's name and power limit as nvidia-smi reports them, and the
    card count; on the CPU, a record that says no card was measured."""
    if device.type != "cuda":
        return {"name": "cpu: a control-flow run, no device measurement", "power_limit": None,
                "count": 0}
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout
    name, power = (f.strip() for f in out.strip().splitlines()[0].split(","))
    return {"name": name, "power_limit": power, "count": torch.cuda.device_count()}


def require_cuda(prog: str) -> torch.device:
    """The card, or exit non-zero: the bench has no CPU fallback."""
    if not torch.cuda.is_available():
        raise SystemExit(f"{prog}: no CUDA device (torch.cuda.is_available() is False); the bench "
                         "measures the card and has no CPU fallback")
    return torch.device("cuda")


def conv_ops(hc: int, wc: int, cin: int, cout: int, k: int = 3) -> int:
    """Operations (2 a multiply-add) of a k x k convolution at hc x wc."""
    return 2 * hc * wc * cin * cout * k * k


def superpoint_flops(h: int = H, w: int = W) -> List[dict]:
    """SuperPoint's convolutions at h x w, layer by layer: name, output
    grid, operations, and the unit the port's arithmetic runs on. Stage 1
    (conv1a, conv1b) is the fused stem: int8 on the tensor cores (conv1a on
    dp4a, counted with it). The other layers are im2col + f32 matmul with
    TF32 off, on the CUDA cores. Only the convolutions are counted (20.84 G
    at 192x640, README.md's figure); no padding of the weights is."""
    layers = [("conv1a", 1, 1, 64, 3), ("conv1b", 1, 64, 64, 3), ("conv2a", 2, 64, 64, 3),
              ("conv2b", 2, 64, 64, 3), ("conv3a", 4, 64, 128, 3), ("conv3b", 4, 128, 128, 3),
              ("conv4a", 8, 128, 128, 3), ("conv4b", 8, 128, 128, 3), ("convPa", 8, 128, 256, 3),
              ("convPb", 8, 256, 65, 1), ("convDa", 8, 128, 256, 3), ("convDb", 8, 256, 256, 1)]
    return [{"name": n, "hc": h // d, "wc": w // d, "cin": ci, "cout": co, "k": k,
             "ops": conv_ops(h // d, w // d, ci, co, k),
             "unit": "int8 tensor cores" if n in ("conv1a", "conv1b") else "f32 CUDA cores"}
            for n, d, ci, co, k in layers]


def check(ok: bool, what: str) -> None:
    """A validity check of a measurement: a bench that times a wrong result
    fails rather than prints."""
    if not ok:
        raise RuntimeError(f"bench check failed: {what}")

"""Fused detector post-processing (CUDA `csrc/detector.cu`) and its plain
PyTorch version.

Port of maveric_slam_tpu/ops/pallas_kernels.py fused_detector_postproc.
"""

from __future__ import annotations

import torch

from .. import softmax_topn as st
from . import _build

launches = 0  # kernel launches since the last reset (see ops.kernels)
MAX_DEGREE = 8  # kMaxDegree of csrc/detector.cu


def detector_postproc_plain(semi_q: torch.Tensor, scale: torch.Tensor, degree: int = 5,
                            grid_w: int = 80):
    """approx_softmax_grid + subpixel_xy on a (C, 65) row-major cell list."""
    c = semi_q.shape[0]
    grid3 = semi_q.reshape(c // grid_w, grid_w, 65)
    grid = st.approx_softmax_grid(grid3, scale, degree)
    xy = st.subpixel_xy(grid3, scale, grid, degree)
    return grid.probs.reshape(c), grid.indices.reshape(c), xy.reshape(c, 2)


def detector_postproc(semi_q: torch.Tensor, scale: torch.Tensor, degree: int = 5,
                      grid_w: int = 80):
    """(C, 65) int8 logits and a () f32 scale -> probs (C,) f32,
    indices (C,) int32, xy (C, 2) f32. CPU tensors take the plain version;
    CUDA tensors launch the kernel."""
    if semi_q.ndim != 2 or semi_q.shape[1] != 65 or semi_q.shape[0] % grid_w:
        raise ValueError(f"semi_q must be (C, 65) with C a multiple of {grid_w}, got {tuple(semi_q.shape)}")
    if semi_q.dtype != torch.int8:
        raise TypeError(f"semi_q must be int8, got {semi_q.dtype}")
    if semi_q.device.type == "cpu":
        return detector_postproc_plain(semi_q, scale, degree, grid_w)
    if semi_q.device.type != "cuda":
        raise ValueError(f"unsupported device {semi_q.device}")
    if not 1 <= degree <= MAX_DEGREE:
        raise ValueError(f"the kernel takes Taylor degrees 1..{MAX_DEGREE}, got {degree}")
    scale = torch.as_tensor(scale, dtype=torch.float32, device=semi_q.device).reshape(())
    semi_q = semi_q.contiguous()
    scale = scale.contiguous()
    c = semi_q.shape[0]
    probs = torch.empty(c, dtype=torch.float32, device=semi_q.device)
    idx = torch.empty(c, dtype=torch.int32, device=semi_q.device)
    xy = torch.empty(c, 2, dtype=torch.float32, device=semi_q.device)
    global launches
    with torch.cuda.device(semi_q.device):
        err = _build.library().detector_postproc(
            semi_q.data_ptr(), scale.data_ptr(), probs.data_ptr(), idx.data_ptr(),
            xy.data_ptr(), c, grid_w, degree, _build.stream_of(semi_q))
    _build.check(err, "detector_postproc")
    launches += 1
    return probs, idx, xy

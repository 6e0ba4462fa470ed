"""Fused detector post-processing (CUDA `csrc/detector.cu`) and its plain
PyTorch version.

Port of maveric_slam_tpu/ops/pallas_kernels.py fused_detector_postproc.
"""

from __future__ import annotations

import torch

from .. import softmax_topn as st



def _check(semi_q: torch.Tensor, grid_w: int, grid_h: int | None, degree: int) -> None:
    c = semi_q.shape[-2] if semi_q.ndim in (2, 3) else -1
    if semi_q.shape[-1:] != (65,) or c < 0 or c % grid_w:
        raise ValueError(f"semi_q must be (C, 65) or (S, C, 65) with C a multiple of {grid_w}, "
                         f"got {tuple(semi_q.shape)}")
    if grid_h is not None and c != grid_h * grid_w:
        raise ValueError(f"C = {c} cells is not a {grid_h} x {grid_w} grid")
    if semi_q.dtype != torch.int8:
        raise TypeError(f"semi_q must be int8, got {semi_q.dtype}")
    if degree < 1:
        raise ValueError(f"the Taylor degree must be at least 1, got {degree}")


def detector_postproc_plain(semi_q: torch.Tensor, scale: torch.Tensor, degree: int = 5,
                            grid_w: int = 80, grid_h: int | None = None):
    """approx_softmax_grid + subpixel_xy on (C, 65) or (S, C, 65) row-major
    cell lists, rows counted within each stream. Same results as
    `detector_postproc`."""
    _check(semi_q, grid_w, grid_h, degree)
    lead, c = semi_q.shape[:-2], semi_q.shape[-2]
    grid3 = semi_q.reshape(*lead, c // grid_w, grid_w, 65)
    grid = st.approx_softmax_grid(grid3, scale, degree)
    xy = st.subpixel_xy(grid3, scale, grid, degree)
    return grid.probs.reshape(*lead, c), grid.indices.reshape(*lead, c), xy.reshape(*lead, c, 2)


def detector_postproc(semi_q: torch.Tensor, scale: torch.Tensor, degree: int = 5,
                      grid_w: int = 80, grid_h: int | None = None):
    """(C, 65) or (S, C, 65) int8 logits and a () f32 scale -> probs (..., C)
    f32, indices (..., C) int32, xy (..., C, 2) f32, with a cell's row
    counted within its stream. With `grid_h`, C must be grid_h * grid_w.
    CPU tensors take the plain version; CUDA tensors launch the kernel, once
    for all S streams. Any Taylor degree >= 1."""
    _check(semi_q, grid_w, grid_h, degree)
    return detector_postproc_plain(semi_q, scale, degree, grid_w, grid_h)
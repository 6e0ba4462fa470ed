"""Fused windowed int8 match (CUDA `csrc/match.cu`) and its plain PyTorch
version.

Port of maveric_slam_tpu/ops/pallas_kernels.py fused_windowed_match, with
the jnp path's first-maximum argmax as the contract.
"""

from __future__ import annotations

import torch




def windowed_match_plain(desc1_sel, desc0, probs0, indices0, cells1, grid_h: int,
                         grid_w: int, shift=(0, 0), radius: int = 4,
                         min_prob: float = 0.1, signed: bool = True):
    """The jnp path of maveric_slam_tpu/ops/matching.py:82-114, over any
    leading stream axes.

    The int8 dots are carried in f32 (exact: |dot| <= 128*128*256 < 2^24)
    with TF32 off, then formed into cos2 in the jnp order."""
    num_cells = grid_h * grid_w
    q1 = desc1_sel.to(torch.int32)
    d0 = desc0.to(torch.int32)
    dots = desc1_sel.to(torch.float32) @ desc0.to(torch.float32).transpose(-1, -2)  # (..., N, C)
    n1 = torch.sum(q1 * q1, dim=-1).to(torch.float32)
    n0 = torch.sum(d0 * d0, dim=-1).to(torch.float32)
    denom = torch.clamp(n1[..., :, None] * n0[..., None, :], min=1.0)
    cos2 = dots * dots / denom
    if signed:
        cos2 = torch.where(dots > 0, cos2, 0.0)
    cells1 = cells1.long()
    row1 = (cells1 // grid_w)[..., None]
    col1 = (cells1 % grid_w)[..., None]
    cell_ids = torch.arange(num_cells, device=desc0.device)
    row0 = cell_ids // grid_w
    col0 = cell_ids % grid_w
    in_window = (torch.abs(row0 - (row1 + shift[1])) <= radius) & (
        torch.abs(col0 - (col1 + shift[0])) <= radius
    )
    cell_ok = (indices0 != 64) & (probs0 >= min_prob)
    score = torch.where(in_window & cell_ok[..., None, :], cos2, -1.0)
    best_cell = torch.argmax(score, dim=-1)
    best_score = torch.gather(score, -1, best_cell[..., None])[..., 0]
    return best_score, best_cell.to(torch.int32)


def windowed_match(desc1_sel, desc0, probs0, indices0, cells1, grid_h: int,
                   grid_w: int, shift=(0, 0), radius: int = 4,
                   min_prob: float = 0.1, signed: bool = True):
    """(best_score (..., N) f32, best_cell (..., N) int32) of each query
    descriptor desc1_sel (..., N, 256) int8 against desc0 (..., C, 256) int8
    with probs0 (..., C) f32, indices0 (..., C) int32 and the query cells
    cells1 (..., N) int32, where "..." is nothing or one stream axis S:
    stream s's queries see only stream s's cells. CPU tensors take the plain
    version; CUDA tensors launch the kernel, once for all streams."""
    c = grid_h * grid_w
    lead = desc0.shape[:-2]
    n = desc1_sel.shape[-2] if desc1_sel.ndim >= 2 else -1
    if len(lead) > 1 or desc1_sel.shape != (*lead, n, 256) or desc0.shape != (*lead, c, 256):
        raise ValueError(f"descriptors must be ([S,] N, 256) and ([S,] {c}, 256), got "
                         f"{tuple(desc1_sel.shape)} and {tuple(desc0.shape)}")
    if probs0.shape != (*lead, c) or indices0.shape != (*lead, c) or cells1.shape != (*lead, n):
        raise ValueError("probs0, indices0 must be ([S,] C) and cells1 ([S,] N)")
    if desc1_sel.dtype != torch.int8 or desc0.dtype != torch.int8:
        raise TypeError("descriptors must be int8")
    dev = desc0.device
    if any(t.device != dev for t in (desc1_sel, probs0, indices0, cells1)):
        raise ValueError("all inputs must be on one device")
    return windowed_match_plain(desc1_sel, desc0, probs0, indices0, cells1, grid_h,
                                grid_w, shift, radius, min_prob, signed)

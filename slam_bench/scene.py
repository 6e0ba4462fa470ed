"""The benchmark's scene and its inputs: a camera orbiting inside a textured
box room, each frame ray-cast analytically, with every pose known exactly
(a frozen copy of the port's `data/synthetic.py`), and the content-unique
inputs made from it and a run's seed.

Conventions: camera x right, y down, z forward; poses are T_w_c
(camera-to-world); world y points down.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Iterable, List

import numpy as np
import torch

NOISE_SIGMA = 0.02  # ~2.5 input quantization steps: no two inputs are equal
RENDER_THREADS = 8


def _hash_cells(i: np.ndarray, j: np.ndarray, seed: float) -> np.ndarray:
    """Deterministic pseudo-random value per integer cell (shader hash)."""
    x = np.sin(i * 12.9898 + j * 78.233 + seed * 37.719) * 43758.5453
    return x - np.floor(x)


def _texture(a: np.ndarray, b: np.ndarray, fid: int) -> np.ndarray:
    """Procedural face texture, evaluated at exact 3D surface coordinates.

    Piecewise-constant random-brightness cells at two scales: every cell
    corner is a SuperPoint corner, and — unlike a checkerboard — each
    corner's neighborhood is unique, so the windowed matcher cannot alias
    onto a neighboring identical corner."""
    s = (
        0.12
        + 0.48 * _hash_cells(np.floor(a / 0.6), np.floor(b / 0.6), fid)
        + 0.28 * _hash_cells(np.floor(a / 2.3), np.floor(b / 2.3), fid + 11.0)
    )
    return np.clip(s, 0.02, 0.98).astype(np.float32)


def orbit_poses(
    num_frames: int, radius: float = 8.0, closed: bool = True
) -> np.ndarray:
    """T_w_c poses on a circle of `radius` in the y=0 plane, camera facing
    along the tangent. A closed orbit's final frames re-approach frame 0's
    pose — the ground-truth loop."""
    end = 2 * np.pi if closed else np.pi
    thetas = np.linspace(0.0, end, num_frames, endpoint=False)
    poses = []
    for th in thetas:
        pos = np.array([radius * np.sin(th), 0.0, -radius * np.cos(th)])
        forward = np.array([np.cos(th), 0.0, np.sin(th)])
        down = np.array([0.0, 1.0, 0.0])
        right = np.cross(down, forward)
        T = np.eye(4)
        T[:3, 0] = right
        T[:3, 1] = down
        T[:3, 2] = forward
        T[:3, 3] = pos
        assert abs(np.linalg.det(T[:3, :3]) - 1.0) < 1e-9
        poses.append(T)
    return np.stack(poses)


def render_box_room(
    K: np.ndarray,
    T_w_c: np.ndarray,
    height: int,
    width: int,
    half_extent=(15.0, 3.0, 15.0),
) -> np.ndarray:
    """Ray-cast one frame from inside an axis-aligned textured box.

    Every pixel ray exits the box through exactly one face (the camera is
    interior); intensity is the face texture evaluated at the exact
    continuous hit coordinates — zero resampling error between frames.
    """
    hx, hy, hz = half_extent
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    u, v = np.meshgrid(
        np.arange(width, dtype=np.float64) + 0.5,
        np.arange(height, dtype=np.float64) + 0.5,
    )
    d_cam = np.stack(
        [(u - cx) / fx, (v - cy) / fy, np.ones_like(u)], axis=-1
    )  # (H, W, 3)
    R = T_w_c[:3, :3]
    o = T_w_c[:3, 3]
    d = d_cam @ R.T  # world-frame ray directions
    assert (np.abs(o) < np.array([hx, hy, hz]) - 1e-6).all(), (
        "camera must stay inside the room"
    )

    # AABB exit distance per axis: t to the face the ray is heading toward.
    ext = np.array([hx, hy, hz])
    with np.errstate(divide="ignore"):
        t_axis = (np.sign(d) * ext - o) / d  # (H, W, 3); inf where d==0
    t_axis = np.where(np.isfinite(t_axis), t_axis, np.inf)
    axis = np.argmin(t_axis, axis=-1)  # which face plane is hit
    t_hit = np.take_along_axis(t_axis, axis[..., None], axis=-1)[..., 0]
    p = o + d * t_hit[..., None]  # (H, W, 3) exact hit points

    img = np.zeros((height, width), np.float32)
    uv_axes = {0: (1, 2), 1: (0, 2), 2: (0, 1)}  # face -> in-plane axes
    for ax in range(3):
        for side in (0, 1):
            sel = (axis == ax) & ((d[..., ax] > 0) == bool(side))
            if not sel.any():
                continue
            a_ax, b_ax = uv_axes[ax]
            fid = ax * 2 + side
            img[sel] = _texture(p[sel][:, a_ax], p[sel][:, b_ax], fid)
    return img


def ping_pong(frame: int, images: int) -> int:
    """The orbit index shown at `frame` of a stream that runs forward over
    the first `images` orbit frames and back again, with no jump."""
    period = 2 * (images - 1)
    k = frame % period
    return k if k < images else period - k


def camera_K(h: int, w: int, fx: float) -> np.ndarray:
    return np.array([[fx, 0.0, w / 2], [0.0, fx, h / 2], [0.0, 0.0, 1.0]], np.float32)


class Scene:
    """The orbit of `frames_per_turn` frames at h x w and focal length fx:
    its exact poses, and the frames at the indices a cell uses, rendered in
    RENDER_THREADS threads and held on `device` as one (n, h, w) tensor."""

    def __init__(self, h: int, w: int, fx: float, frames_per_turn: int):
        self.h, self.w, self.n = h, w, frames_per_turn
        self.K = camera_K(h, w, fx)
        self.poses = orbit_poses(frames_per_turn)
        self.slot: Dict[int, int] = {}
        self.frames: torch.Tensor | None = None

    def render(self, indices: Iterable[int], device) -> None:
        idx = sorted({int(k) % self.n for k in indices})
        with ThreadPoolExecutor(RENDER_THREADS) as pool:
            imgs = list(pool.map(
                lambda k: render_box_room(self.K, self.poses[k], self.h, self.w), idx))
        self.slot = {k: i for i, k in enumerate(idx)}
        self.frames = torch.from_numpy(np.stack(imgs)).to(device)

    def inputs(self, orbit_idx: List[int], seed: int, unit: int) -> torch.Tensor:
        """(len(orbit_idx), h, w) f32 inputs of one unit of work (a step of
        S streams, or one engine frame): the orbit frames plus N(0,
        NOISE_SIGMA) noise drawn on their device from a generator seeded by
        (seed, unit), clipped to [0, 1]."""
        dev = self.frames.device
        g = torch.Generator(device=dev).manual_seed(unit_seed(seed, unit))
        base = self.frames[[self.slot[int(k) % self.n] for k in orbit_idx]]
        noise = torch.randn(base.shape, generator=g, device=dev, dtype=torch.float32)
        return torch.clamp(base + NOISE_SIGMA * noise, 0.0, 1.0)


def unit_seed(seed: int, unit: int) -> int:
    """A 63-bit generator seed for one unit of a run."""
    return (int(seed) * 0x9E3779B97F4A7C15 + int(unit) * 0xBF58476D1CE4E5B9 + 1) % (1 << 63)

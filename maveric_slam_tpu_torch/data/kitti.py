"""KITTI odometry dataset loading and preprocessing (the port's own numpy
copy of maveric_slam_tpu/data/kitti.py).

Host-side input pipeline: grayscale decode, [0,1] normalize, bilinear
resize to the working resolution (no antialias, matching the golden
pipeline's torchvision Resize on tensors), plus ground-truth pose parsing
(outputs/00.txt format: 3x4 row-major per line). cv2 (or PIL) is imported
only by the functions that decode.
"""

from __future__ import annotations

import glob
import os
from typing import Iterator, List, Tuple

import numpy as np


def _cv2():
    """cv2, or None where it is not installed."""
    try:
        import cv2
    except ImportError:  # pragma: no cover
        return None
    return cv2


def load_grayscale(path: str) -> np.ndarray:
    """Read an image as float32 grayscale in [0, 1] at native resolution."""
    cv2 = _cv2()
    if cv2 is not None:
        img = cv2.imread(path, 0)
        if img is None:
            raise IOError(f"cannot read image: {path}")
    else:  # pragma: no cover
        from PIL import Image

        img = np.asarray(Image.open(path).convert("L"))
    return img.astype(np.float32) / 255.0


def resize_bilinear(img: np.ndarray, height: int, width: int) -> np.ndarray:
    """Half-pixel bilinear resize without antialias.

    Matches torchvision.transforms.Resize on tensors (the golden pipeline,
    pairwise_pnp.py:624) == cv2.INTER_LINEAR. Implemented in numpy so results
    are identical on every host.
    """
    h, w = img.shape
    # Half-pixel sample centers.
    ys = (np.arange(height) + 0.5) * (h / height) - 0.5
    xs = (np.arange(width) + 0.5) * (w / width) - 0.5
    y0 = np.clip(np.floor(ys).astype(np.int32), 0, h - 1)
    x0 = np.clip(np.floor(xs).astype(np.int32), 0, w - 1)
    y1 = np.minimum(y0 + 1, h - 1)
    x1 = np.minimum(x0 + 1, w - 1)
    wy = np.clip(ys - y0, 0.0, 1.0)[:, None]
    wx = np.clip(xs - x0, 0.0, 1.0)[None, :]
    top = img[y0][:, x0] * (1 - wx) + img[y0][:, x1] * wx
    bot = img[y1][:, x0] * (1 - wx) + img[y1][:, x1] * wx
    return (top * (1 - wy) + bot * wy).astype(np.float32)


def load_frame(path: str, height: int = 192, width: int = 640) -> np.ndarray:
    """Decode + resize one frame to the working resolution."""
    return resize_bilinear(load_grayscale(path), height, width)


class VideoStreamer:
    """Frame source: webcam, video file, or image directory.

    Full capability of the reference VideoStreamer
    (superpoint_inference.py:468-555): basedir == "camera" opens a webcam,
    a video-file path streams frames via cv2.VideoCapture, anything else is
    treated as an image directory. Yields float32 [0,1] frames at the
    working resolution.
    """

    def __init__(
        self,
        basedir: str,
        height: int = 192,
        width: int = 640,
        camid: int = 0,
        skip: int = 1,
        img_glob: str = "*.png",
    ):
        self.height, self.width = height, width
        self.skip = skip
        self._seq = None
        self._cap = None
        cv2 = _cv2()
        if basedir in ("camera", "camera/"):
            if cv2 is None:  # pragma: no cover
                raise IOError("camera input requires cv2")
            self._cap = cv2.VideoCapture(camid)
            if not self._cap.isOpened():
                raise IOError(f"cannot open camera {camid}")
        elif os.path.isfile(basedir):
            if cv2 is None:  # pragma: no cover
                raise IOError("video input requires cv2")
            self._cap = cv2.VideoCapture(basedir)
            if not self._cap.isOpened():
                raise IOError(f"cannot open video {basedir}")
        else:
            self._seq = ImageSequence(basedir, height, width, img_glob, skip)
            self._idx = 0

    def next_frame(self):
        """Returns (frame, True) or (None, False) at end of stream."""
        if self._seq is not None:
            if self._idx >= len(self._seq):
                return None, False
            img = self._seq[self._idx]
            self._idx += 1
            return img, True
        for _ in range(self.skip):
            ret, raw = self._cap.read()
            if not ret:
                return None, False
        cv2 = _cv2()
        gray = cv2.cvtColor(raw, cv2.COLOR_BGR2GRAY).astype(np.float32) / 255.0
        return resize_bilinear(gray, self.height, self.width), True

    def __iter__(self):
        while True:
            img, ok = self.next_frame()
            if not ok:
                return
            yield img


class ImageSequence:
    """Iterates frames of a KITTI sequence directory (or any image glob).

    Parity with the reference VideoStreamer's image-directory mode
    (superpoint_inference.py:494-502), with deterministic sorted ordering.
    """

    def __init__(
        self,
        basedir: str,
        height: int = 192,
        width: int = 640,
        img_glob: str = "*.png",
        skip: int = 1,
    ):
        self.height, self.width = height, width
        self.paths: List[str] = sorted(glob.glob(os.path.join(basedir, img_glob)))[::skip]
        if not self.paths:
            raise IOError(f"no images found under {basedir}/{img_glob}")

    def __len__(self) -> int:
        return len(self.paths)

    def __getitem__(self, i: int) -> np.ndarray:
        return load_frame(self.paths[i], self.height, self.width)

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(len(self)):
            yield self[i]


def read_poses(path: str) -> np.ndarray:
    """Read KITTI-format poses: each line 12 floats = row-major 3x4 [R|t].

    Returns (N, 4, 4) homogeneous cam-to-world transforms.
    """
    rows = []
    with open(path) as f:
        for line in f:
            vals = [float(v) for v in line.split()]
            if len(vals) != 12:
                continue
            M = np.eye(4, dtype=np.float64)
            M[:3, :] = np.array(vals).reshape(3, 4)
            rows.append(M)
    return np.stack(rows)


def relative_transforms(poses: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Relative transform between consecutive poses: T_rel = T2 @ inv(T1).

    Reimplementation of the reference's GT extractor
    (python/compute_pairwise_diff.py:15-41). Returns (R: (N-1,3,3),
    t: (N-1,3)).
    """
    T1 = poses[:-1]
    T2 = poses[1:]
    rel = np.einsum("nij,njk->nik", T2, np.linalg.inv(T1))
    return rel[:, :3, :3], rel[:, :3, 3]

"""The reference's baked C data headers as arrays (port of
maveric_slam_tpu/data/refdata.py).

The reference keeps its fixtures as C arrays in headers (quantized
SuperPoint grids, float features, GT softmax grids, the BoW vocabulary).
The JAX package parses them once into npz files under its
`data/_refcache/`, which ship with the repository; this module reads only
those files, by path, and never the headers or the directory they came
from. The transforms below are the JAX package's.

Formats (reference):
- quantized_image0.h: int8 semi[1920][65] / desc[1920][256] + scales,
  patch order = col * 24 + row;
- pair0_gt.h: float max-softmax prob + argmax index per cell, [80][24];
- pair0.h: float keypoints xs/ys/scores + [N][256] descriptors (pair10.h
  is not in the cache);
- vocabulary.h: scale/bias per base node, base_descriptors[256][10]
  (unsigned bytes, viewed as int8), leaf_descriptors[10][1000][4].
"""

from __future__ import annotations

import functools
import os
from typing import Dict

import numpy as np

# The JAX package's cache of the parsed headers, read by path (not imported).
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "maveric_slam_tpu", "data", "_refcache",
)


def header_path(rel_path: str) -> str:
    """The cached npz of a header, e.g. "include/data/LCD/vocabulary.h"."""
    return os.path.join(CACHE_DIR, rel_path.replace("/", "_") + ".npz")


@functools.lru_cache(maxsize=None)
def load_header(rel_path: str) -> Dict[str, np.ndarray]:
    """A header's arrays and scalars from the shipped cache (memoized; the
    caller must not write into them)."""
    path = header_path(rel_path)
    if not os.path.exists(path):
        raise FileNotFoundError(f"{rel_path} is not in the shipped header cache ({path})")
    with np.load(path, allow_pickle=False) as z:
        return dict(z)


def quantized_image0():
    """int8 semi/desc grids for image0 + scales, in (Hc, Wc, C) layout."""
    d = load_header("include/data/quantized/quantized_image0.h")
    hc, wc = int(d["image0_feature_rows"]), int(d["image0_feature_cols"])
    # Header patch order: patch = col * Hc + row.
    return {
        "semi": d["image0_semi"].reshape(wc, hc, 65).transpose(1, 0, 2),
        "desc": d["image0_desc"].reshape(wc, hc, 256).transpose(1, 0, 2),
        "semi_scale": float(d["image0_semi_scale"]),
        "desc_scale": float(d["image0_desc_scale"]),
    }


def gt_softmax_grids():
    """Float GT max-prob / argmax grids for image0 and image1, (Hc, Wc)."""
    d = load_header("include/data/quantized/pair0_gt.h")
    out = {}
    for i in (0, 1):
        out[f"probs{i}"] = d[f"image{i}_probs_gt"].transpose(1, 0).astype(np.float32)  # [80][24]
        out[f"indices{i}"] = d[f"image{i}_indices_gt"].transpose(1, 0).astype(np.int32)
    return out


def float_features(pair: str = "pair0"):
    """Float keypoints + descriptors of a baked pair header."""
    d = load_header(f"include/data/tracking/{pair}.h")
    out = {}
    for i in (0, 1):
        out[f"xs{i}"] = d[f"image{i}_feature_xs"].astype(np.int32)
        out[f"ys{i}"] = d[f"image{i}_feature_ys"].astype(np.int32)
        out[f"scores{i}"] = d[f"image{i}_feature_scores"].astype(np.float32)
        out[f"desc{i}"] = d[f"image{i}_feature_descriptors"].astype(np.float32)
    return out


def vocabulary():
    """BoW vocabulary: base node affine params + descriptors + leaf words,
    the leaf words in their true 4-word (128-bit) layout."""
    return vocabulary_arrays(load_header("include/data/LCD/vocabulary.h"))


def vocabulary_arrays(d) -> dict:
    """`vocabulary()`'s transforms of a vocabulary header's arrays `d`."""
    return {
        "num_base_nodes": int(d["num_base_nodes"]),
        "words_per_base_node": int(d["words_per_base_node"]),
        "scale": d["scale_arr"].astype(np.float32),
        "bias": d["bias_arr"].astype(np.float32),
        # Stored [256][10]; (num_nodes, 256) here.
        "base_descriptors": np.ascontiguousarray(d["base_descriptors"].astype(np.int8).transpose(1, 0)),
        "leaf_descriptors": d["leaf_descriptors"].astype(np.int64).astype(np.uint32),
    }

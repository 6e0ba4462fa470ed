"""BoW vocabulary: descriptor -> visual-word assignment (port of
maveric_slam_tpu/loopclosure/vocab.py).

Base node: the (N, 256) int8 descriptors times the (256, B) int8 base
descriptors, then the per-node affine calibration, first-max argmax.
Leaf word: the sign bits of the first 128 descriptor entries against every
leaf word of the chosen node as a +-1 product, whose value is
128 - 2 * Hamming distance.

Exactness. Both products are integers computed in f32 (TF32 off, set at
package import): a base-node dot is at most 256 * 128 * 128 = 2^22 and a
leaf dot at most 128 in magnitude, so every partial sum is exact and the
result does not depend on the order of the sums. The affine calibration
keeps the JAX package's order of operations, `dots * desc_scale / 256`,
then `scale * s + 256 * bias`, so that nearly tied scores round alike.

The 32-bit words of the binary descriptors are unsigned; PyTorch has no
uint32 arithmetic, so they are held in int64 with the same values.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data import refdata
from ..ops.backend import resolve_device


class Vocabulary(NamedTuple):
    base_descriptors: torch.Tensor  # (B, 256) int8
    scale: torch.Tensor  # (B,) float32 per-node affine scale
    bias: torch.Tensor  # (B,) float32 per-node affine bias
    leaf_words: torch.Tensor  # (B, W, 4) int64 holding uint32 words (128 bits)
    leaf_bits: torch.Tensor  # (128, B*W) int8: the same words as +-1 columns
    num_base_nodes: int
    words_per_base_node: int


def _unpack_pm1(leaf_words: np.ndarray) -> np.ndarray:
    """(B, W, 4) uint32 -> (128, B*W) int8 in {-1, +1}, most significant bit
    first (column b*W+w, row e: the sign of descriptor entry e of word (b, w))."""
    b, w, _ = leaf_words.shape
    flat = leaf_words.reshape(b * w, 4).astype(np.uint32)
    shifts = np.arange(31, -1, -1, dtype=np.uint32)
    bits = (flat[:, :, None] >> shifts[None, None, :]) & 1  # (BW, 4, 32)
    return np.where(bits.reshape(b * w, 128), 1, -1).astype(np.int8).T


def load_reference_vocabulary(path: str | None = None, device=None) -> Vocabulary:
    """The reference's vocabulary on `device` (None: CUDA), through
    `data.refdata.vocabulary()` (the shipped header cache), or from the
    cached header npz at `path`."""
    dev = resolve_device(device)
    if path is None:
        d = refdata.vocabulary()
    else:
        with np.load(path) as z:
            d = refdata.vocabulary_arrays(z)
    leaves = d["leaf_descriptors"]
    return Vocabulary(
        base_descriptors=torch.from_numpy(d["base_descriptors"]).to(dev),
        scale=torch.from_numpy(d["scale"]).to(dev),
        bias=torch.from_numpy(d["bias"]).to(dev),
        leaf_words=torch.from_numpy(leaves.astype(np.int64)).to(dev),
        leaf_bits=torch.from_numpy(np.ascontiguousarray(_unpack_pm1(leaves))).to(dev),
        num_base_nodes=d["num_base_nodes"],
        words_per_base_node=d["words_per_base_node"],
    )


def binarize_descriptors(desc_q: torch.Tensor) -> torch.Tensor:
    """Sign-binarize (N, 256) int8 descriptors into (N, 8) 32-bit words (as
    int64): word i packs entries [32 i, 32 (i + 1)), most significant bit
    first (the reference's bow_main.c:13-39)."""
    bits = (desc_q > 0).to(torch.int64).reshape(desc_q.shape[0], 8, 32)
    shifts = torch.arange(31, -1, -1, dtype=torch.int64, device=desc_q.device)
    return torch.sum(bits << shifts, dim=-1)


class WordAssignment(NamedTuple):
    base_node: torch.Tensor  # (N,) int32, -1 for masked features
    word: torch.Tensor  # (N,) int32 leaf word within the node, -1 masked
    word_id: torch.Tensor  # (N,) int32 global id = base * W + word, -1 masked
    matching_bits: torch.Tensor  # (N,) int32 equal bits of the winning word, 0 masked


def assign_words(desc_q: torch.Tensor, desc_scale, mask: torch.Tensor, vocab: Vocabulary,
                 positive_gate: bool = False) -> WordAssignment:
    """Visual words of N int8 descriptors (the reference's bow_main.c path),
    on their device. `positive_gate=True` keeps the reference's score > 0
    gate on the base node, which sends every feature to node 0 with this
    vocabulary's calibration; the default takes the plain argmax."""
    b, wpn = vocab.num_base_nodes, vocab.words_per_base_node
    dots = desc_q.to(torch.float32) @ vocab.base_descriptors.to(torch.float32).T  # (N, B)
    s = dots * torch.as_tensor(desc_scale, dtype=torch.float32, device=dots.device) / 256.0
    scores = vocab.scale[None, :] * s + 256.0 * vocab.bias[None, :]
    base = torch.argmax(scores, dim=-1)
    if positive_gate:
        base = torch.where(torch.amax(scores, dim=-1) > 0, base, 0)

    # Leaf search: (128 + dot(f, l)) / 2 equal bits for f, l in {-1, +1}^128,
    # over the chosen node's words; ties go to the lowest word.
    feat_pm1 = torch.where(desc_q[:, :128] > 0, 1.0, -1.0)
    dots_leaf = (feat_pm1 @ vocab.leaf_bits.to(torch.float32)).to(torch.int32)  # (N, B*W)
    in_node = torch.take_along_dim(dots_leaf.reshape(-1, b, wpn), base[:, None, None], dim=1)[:, 0]
    word = torch.argmax(in_node, dim=-1)
    best = (128 + torch.take_along_dim(in_node, word[:, None], dim=-1)[:, 0]) // 2
    return WordAssignment(
        base_node=torch.where(mask, base, -1).to(torch.int32),
        word=torch.where(mask, word, -1).to(torch.int32),
        word_id=torch.where(mask, base * wpn + word, -1).to(torch.int32),
        matching_bits=torch.where(mask, best, 0).to(torch.int32),
    )

"""LightGlue's operations and bytes, from a configuration file's sizes (its
`lightglue` block and `max_keypoints`, K a side): the least time of a pair
at the card's float32 peak, and that of its attention.

Nothing here imports the program. Operations count 2 a multiply-add, every
layer and every keypoint at full depth and width, as the configuration
states. The cross block's similarity S = qk_0 qk_1^T is counted once: both
softmax directions read the one S. Smaller terms (softmaxes, LayerNorm,
GELU, the rotary encoding, the filter) are left out.
"""

from __future__ import annotations

from slam_bench import yardstick


def _sizes(cfg: dict):
    lg = cfg["lightglue"]
    return int(cfg["max_keypoints"]), int(lg["descriptor_dim"]), int(lg["mlp_dim"]), int(lg["n_layers"])


def self_block_ops(cfg: dict) -> int:
    """One image's self block: qkv, q k^T and a v over all heads, the output
    projection and the MLP on [x, message]."""
    k, d, m, _ = _sizes(cfg)
    return 2 * k * d * 3 * d + 2 * (2 * k * k * d) + 2 * k * d * d + 2 * k * 2 * d * m + 2 * k * m * d


def cross_block_ops(cfg: dict) -> int:
    """One pair's cross block: to_qk, to_v, to_out and the MLP of both
    images, S once, and a v in both directions."""
    k, d, m, _ = _sizes(cfg)
    per_image = 3 * (2 * k * d * d) + 2 * k * 2 * d * m + 2 * k * m * d
    return 2 * per_image + 2 * k * k * d + 2 * (2 * k * k * d)


def assignment_ops(cfg: dict) -> int:
    """One pair's assignment: final_proj and matchability of both images and
    the similarity."""
    k, d, _, _ = _sizes(cfg)
    return 2 * (2 * k * d * d + 2 * k * d) + 2 * k * k * d


def pair_ops(cfg: dict) -> int:
    """Operations of one pair at full depth."""
    n = _sizes(cfg)[3]
    return n * (2 * self_block_ops(cfg) + cross_block_ops(cfg)) + assignment_ops(cfg)


def attention_ops(cfg: dict) -> int:
    """One pair's attention products: q k^T and a v of the self block on
    both images, S once and a v in both directions of the cross block."""
    k, d, _, n = _sizes(cfg)
    return n * (2 * 2 * (2 * k * k * d) + 3 * (2 * k * k * d))


def attention_bytes(cfg: dict) -> int:
    """One pair's attention inputs and outputs in float32, each read or
    written once: q, k, v and the output of each image's self attention;
    qk and v of both images and both outputs of the cross attention."""
    k, d, _, n = _sizes(cfg)
    return n * 4 * k * d * (2 * 4 + 6)


def attention_least_s(cfg: dict) -> float:
    """The least time of one pair's attention at the float32 peak and HBM."""
    return max(attention_ops(cfg) / yardstick.F32_OPS_PER_S,
               attention_bytes(cfg) / yardstick.HBM_BYTES_PER_S)


def pair_least_s(cfg: dict) -> float:
    """The least time of one pair's operations at the float32 peak."""
    return pair_ops(cfg) / yardstick.F32_OPS_PER_S

"""Device-resident feature pool (port of
maveric_slam_tpu/mapping/feature_pool.py).

A direct-mapped table indexed by visual-word id, structure of arrays:
(first_seen, last_seen, num_sightings) per word, enough for the age-out
policy and covisibility weights. Every operation is a masked, vectorized
update on the table's device.

observe_batch marks the words a frame holds by writing True at each word
id; invalid ids (< 0) go to a spare slot past the vocabulary, so they never
touch a real word, and duplicate ids write the same value, so they count
once and the result does not depend on the order of the writes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class DevicePool(NamedTuple):
    first_seen: torch.Tensor  # (V,) int32, -1 when absent
    last_seen: torch.Tensor  # (V,) int32
    num_sightings: torch.Tensor  # (V,) int32 (capped at window)
    coords: torch.Tensor  # (V, 3) float32 optional 3-D anchor
    window: int  # age-out window in frames


def create(vocab_size: int, window: int = 8, device=None) -> DevicePool:
    return DevicePool(
        first_seen=torch.full((vocab_size,), -1, dtype=torch.int32, device=device),
        last_seen=torch.full((vocab_size,), -1, dtype=torch.int32, device=device),
        num_sightings=torch.zeros((vocab_size,), dtype=torch.int32, device=device),
        coords=torch.zeros((vocab_size, 3), dtype=torch.float32, device=device),
        window=window,
    )


def observe_batch(pool: DevicePool, word_ids: torch.Tensor, frame_num) -> DevicePool:
    """Record one frame's sightings (word ids < 0 ignored); `frame_num` is
    an int or a 0-d tensor."""
    v = pool.last_seen.shape[0]
    slot = torch.where(word_ids >= 0, word_ids.long(), v)
    hit = torch.zeros(v + 1, dtype=torch.bool, device=word_ids.device).index_fill_(0, slot, True)[:v]
    present = pool.last_seen >= 0
    seen_this_frame = pool.last_seen == frame_num
    frame = torch.as_tensor(frame_num, dtype=torch.int32, device=pool.last_seen.device)
    return pool._replace(
        first_seen=torch.where(hit & ~present, frame, pool.first_seen),
        last_seen=torch.where(hit, frame, pool.last_seen),
        num_sightings=torch.clamp(pool.num_sightings + (hit & ~seen_this_frame).to(torch.int32),
                                  max=pool.window),
    )


def remove_old(pool: DevicePool, current_frame) -> DevicePool:
    """Evict words last seen before current_frame - window + 1."""
    stale = (pool.last_seen >= 0) & (pool.last_seen < current_frame - pool.window + 1)
    return pool._replace(
        first_seen=torch.where(stale, -1, pool.first_seen),
        last_seen=torch.where(stale, -1, pool.last_seen),
        num_sightings=torch.where(stale, 0, pool.num_sightings),
    )


def size(pool: DevicePool) -> torch.Tensor:
    return torch.sum(pool.last_seen >= 0, dtype=torch.int32)


def covisibility_weights(pool: DevicePool, word_ids: torch.Tensor) -> torch.Tensor:
    """Sighting counts for a query set (0 for absent or invalid ids)."""
    ok = word_ids >= 0
    return torch.where(ok, pool.num_sightings[torch.where(ok, word_ids.long(), 0)], 0)


def check_invariant(pool: DevicePool, current_frame) -> torch.Tensor:
    """0 when consistent (the reference's checker as a reduction): + 1 for a
    stale survivor, + 2 for first > last, + 4 for a count/presence mismatch."""
    present = pool.last_seen >= 0
    stale = present & (pool.last_seen < current_frame - pool.window + 1)
    order = present & (pool.first_seen > pool.last_seen)
    count = (present & (pool.num_sightings < 1)) | (~present & (pool.num_sightings != 0))
    return (torch.any(stale).to(torch.int32) + 2 * torch.any(order).to(torch.int32)
            + 4 * torch.any(count).to(torch.int32))

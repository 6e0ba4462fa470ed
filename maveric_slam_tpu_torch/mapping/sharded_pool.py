"""Word-sharded device feature pool (port of
maveric_slam_tpu/mapping/sharded_pool.py).

The pool is a direct-mapped table indexed by visual word, so it splits over
the mesh by word: rank r owns ids [r V/n, (r+1) V/n). A rank applies the
single-device operations of mapping/feature_pool.py to its block with the
word ids moved into its range (ids it does not own become -1, which those
operations ignore), so every update is local and exact. A covisibility
query sums the ranks' parts (zeros off-block) in one all-reduce; the
engine's host copy of the sighting table is one all_gather.
"""

from __future__ import annotations

import torch

from ..parallel import mesh as mesh_lib
from ..parallel.mesh import Mesh
from . import feature_pool
from .feature_pool import DevicePool

WORD_AXIS = "word"


def create(vocab_size: int, window: int, mesh: Mesh) -> DevicePool:
    """An empty pool's block on this rank (vocab_size must divide by the
    mesh size)."""
    rows = mesh_lib.local_rows(vocab_size, mesh, "vocabulary words")
    return feature_pool.create(rows.stop - rows.start, window=window, device=mesh.device)


def shard_pool(pool: DevicePool, mesh: Mesh) -> DevicePool:
    """This rank's block of a whole pool (a copy, on the mesh's device)."""
    rows = mesh_lib.local_rows(pool.last_seen.shape[0], mesh, "vocabulary words")
    return DevicePool(*(f[rows].to(mesh.device, copy=True) for f in pool[:-1]), window=pool.window)


def _local_ids(pool: DevicePool, word_ids: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Word ids in this rank's block as block offsets; -1 for the rest."""
    rows = pool.last_seen.shape[0]
    local = word_ids.long() - mesh_lib.axis_index(mesh) * rows
    return torch.where((word_ids >= 0) & (local >= 0) & (local < rows), local, -1)


def observe_batch(pool: DevicePool, word_ids: torch.Tensor, frame_num, mesh: Mesh) -> DevicePool:
    """feature_pool.observe_batch on this rank's block; no communication."""
    return feature_pool.observe_batch(pool, _local_ids(pool, word_ids, mesh), frame_num)


def remove_old(pool: DevicePool, current_frame, mesh: Mesh) -> DevicePool:
    """feature_pool.remove_old on this rank's block: eviction is elementwise
    over the words, so no communication."""
    return feature_pool.remove_old(pool, current_frame)


def covisibility_weights(pool: DevicePool, word_ids: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """feature_pool.covisibility_weights over the whole vocabulary, on every
    rank: each rank's counts for the ids it owns, summed."""
    return mesh_lib.psum(feature_pool.covisibility_weights(pool, _local_ids(pool, word_ids, mesh)),
                         mesh)


def gather_sightings(pool: DevicePool, mesh: Mesh) -> torch.Tensor:
    """The whole (V,) sighting table on every rank."""
    return mesh_lib.all_gather(pool.num_sightings, mesh).reshape(-1)

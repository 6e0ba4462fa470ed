"""Frame-sharded loop-closure database (port of
maveric_slam_tpu/loopclosure/sharded_lcd.py).

The (F, V) int8 database grows with the mapped area, so its frame axis is
split over the mesh: rank r holds ring slots [r F/n, (r+1) F/n). A frame is
written by the one rank that owns its slot, with no communication; the ring
cursor is replicated on every rank's host. A query scores each rank's rows
with lcd.query's exact int32 shared-word counts, takes the first maximum
there, and one all_gather of (score, global slot, frame) per rank resolves
the global first maximum: the lowest global slot among equal scores, the
single-device `lcd.query`'s answer.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..parallel import mesh as mesh_lib
from ..parallel.mesh import Mesh
from . import lcd
from .lcd import LoopDatabase

FRAME_AXIS = "lcdf"


def create_database(max_frames: int, vocab_size: int, mesh: Mesh) -> LoopDatabase:
    """An empty database's block on this rank (max_frames must divide by
    the mesh size); its `next_slot` is the global ring cursor."""
    rows = mesh_lib.local_rows(max_frames, mesh, "database frames")
    return lcd.create_database(rows.stop - rows.start, vocab_size, device=mesh.device)


def shard_database(db: LoopDatabase, mesh: Mesh) -> LoopDatabase:
    """This rank's block of a whole database's frame rows (a copy, on the
    mesh's device) and the replicated cursor."""
    rows = mesh_lib.local_rows(db.multihot.shape[0], mesh, "database frames")
    return LoopDatabase(*(f[rows].to(mesh.device, copy=True) for f in db[:-1]),
                        next_slot=db.next_slot)


def sharded_add_frame(db: LoopDatabase, word_ids: torch.Tensor, frame, mesh: Mesh) -> LoopDatabase:
    """lcd.add_frame on the sharded database: the rank that owns the cursor's
    slot writes the row; every rank moves the cursor."""
    rows = db.multihot.shape[0]
    slot = db.next_slot
    local = slot - mesh_lib.axis_index(mesh) * rows
    if 0 <= local < rows:
        lcd.add_frame(db._replace(next_slot=local), word_ids, frame)
    return db._replace(next_slot=(slot + 1) % (rows * mesh.size))


class ShardedLoopResult(NamedTuple):
    best: torch.Tensor  # () int64 global slot of the best candidate (-1: none)
    best_frame: torch.Tensor  # () int32 frame number of the best (-1: none)
    best_score: torch.Tensor  # () float32 normalized score of the best (0: none)


def sharded_query(db: LoopDatabase, word_ids: torch.Tensor, mesh: Mesh, current_frame,
                  min_frame_gap: int = 50, min_score: float = 0.05) -> ShardedLoopResult:
    """lcd.query's candidate over the sharded database (the same answer)."""
    first = mesh_lib.axis_index(mesh) * db.multihot.shape[0]  # this rank's first global slot
    # This rank's first maximum of the masked score, whatever its value.
    mine = lcd.query(db, word_ids, current_frame, min_frame_gap, min_score=-math.inf)
    local = torch.stack([mine.best_score.double(), (mine.best + first).double(),
                         mine.best_frame.double()])
    every = mesh_lib.all_gather(local, mesh)  # (n, 3), f64 holds f32 scores and ints exactly
    w = torch.argmax(every[:, 0])  # the first maximum: the lowest rank, so the lowest slot
    score = every[w, 0].to(torch.float32)
    found = score >= min_score
    return ShardedLoopResult(
        best=torch.where(found, every[w, 1].long(), -1),
        best_frame=torch.where(found, every[w, 2].to(torch.int32), -1),
        best_score=torch.where(found, score, 0.0),
    )

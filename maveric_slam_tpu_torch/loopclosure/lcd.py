"""Loop-closure candidate detection: a BoW frame database and its scoring
(port of maveric_slam_tpu/loopclosure/lcd.py).

The database is a fixed-capacity ring of multi-hot word rows on the device;
a query counts the words it shares with every stored frame (the
reference's lcd_main.c:52-74 merge-join) and gates candidates by recency
and score.

Scores. A query holds at most N distinct words, so its shared-word counts
are the sums of N gathered int8 columns of the (F, V) database, summed in
int32: exact, and without reading the whole database. Duplicate and
invalid (< 0) word ids are dropped before the gather.

Scatters. A word row is built by writing 1 at each word id; invalid ids
are sent to a spare slot past the vocabulary, so no write can land on a
real word, and duplicate ids write the same value, so the row does not
depend on the order of the writes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class LoopDatabase(NamedTuple):
    """Fixed-capacity BoW database. Each slot stores the *frame number* it
    holds, so recency gating and slot -> frame resolution stay right after
    the cursor wraps. `add_frame` writes the device tensors in place."""

    multihot: torch.Tensor  # (F, V) int8: 1 where the frame holds the word
    counts: torch.Tensor  # (F,) int32 distinct words per frame
    frames: torch.Tensor  # (F,) int32 frame number in the slot (-1 empty)
    valid: torch.Tensor  # (F,) bool
    next_slot: int  # ring cursor (kept on the host)


def create_database(max_frames: int, vocab_size: int, device=None) -> LoopDatabase:
    return LoopDatabase(
        multihot=torch.zeros((max_frames, vocab_size), dtype=torch.int8, device=device),
        counts=torch.zeros((max_frames,), dtype=torch.int32, device=device),
        frames=torch.full((max_frames,), -1, dtype=torch.int32, device=device),
        valid=torch.zeros((max_frames,), dtype=torch.bool, device=device),
        next_slot=0,
    )


def _word_row(word_ids: torch.Tensor, vocab_size: int) -> torch.Tensor:
    """(V,) int8 multi-hot row of a word list (ids < 0 ignored, duplicates
    collapse)."""
    slot = torch.where(word_ids >= 0, word_ids.long(), vocab_size)
    row = torch.zeros(vocab_size + 1, dtype=torch.int8, device=word_ids.device)
    return row.index_fill_(0, slot, 1)[:vocab_size]


def add_frame(db: LoopDatabase, word_ids: torch.Tensor, frame) -> LoopDatabase:
    """Insert a frame's word set into the next slot (word ids < 0 are
    ignored, duplicates collapse: the reference's set semantics,
    lcd_main.c:29-35). `frame` is an int or a 0-d tensor."""
    row = _word_row(word_ids, db.multihot.shape[1])
    slot = db.next_slot
    db.multihot[slot] = row
    db.counts[slot] = torch.sum(row, dtype=torch.int32)
    db.frames[slot] = frame
    db.valid[slot] = True
    return db._replace(next_slot=(slot + 1) % db.multihot.shape[0])


class LoopCandidates(NamedTuple):
    scores: torch.Tensor  # (F,) int32 shared-word counts (the reference's metric)
    normalized: torch.Tensor  # (F,) float32 score / min(|words_a|, |words_b|)
    best: torch.Tensor  # () int64 best candidate slot (-1 if none)
    best_frame: torch.Tensor  # () int32 frame number in the best slot (-1)
    best_score: torch.Tensor  # () float32 normalized score of the best


def _distinct(word_ids: torch.Tensor):
    """(sorted ids clamped to >= 0, mask of their first valid occurrence)."""
    ids = torch.sort(torch.where(word_ids >= 0, word_ids.long(), -1)).values
    first = torch.ones_like(ids, dtype=torch.bool)
    first[1:] = ids[1:] != ids[:-1]
    return torch.clamp(ids, min=0), first & (ids >= 0)


def query(db: LoopDatabase, word_ids: torch.Tensor, current_frame, min_frame_gap: int = 50,
          min_score: float = 0.05) -> LoopCandidates:
    """Score the current frame against the whole database. Stored frames
    within `min_frame_gap` of `current_frame` (a frame number: an int or a
    0-d tensor) are excluded; the best of the rest is the first maximum of
    the normalized score, kept if it reaches `min_score`."""
    ids, keep = _distinct(word_ids)
    cols = db.multihot.index_select(1, ids)  # (F, N) int8
    scores = torch.sum(cols.to(torch.int32) * keep.to(torch.int32), dim=1, dtype=torch.int32)
    qcount = torch.sum(keep, dtype=torch.int32)
    denom = torch.clamp(torch.minimum(db.counts, qcount), min=1)
    normalized = scores.to(torch.float32) / denom.to(torch.float32)

    recent = db.frames > current_frame - min_frame_gap
    eligible = db.valid & ~recent
    masked = torch.where(eligible, normalized, -1.0)
    best = torch.argmax(masked).reshape(1)
    best_score = masked.gather(0, best)[0]
    found = best_score >= min_score
    return LoopCandidates(
        scores=torch.where(eligible, scores, 0),
        normalized=torch.where(eligible, normalized, 0.0),
        best=torch.where(found, best[0], -1),
        best_frame=torch.where(found, db.frames.gather(0, best)[0], -1),
        best_score=torch.where(found, best_score, 0.0),
    )

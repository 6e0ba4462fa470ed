"""Checkpoint/resume of the SLAM engine's state (port of
maveric_slam_tpu/utils/checkpoint.py, in the same format).

The whole engine state (tracker state, pose chain, track table, loop-closure
database, covisibility pool, keyframe store, retained loop edges) goes into
a checkpoint directory, so a crashed or preempted run resumes mid-sequence
with the same downstream results. Format, as the JAX package writes it: one
`state_NNNNNNNN.npz` of arrays (NNNNNNNN: the frame index) and one
`meta.json` of scalars, with the same array keys and meta fields, so either
package reads the other's checkpoints.

Randomness. The JAX package saves its PRNG keys (`rng_key`,
`tracker_key`); the port reads them and ignores them. The port saves its
own generators' states under keys of its own (`tracker_generator`,
`verify_generator`: `torch.Generator.get_state()` bytes) and the count of
loop verifications in `meta` (`verifications`), and restores each into a
generator on the engine's device. A checkpoint without them (the JAX
package's) leaves the fresh engine's generators as they were seeded.

Crash consistency: the array file is written under a per-frame name first
and meta.json, which names it, is committed last through an atomic
os.replace. A SIGKILL at any instant leaves either the previous complete
checkpoint or the new one, never a torn one.

In-flight work. At fetch_delay > 0 the engine holds frames, a BA solve and
loop decisions that it has not applied yet; `save` raises ValueError then
rather than write a checkpoint that drops them (the JAX package's `save`
drops them). At fetch_delay 0 nothing is pending between `process` calls.

A mesh-mode engine (`SlamSystem(mesh=...)`, one process a rank). Only the
LCD database's frame rows and the pool's word rows are sharded; everything
else (tracker state and generators, poses, tracks, the keyframe store,
loop edges, stats and the ring cursor) is the same on every rank. So
`engine_state` and `save` are collective: every rank calls them, the
blocks are all-gathered in rank order, and the state is the whole arrays,
with the keys, dtypes and shapes of a single engine's (the JAX package
saves whole arrays from its mesh too). Rank 0 writes the files and a
barrier follows, so that no rank runs past a checkpoint that is not on
disk yet. `restore` runs on every rank: each reads the files (a path every
rank can read), keeps its own rows and checks once that the ranks restored
the same replicated state (`replica_digest`). A checkpoint of either
package, from one engine or a mesh of any size, restores into a single
engine or into a mesh whose size divides the ring and the vocabulary.
"""

from __future__ import annotations

import json
import os
from typing import TYPE_CHECKING, Dict, Tuple

import numpy as np
import torch

from ..loopclosure import sharded_lcd
from ..mapping import sharded_pool
from ..parallel import mesh as mesh_lib

if TYPE_CHECKING:  # pragma: no cover
    from ..slam import SlamSystem

_TRACKER_FIELDS = ("desc", "probs", "indices", "xy", "depth", "depth_valid", "scale", "prev_R",
                   "prev_t")
_DB_FIELDS = ("multihot", "counts", "frames", "valid")
_POOL_FIELDS = ("first_seen", "last_seen", "num_sightings", "coords")


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _replicated_state(slam: "SlamSystem") -> Tuple[Dict[str, np.ndarray], dict]:
    """(arrays, meta) of everything but the database's and the pool's rows:
    the same on every rank of a mesh."""
    arrays = {}

    if slam.state is not None:
        for name in _TRACKER_FIELDS:
            arrays[f"tracker_{name}"] = _np(getattr(slam.state, name))
        arrays["tracker_generator"] = _np(slam.state.generator.get_state())
    arrays["verify_generator"] = _np(slam._verify_gen.get_state())

    arrays["poses"] = np.stack(slam.poses) if slam.poses else np.zeros((0, 4, 4))
    if slam.rel_poses:
        arrays["rel_R"] = np.stack([p[0] for p in slam.rel_poses])
        arrays["rel_t"] = np.stack([p[1] for p in slam.rel_poses])

    # Track table.
    tt = slam.tracks
    arrays["tracks_cell_to_track"] = tt.cell_to_track
    tids, frames_flat, xy_flat, lens, scores = [], [], [], [], []
    for tid, obs in tt.observations.items():
        tids.append(tid)
        lens.append(len(obs))
        scores.append(tt.scores.get(tid, 0.0))
        for o in obs:
            frames_flat.append(o.frame)
            xy_flat.append(o.xy)
    arrays["tracks_ids"] = np.array(tids, np.int64)
    arrays["tracks_lens"] = np.array(lens, np.int64)
    arrays["tracks_scores"] = np.array(scores, np.float64)
    arrays["tracks_frames"] = np.array(frames_flat, np.int64)
    arrays["tracks_xy"] = np.array(xy_flat, np.float64) if xy_flat else np.zeros((0, 2))
    arrays["tracks_words"] = np.array([tt.words.get(t, -1) for t in tids], np.int64)

    if slam.enable_loop_closure:
        arrays["db_next_slot"] = np.array(slam.db.next_slot, np.int32)
        arrays["pool_window"] = np.array(slam.pool.window, np.int32)
        slots = [k for k, e in enumerate(slam.kf_store) if e is not None]
        if slots:
            arrays["kf_slot"] = np.array(slots, np.int64)
            arrays["kf_frame"] = np.array([slam.kf_store[k]["frame"] for k in slots], np.int64)
            for name in ("desc", "xy", "mask", "depth", "depth_ok"):
                arrays[f"kf_{name}"] = np.stack([slam.kf_store[k][name] for k in slots])
        # Retained loop edges: every pose-graph solve re-applies all of them
        # (slam.MAX_LOOP_EDGES), so dropping them across a restart would
        # revert their corrections.
        if slam.loop_edges:
            arrays["loop_edge_ij"] = np.array([(fi, fj) for fi, fj, _, _ in slam.loop_edges],
                                              np.int64)
            arrays["loop_edge_R"] = np.stack([np.asarray(R) for _, _, R, _ in slam.loop_edges])
            arrays["loop_edge_t"] = np.stack([np.asarray(t) for _, _, _, t in slam.loop_edges])

    meta = {
        "frame_idx": slam.frame_idx,
        "next_track_id": tt.next_id,
        "stats": slam.stats,
        "loop_events": [
            {"frame": e.frame, "matched_frame": e.matched_frame, "score": e.score,
             "num_inliers": e.num_inliers}
            for e in slam.loop_events
        ],
        "enable_loop_closure": slam.enable_loop_closure,
        "kf_frames": slam.kf_frames,
        "last_kf": slam._last_kf,
        "verifications": slam.verifications,
    }
    return arrays, meta


def _whole(t: torch.Tensor, slam: "SlamSystem") -> np.ndarray:
    """A sharded field's whole rows: this engine's tensor, or in mesh mode
    every rank's block gathered in rank order (collective; int8 and bool
    travel as bytes, never through floats)."""
    if slam.mesh is None:
        return _np(t)
    return _np(mesh_lib.all_gather(t, slam.mesh).reshape(-1, *t.shape[1:]))


def engine_state(slam: "SlamSystem") -> Tuple[Dict[str, np.ndarray], dict]:
    """(arrays, meta): everything a checkpoint of the engine holds, as
    `save` writes it (meta without the state file's name). Two engines in
    the same state give equal arrays, dtypes included, and equal metas. In
    mesh mode every rank must call it (it gathers the sharded rows) and
    each gets the whole state."""
    arrays, meta = _replicated_state(slam)
    if slam.enable_loop_closure:
        for name in _DB_FIELDS:
            arrays[f"db_{name}"] = _whole(getattr(slam.db, name), slam)
        for name in _POOL_FIELDS:
            arrays[f"pool_{name}"] = _whole(getattr(slam.pool, name), slam)
    return arrays, meta


def replica_digest(slam: "SlamSystem") -> np.ndarray:
    """`parallel.mesh.digest` of each replicated array (in key order) and of
    the meta: equal on every rank of a mesh whose replicas agree."""
    arrays, meta = _replicated_state(slam)
    meta_bytes = np.frombuffer(json.dumps(meta, sort_keys=True).encode(), np.uint8)
    return np.concatenate([mesh_lib.digest(arrays[k]) for k in sorted(arrays)]
                          + [mesh_lib.digest(meta_bytes)])


def save(slam: "SlamSystem", path: str) -> None:
    """Write the engine's state to the checkpoint directory `path`. In mesh
    mode every rank calls it; rank 0 writes, and every rank returns once
    the checkpoint is committed."""
    if slam._pending or slam._pending_ba is not None or slam._pending_loops:
        raise ValueError(
            "the engine holds work in flight (fetch_delay > 0): a checkpoint now would drop "
            "it; save between calls at fetch_delay 0, or after finish()")
    arrays, meta = engine_state(slam)
    if slam.mesh is None or slam.mesh.rank == 0:
        _write(path, slam.frame_idx, arrays, meta)
    if slam.mesh is not None:
        mesh_lib.barrier(slam.mesh)


def _write(path: str, frame_idx: int, arrays: Dict[str, np.ndarray], meta: dict) -> None:
    os.makedirs(path, exist_ok=True)
    state_file = f"state_{frame_idx:08d}.npz"
    np.savez_compressed(os.path.join(path, state_file), **arrays)
    meta = {"state_file": state_file, **meta}
    # Commit point: meta.json names the (already fully written) state file.
    tmp = os.path.join(path, ".meta.json.tmp")
    with open(tmp, "w") as f:
        json.dump(meta, f)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, os.path.join(path, "meta.json"))
    # Remove superseded state files (a crash here just leaves an orphan).
    for name in os.listdir(path):
        if name.startswith("state_") and name != state_file:
            os.remove(os.path.join(path, name))


def _generator(state: np.ndarray, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.set_state(torch.from_numpy(np.array(state)))
    return gen


def restore(slam: "SlamSystem", path: str) -> None:
    """Load a checkpoint (written by either package, from one engine or a
    mesh) into a fresh SlamSystem, on the engine's device. In mesh mode
    every rank calls it and keeps its own rows of the database and the
    pool; it raises ValueError when the checkpoint's ring or vocabulary does
    not divide over the mesh, and RuntimeError when the ranks restored
    different replicated states."""
    from ..frontend.tracker import TrackerState
    from ..loopclosure.lcd import LoopDatabase
    from ..mapping.feature_pool import DevicePool
    from ..slam import LoopClosureEvent
    from ..tracks import Observation

    dev, mesh = slam.device, slam.mesh
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    with np.load(os.path.join(path, meta.get("state_file", "state.npz"))) as z:
        arrays = dict(z)
    sharded = meta["enable_loop_closure"] and "db_multihot" in arrays
    if mesh is not None and sharded:
        for key, what in (("db_multihot", "LCD ring frames"), ("pool_first_seen", "vocabulary words")):
            if key in arrays and arrays[key].shape[0] % mesh.size:
                raise ValueError(f"the checkpoint's {arrays[key].shape[0]} {what} do not divide "
                                 f"over a mesh of {mesh.size} ranks")

    def tensor(name, device=dev):
        return torch.from_numpy(np.array(arrays[name])).to(device)  # np.array keeps 0-d arrays 0-d

    slam.frame_idx = meta["frame_idx"]
    slam.stats = meta["stats"]
    slam.loop_events = [LoopClosureEvent(**e) for e in meta["loop_events"]]
    slam.kf_frames = [int(f) for f in meta.get("kf_frames", [0])]
    slam._last_kf = int(meta.get("last_kf", 0))
    slam.verifications = int(meta.get("verifications", 0))
    slam.counters = dict.fromkeys(slam.counters, 0)  # the counters count from here
    if "verify_generator" in arrays:
        slam._verify_gen = _generator(arrays["verify_generator"], dev)

    if "tracker_desc" in arrays:
        gen = (_generator(arrays["tracker_generator"], dev) if "tracker_generator" in arrays
               else torch.Generator(device=dev).manual_seed(slam.seed))
        slam.state = TrackerState(**{n: tensor(f"tracker_{n}") for n in _TRACKER_FIELDS},
                                  generator=gen)
    slam.poses = [p for p in arrays["poses"]]
    slam.rel_poses = ([(r, t) for r, t in zip(arrays["rel_R"], arrays["rel_t"])]
                      if "rel_R" in arrays else [])

    tt = slam.tracks
    tt.cell_to_track = arrays["tracks_cell_to_track"]
    tt.next_id = meta["next_track_id"]
    tt.observations, tt.scores, tt.words = {}, {}, {}
    pos = 0
    words = arrays.get("tracks_words")
    for row, (tid, n, sc) in enumerate(zip(arrays["tracks_ids"], arrays["tracks_lens"],
                                           arrays["tracks_scores"])):
        tt.observations[int(tid)] = [
            Observation(int(arrays["tracks_frames"][pos + k]), tuple(arrays["tracks_xy"][pos + k]))
            for k in range(n)
        ]
        pos += n
        tt.scores[int(tid)] = float(sc)
        if words is not None and words[row] >= 0:
            tt.words[int(tid)] = int(words[row])

    if sharded:
        # A mesh builds the whole rows on the host and keeps its own block.
        whole = dev if mesh is None else "cpu"
        slam.db = LoopDatabase(**{n: tensor(f"db_{n}", whole) for n in _DB_FIELDS},
                               next_slot=int(np.asarray(arrays["db_next_slot"]).reshape(-1)[0]))
        if mesh is not None:
            slam.db = sharded_lcd.shard_database(slam.db, mesh)
        if "pool_first_seen" in arrays:
            slam.pool = DevicePool(**{n: tensor(f"pool_{n}", whole) for n in _POOL_FIELDS},
                                   window=int(np.asarray(arrays["pool_window"]).reshape(-1)[0]))
            if mesh is not None:
                slam.pool = sharded_pool.shard_pool(slam.pool, mesh)
        if "kf_slot" in arrays:
            has_depth = "kf_depth" in arrays
            n_top = arrays["kf_desc"].shape[1]
            for row, slot in enumerate(arrays["kf_slot"]):
                slam.kf_store[int(slot)] = {
                    "frame": int(arrays["kf_frame"][row]),
                    "desc": arrays["kf_desc"][row],
                    "xy": arrays["kf_xy"][row],
                    "mask": arrays["kf_mask"][row],
                    # A checkpoint from before depths were stored: depth_ok
                    # False everywhere, so the loop edge's scale takes its
                    # fallback instead of failing on a missing key.
                    "depth": arrays["kf_depth"][row] if has_depth else np.zeros((n_top,), np.float32),
                    "depth_ok": arrays["kf_depth_ok"][row] if has_depth else np.zeros((n_top,), bool),
                }
        if "loop_edge_ij" in arrays:
            slam.loop_edges = [
                (int(ij[0]), int(ij[1]), arrays["loop_edge_R"][k], arrays["loop_edge_t"][k])
                for k, ij in enumerate(arrays["loop_edge_ij"])
            ]
    if mesh is not None:
        mesh_lib.check_replicas(replica_digest(slam), mesh, f"the restore of {path}")

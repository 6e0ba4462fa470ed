"""What each rank of the port's mesh runs in the mesh tests.

Imported by the ranks that `maveric_slam_tpu_torch.parallel.mesh.spawn`
starts (and by the tests that start them), so it imports neither JAX nor
the JAX package: every input arrives as numpy arrays from the test process,
which runs the JAX reference itself, and every result goes back as numpy.
Each function returns this rank's view; the tests compare the ranks too.
"""

from __future__ import annotations

import copy
import hashlib
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from maveric_slam_tpu_torch.backend import ba
from maveric_slam_tpu_torch.loopclosure import lcd, sharded_lcd
from maveric_slam_tpu_torch.mapping import feature_pool, sharded_pool
from maveric_slam_tpu_torch.parallel import mesh as mesh_lib
from maveric_slam_tpu_torch.parallel import sharded_ba, sharded_tracker


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def solve_ba(problem, iterations: int, mesh) -> dict:
    """sharded_bundle_adjust of a whole numpy problem (K, R, t, X, uv, mask)
    on `mesh`; R, t, the gathered X and the per-iteration costs."""
    solved, costs = sharded_ba.sharded_bundle_adjust(
        sharded_ba.shard_problem(ba.BAProblem(*problem), mesh), mesh, iterations=iterations)
    return {"R": _np(solved.R), "t": _np(solved.t),
            "X": _np(sharded_ba.gather_landmarks(solved.X, mesh)), "cost": _np(costs)}


def single_ba(problem, iterations: int, mesh) -> dict:
    """The single-device bundle_adjust of the same problem on this rank's
    device."""
    solved, stats = ba.bundle_adjust(
        ba.BAProblem(*(torch.as_tensor(a).to(mesh.device) for a in problem)), iterations=iterations)
    return {"R": _np(solved.R), "t": _np(solved.t), "X": _np(solved.X),
            "cost": _np(stats.cost[:-1])}


def lcd_ring(frame_sets, cap: int, vocab: int, mesh) -> dict:
    """A database built only through sharded_add_frame (the ring wraps)."""
    db = sharded_lcd.create_database(cap, vocab, mesh)
    for f, ids in enumerate(frame_sets):
        db = sharded_lcd.sharded_add_frame(db, torch.from_numpy(ids).to(mesh.device), f, mesh)
    out = {name: _np(mesh_lib.all_gather(getattr(db, name), mesh).reshape(cap, *getattr(
        db, name).shape[1:])) for name in ("multihot", "counts", "frames", "valid")}
    return {**out, "next_slot": db.next_slot}


def lcd_queries(frame_sets, cap: int, vocab: int, probes, current: int, gap: int,
                min_score: float, mesh) -> list:
    """sharded_query of each probe's word set against the whole database
    built by lcd.add_frame and then sharded: [(best, best_frame, best_score)]."""
    db = lcd.create_database(cap, vocab, device=mesh.device)
    for f, ids in enumerate(frame_sets):
        db = lcd.add_frame(db, torch.from_numpy(ids).to(mesh.device), f)
    sdb = sharded_lcd.shard_database(db, mesh)
    out = []
    for ids in probes:
        r = sharded_lcd.sharded_query(sdb, torch.from_numpy(ids).to(mesh.device), mesh, current,
                                      min_frame_gap=gap, min_score=min_score)
        out.append((int(r.best), int(r.best_frame), float(r.best_score)))
    return out


def pool_run(frames, queries, vocab: int, window: int, mesh) -> dict:
    """The word-sharded pool over a run of frames: the covisibility weights
    of a query after each frame, and the whole tables at the end."""
    pool = sharded_pool.shard_pool(feature_pool.create(vocab, window=window), mesh)
    weights = []
    for f, (ids, q) in enumerate(zip(frames, queries)):
        pool = sharded_pool.observe_batch(pool, torch.from_numpy(ids).to(mesh.device), f, mesh)
        pool = sharded_pool.remove_old(pool, f, mesh)
        weights.append(_np(sharded_pool.covisibility_weights(pool, torch.from_numpy(q).to(mesh.device),
                                                             mesh)))
    tables = {name: _np(mesh_lib.all_gather(getattr(pool, name), mesh).reshape(-1))
              for name in ("first_seen", "last_seen", "num_sightings")}
    last = len(frames) - 1
    whole = feature_pool.DevicePool(*(torch.from_numpy(tables[n]) for n in
                                      ("first_seen", "last_seen", "num_sightings")),
                                    coords=torch.zeros(vocab, 3), window=window)
    return {"weights": weights, **tables,
            "invariant": int(feature_pool.check_invariant(whole, last))}


def tracker_step(config, images0, images1, gumbel_min, gumbel_lo, mesh) -> dict:
    """One step of S streams on the stream mesh over `mesh`'s ranks
    (`make_stream_mesh`, `track_step_sharded`: S / n streams a rank) from
    batched states of the first frames, the whole batch's noise injected;
    the gathered results and the stream mesh's axes."""
    from maveric_slam_tpu_torch.frontend import tracker as trk
    from maveric_slam_tpu_torch.models import superpoint as sp

    smesh = sharded_tracker.make_stream_mesh(mesh.size, device=mesh.device)
    params = sharded_tracker.replicate_params(sp.load_params(device="cpu"), smesh)
    states = trk.init_states_batched(params, torch.from_numpy(images0).to(smesh.device), config)
    states, images = sharded_tracker.shard_streams(states, torch.from_numpy(images1), smesh)
    _, step = sharded_tracker.track_step_sharded(params, states, images, config,
                                                 torch.from_numpy(gumbel_min),
                                                 torch.from_numpy(gumbel_lo))
    full = sharded_tracker.gather_steps(step, smesh)
    return {"axes": list(smesh.axis_names),
            **{f: _np(getattr(full, f)) for f in ("R", "t", "valid", "num_matches", "num_inliers")}}


def components(spec: dict, device="cpu") -> dict:
    """Every case of `spec` ({name: (function name, mesh shape, axis names,
    kwargs)}) on this rank, with a mesh of that shape on `device`."""
    out = {"axis_index": {}}
    for name, (fn, shape, axes, kw) in spec.items():
        mesh = mesh_lib.make_mesh(shape, axes, device=device)
        out[name] = globals()[fn](**kw, mesh=mesh)
        out["axis_index"][name] = [mesh_lib.axis_index(mesh, a) for a in mesh.axis_names]
    out["rank"], out["backend"] = dist.get_rank(), dist.get_backend()
    out["jax_modules"] = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "maveric_slam_tpu"))
    return out


def fingerprint(arrays: dict) -> dict:
    """{key: (dtype, shape, sha256 of the bytes)}: equal for bitwise-equal
    arrays, and small enough to send back from every rank."""
    return {k: (str(a.dtype), a.shape, hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest())
            for k, a in arrays.items()}


def engine(config, frames, step_noise=None, verify_noise=None, fetch_delay: int = 0, mesh=None,
           device="cpu", save_at=None, save_dir=None, restore_dir=None) -> dict:
    """The port's SlamSystem (loop closure on, BA every 4) over the frames
    with the tracking noise injected (from its generators when None) and
    the verifications' noise (unless None): on `mesh` (a rank of the
    mesh-mode engine), or alone on `device`. With `restore_dir` it first
    restores that checkpoint and takes the frames after it; with `save_at`
    it saves into `save_dir` after that frame. What the tests compare: the
    trajectories, the odometry steps, every unpacked step, the solved BA
    windows, the keyframes and loop events, the fingerprint of
    `checkpoint.engine_state` and its meta, and `checkpoint.replica_digest`
    (of the state right after the restore too)."""
    from maveric_slam_tpu_torch import slam as tslam
    from maveric_slam_tpu_torch.models import superpoint as sp
    from maveric_slam_tpu_torch.utils import checkpoint

    dev = device if mesh is None else mesh.device
    slam = tslam.SlamSystem(sp.load_params(device=dev), config, ba_every=4,
                            enable_loop_closure=True, fetch_delay=fetch_delay, device=dev,
                            mesh=mesh,
                            verify_noise=None if verify_noise is None else verify_noise.__getitem__)
    views, windows, out = [], [], {}
    unpack, dispatch = slam._packer.unpack, slam._dispatch_window_ba

    def keep(flat):
        v = unpack(flat)
        views.append({k: np.copy(getattr(v, k)) for k in (
            "cells_new", "word_ids", "sightings", "num_matches", "num_inliers", "valid")})
        return v

    def solve(fidx):
        dispatch(fidx)
        if slam._pending_ba is not None:
            windows.append(fidx)

    slam._packer.unpack, slam._dispatch_window_ba = keep, solve
    if restore_dir is not None:
        checkpoint.restore(slam, restore_dir)
        restored, meta = checkpoint.engine_state(slam)
        out.update(restored=fingerprint(restored), restored_meta=copy.deepcopy(meta),
                   restored_digest=checkpoint.replica_digest(slam))
    for k in range(slam.frame_idx + 1, len(frames)):
        noise = () if k == 0 or step_noise is None else step_noise[k - 1]
        slam.process(frames[k], *noise)
        if k == save_at:
            checkpoint.save(slam, save_dir)
    slam.close()
    state, meta = checkpoint.engine_state(slam)
    out.update(poses=np.stack(slam.poses), rel=[(R, t) for R, t in slam.rel_poses],
               stats=slam.stats, views=views, windows=windows, kf_frames=slam.kf_frames,
               loops=[(e.frame, e.matched_frame, e.num_inliers, e.score) for e in slam.loop_events],
               next_slot=slam.db.next_slot, trajectory=slam.trajectory(),
               odometry=slam.odometry_trajectory(), state=fingerprint(state), meta=meta,
               digest=checkpoint.replica_digest(slam))
    return out


def mesh_engine(config, frames, step_noise=None, verify_noise=None, device="cpu", **kw) -> dict:
    """`engine` as one rank of the 1-D mesh over every rank."""
    return engine(config, frames, step_noise, verify_noise,
                  mesh=mesh_lib.make_mesh(device=device), **kw)


def build_with_stub(build_dir: str, nvcc: str) -> str:
    """`_build.build()` into `build_dir` with `nvcc` as the compiler, once
    every rank is ready (so that the ranks' builds start together)."""
    from pathlib import Path

    from maveric_slam_tpu_torch.ops.kernels import _build

    _build.BUILD_DIR = Path(build_dir)
    _build._nvcc = lambda: nvcc
    dist.barrier()
    return str(_build.build())


def fail_on_rank(bad: int) -> int:
    """Rank `bad` raises while every other rank waits in a collective."""
    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} fails on purpose")
    dist.barrier()
    return dist.get_rank()


def diverge() -> None:
    """Each rank holds other bytes: check_replicas must raise on every rank."""
    mesh = mesh_lib.make_mesh(device="cpu")
    mesh_lib.check_replicas(np.arange(8) + mesh.rank, mesh, "a test buffer")


def engine_on_uneven_mesh(config) -> str:
    """SlamSystem on a mesh whose size divides neither the LCD ring nor the
    vocabulary: the ValueError's message (empty if it did not raise)."""
    from maveric_slam_tpu_torch import slam as tslam
    from maveric_slam_tpu_torch.models import superpoint as sp

    try:
        tslam.SlamSystem(sp.load_params(device="cpu"), config,
                         mesh=mesh_lib.make_mesh(device="cpu"))
    except ValueError as e:
        return str(e)
    return ""


def mesh_engine_with(kw: dict) -> dict:
    """`mesh_engine(**kw)`, for `spawn`, which passes positional arguments."""
    return mesh_engine(**kw)


class Fault:
    """A `MeshElasticRunner` fault hook: each fault (kind, attempt, rank,
    frame) fires on that rank before that frame's step in that attempt
    (in every attempt when `attempt` is None). Kinds: "crash" raises,
    "hang" sleeps past any deadline, "corrupt" scales the last pose's
    rotation, which the step then carries into the new pose."""

    def __init__(self, *faults):
        self.faults = faults

    def __call__(self, attempt, rank, frame, system):
        for kind, a, r, f in self.faults:
            if (a is None or a == attempt) and (r, f) == (rank, frame):
                if kind == "crash":
                    raise RuntimeError("injected device fault")
                if kind == "hang":
                    time.sleep(3600.0)
                if kind == "corrupt":
                    system.poses[-1][:3, :3] *= 3.0


def sleep_forever(pid_dir: str) -> None:
    """Write this rank's pid into `pid_dir` and sleep: a rank whose
    launcher may die under it."""
    import os

    with open(os.path.join(pid_dir, f"{dist.get_rank()}.pid"), "w") as f:
        f.write(str(os.getpid()))
    time.sleep(3600.0)

"""Failure detection and elastic recovery for long tracking runs (port of
maveric_slam_tpu/utils/elastic.py).

The reference's failure story is `printf` + `exit(1)` (src/top_N.c:91-94,
local_feature_pool.h:177-180) and its only persistence is a .npy per frame
pair (python/pairwise_pnp.py:694). Here a sick step is *detected* (an
exception out of the runtime, a wall-clock hang of the device or driver,
or a numerically poisoned state) and *recovered* from: the newest
crash-consistent checkpoint (utils/checkpoint.py) is restored into a fresh
engine and the frames since are replayed. The engine's random state is in
the checkpoint, so the replay reproduces the unbroken trajectory bitwise
on a device whose sums run in a fixed order (tests/test_torch_elastic.py
on the CPU, chip_smoke.py `[elastic]` on a card).

Three pieces:

- ``FailureDetector``: classifies one step: ``StepTimeout`` (deadline
  exceeded; the step runs in a worker thread so a wedged device call
  cannot freeze the driver), ``StepCrash`` (an exception escaped the step),
  ``StateCorruption`` (a non-finite pose or a non-rigid rotation after an
  otherwise successful step).
- ``ElasticRunner``: drives a SlamSystem over a frame stream with periodic
  checkpoints, and on a detected failure rebuilds the engine, restores the
  newest checkpoint and replays the gap, within ``max_restarts`` (repeated
  failure on the same frame is a real bug, not bad luck).
- ``MeshElasticRunner``: the same for the mesh-mode engine. The JAX
  package drives its mesh from one controller, so its ElasticRunner takes
  `mesh=` unchanged; here each rank is a process, and a rank that crashes
  or hangs leaves its peers blocked in a collective. So recovery restarts
  the whole group: each attempt is one `parallel.mesh.spawn`, every rank
  runs the frames under a FailureDetector and checkpoints collectively,
  and when any rank fails the group is killed and a fresh one restores the
  newest committed checkpoint and replays from there. Every attempt runs
  with the same thread count, so that a replay on the CPU is bitwise.

A CUDA engine builds or loads its kernels when it is constructed
(`SlamSystem.__init__`), outside every timed step: a first-use build does
not count against a step's deadline, and a build that fails raises from the
constructor instead of being retried as a crash.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import os
import shutil
import tempfile
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from .. import slam as slam_mod
from ..parallel import mesh as mesh_lib
from . import checkpoint


class StepFailure(RuntimeError):
    """Base class for detected step failures."""


class StepTimeout(StepFailure):
    pass


class StepCrash(StepFailure):
    pass


class StateCorruption(StepFailure):
    pass


class FailureDetector:
    """Runs one engine step under a deadline and validates the result.

    The step executes on a daemon worker thread: if the device or its driver
    wedges, the driver thread gets control back at the deadline and can fail
    over instead of hanging. The abandoned thread is left to finish or die
    with the process (a stuck native call cannot be interrupted safely),
    which is why recovery rebuilds the engine rather than reusing it.
    """

    def __init__(self, step_timeout_s: float = 60.0):
        self.step_timeout_s = step_timeout_s

    def run_step(self, system: "slam_mod.SlamSystem", image: np.ndarray,
                 frame: Optional[int] = None, before: Optional[Callable[[], None]] = None) -> None:
        """`system.process(image)` under the deadline, after `before()` (on
        the same worker thread, inside the deadline) when given."""
        result: dict = {}

        def work():
            try:
                if before is not None:
                    before()
                system.process(image)
                result["ok"] = True
            except BaseException as e:  # noqa: BLE001 (classified below)
                result["error"] = e

        t = threading.Thread(target=work, daemon=True)
        t.start()
        t.join(self.step_timeout_s)
        if t.is_alive():
            # system.frame_idx is unreliable mid-hang (process() bumps it
            # before the device work), so the caller passes the stream index
            # of the frame being attempted.
            which = frame if frame is not None else system.frame_idx
            raise StepTimeout(f"step exceeded {self.step_timeout_s}s at frame {which}")
        if "error" in result:
            raise StepCrash(repr(result["error"])) from result["error"]
        self.validate(system)

    @staticmethod
    def validate(system: "slam_mod.SlamSystem") -> None:
        """Post-step state checks (cheap host-side invariants)."""
        if not system.poses:
            return
        T = system.poses[-1]
        if not np.isfinite(T).all():
            raise StateCorruption(f"non-finite pose at frame {system.frame_idx}")
        # The rotation block must stay orthonormal (drift here poisons every
        # later composition silently).
        det = float(np.linalg.det(T[:3, :3]))
        if abs(det - 1.0) > 1e-2:
            raise StateCorruption(f"non-rigid rotation (det={det:.4f}) at frame {system.frame_idx}")


class ElasticRunner:
    """Checkpointed, self-healing driver loop around SlamSystem;
    `system_kwargs` go to every engine it builds (`device` among them)."""

    def __init__(
        self,
        params,
        config,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 8,
        max_restarts: int = 3,
        step_timeout_s: float = 120.0,
        fault_hook: Optional[Callable[[int, np.ndarray], np.ndarray]] = None,
        **system_kwargs,
    ):
        self.params = params
        self.config = config
        # Without a directory the runner owns a TemporaryDirectory, removed
        # by close() or its finalizer.
        self._tmpdir: Optional[tempfile.TemporaryDirectory] = None
        if checkpoint_dir is None:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="maveric_elastic_")
            checkpoint_dir = self._tmpdir.name
        self.checkpoint_dir = checkpoint_dir
        self.checkpoint_every = checkpoint_every
        self.max_restarts = max_restarts
        self.detector = FailureDetector(step_timeout_s)
        # Test/chaos hook: runs on the driver thread before each step; may
        # raise (an injected crash) or return a replacement image.
        self.fault_hook = fault_hook
        self.system_kwargs = system_kwargs
        self.restarts = 0
        self.failures: List[str] = []
        self.system = slam_mod.SlamSystem(params, config, **system_kwargs)
        self._ckpt_path = os.path.join(self.checkpoint_dir, "latest")
        self._last_ckpt_frame = -1

    def close(self) -> None:
        """Release the owned checkpoint directory (no-op if user-supplied)."""
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None

    def _checkpoint(self) -> None:
        checkpoint.save(self.system, self._ckpt_path)
        self._last_ckpt_frame = self.system.frame_idx

    def _recover(self) -> None:
        """A fresh engine with the newest checkpoint (or from scratch if none)."""
        self.system = slam_mod.SlamSystem(self.params, self.config, **self.system_kwargs)
        if self._last_ckpt_frame >= 0:
            checkpoint.restore(self.system, self._ckpt_path)

    def run(self, frames: Sequence[np.ndarray]) -> "slam_mod.SlamSystem":
        """Process every frame, recovering from detected failures.

        Returns the finished SlamSystem. Raises the final failure if the
        restart budget is exhausted.
        """
        i = 0
        while i < len(frames):
            # The engine may be behind `i` after a recovery: replay.
            target = self.system.frame_idx + 1
            if target < i:
                i = target
            img = frames[i]
            try:
                if self.fault_hook is not None:
                    try:
                        out = self.fault_hook(i, img)
                    except StepFailure:
                        raise
                    except Exception as e:  # noqa: BLE001 (an injected fault)
                        raise StepCrash(f"fault hook: {e!r}") from e
                    if out is not None:
                        img = out
                self.detector.run_step(self.system, img, frame=i)
            except StepFailure as e:
                self.failures.append(f"frame {i}: {e}")
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                self._recover()
                continue
            if (
                self.checkpoint_every
                and self.system.frame_idx >= 0
                and (self.system.frame_idx + 1) % self.checkpoint_every == 0
                and self.system.frame_idx > self._last_ckpt_frame
            ):
                self._checkpoint()
            i += 1
        return self.system


# ---------------------------------------------------------------------- #
# The mesh-mode engine: one process a rank, the group restarted whole
# ---------------------------------------------------------------------- #

_FAILURES = {c.__name__: c for c in (StepTimeout, StepCrash, StateCorruption)}


@dataclasses.dataclass
class MeshRun:
    """Rank 0's engine after a finished `MeshElasticRunner.run`."""

    trajectory: np.ndarray  # (N, 4, 4) T_w_c, loop corrections applied
    odometry: np.ndarray  # (N, 4, 4) the raw odometry chain
    stats: list
    loop_events: list  # (frame, matched_frame, num_inliers, score)
    kf_frames: list


@dataclasses.dataclass(frozen=True)
class _MeshJob:
    """What every rank of every attempt is given."""

    world_size: int
    config: object
    weights: Optional[str]
    ckpt_path: str
    events_path: str
    checkpoint_every: int
    step_timeout_s: float
    fault_hook: Optional[Callable]
    device: object
    system_kwargs: dict


def _mesh_rank(job: _MeshJob, frames: Sequence[np.ndarray], attempt: int, resume: bool):
    """One rank of one attempt: a fresh mesh engine (restored from the
    newest checkpoint when `resume`), the frames after its state under a
    FailureDetector, a collective checkpoint every `checkpoint_every`
    frames. Rank 0 appends its timeline to `job.events_path` and returns
    the MeshRun; a failing step raises its StepFailure, which `spawn`
    reports with the frame and the rank."""
    from ..models import superpoint as sp

    mesh = mesh_lib.make_mesh(job.world_size, device=job.device)

    def event(name, frame=None, s=None):
        if mesh.rank == 0:
            with open(job.events_path, "a") as f:
                f.write(json.dumps({"attempt": attempt, "event": name, "frame": frame, "s": s,
                                    "t": time.time()}) + "\n")

    event("enter")
    system = slam_mod.SlamSystem(sp.load_params(job.weights, device=mesh.device), job.config,
                                 mesh=mesh, **job.system_kwargs)
    event("built")
    if resume:
        checkpoint.restore(system, job.ckpt_path)
    event("restored", system.frame_idx)
    detector = FailureDetector(job.step_timeout_s)
    for i in range(system.frame_idx + 1, len(frames)):
        hook = (None if job.fault_hook is None
                else functools.partial(job.fault_hook, attempt, mesh.rank, i, system))
        event("begin", i)
        t0 = time.perf_counter()
        try:
            detector.run_step(system, frames[i], frame=i, before=hook)
        except StepFailure as e:
            raise type(e)(f"frame {i}: rank {mesh.rank}: {e}") from e
        event("step", i, time.perf_counter() - t0)
        if job.checkpoint_every and (i + 1) % job.checkpoint_every == 0:
            t0 = time.perf_counter()
            checkpoint.save(system, job.ckpt_path)
            event("saved", i, time.perf_counter() - t0)
    system.close()
    if mesh.rank:
        return None
    return MeshRun(trajectory=system.trajectory(), odometry=system.odometry_trajectory(),
                   stats=system.stats, kf_frames=system.kf_frames,
                   loop_events=[(e.frame, e.matched_frame, e.num_inliers, e.score)
                                for e in system.loop_events])


class MeshElasticRunner:
    """ElasticRunner's loop for `SlamSystem(mesh=...)` over `world_size`
    ranks started by `parallel.mesh.spawn` on `device` (as for
    `mesh.rank_device`; None: CUDA), `threads` torch threads a rank (None:
    the host's cores shared out). Each rank loads the SuperPoint weights
    from `weights` (None: the shipped file); `system_kwargs` go to every
    engine. `fault_hook(attempt, rank, frame, system)` runs on each rank's
    step thread before each step, inside the deadline: it may raise (a
    crash), sleep (a hang) or damage `system` (a corrupted state); it and
    the frames must pickle. `attempt_timeout_s` bounds one attempt's spawn.

    After `run`: `restarts`, `failures` (one line each, naming the frame and
    the rank) and `attempts`, a record per attempt from rank 0's timeline:
    `spawn_s` (spawn to rank 0's start), `build_s` (the engine), `restore_s`,
    `resumed_at` (the restored frame, -1 without one), `steps` ({frame:
    wall s}), `saves` ({frame: wall s}), `failed_at` (the frame rank 0 was
    in when the group failed, else None) and `failure`."""

    def __init__(
        self,
        world_size: int,
        config,
        weights: Optional[str] = None,
        checkpoint_dir: Optional[str] = None,
        checkpoint_every: int = 8,
        max_restarts: int = 3,
        step_timeout_s: float = 120.0,
        fault_hook: Optional[Callable] = None,
        device=None,
        threads: Optional[int] = None,
        attempt_timeout_s: Optional[float] = None,
        **system_kwargs,
    ):
        self._tmpdir: Optional[tempfile.TemporaryDirectory] = None
        if checkpoint_dir is None:
            self._tmpdir = tempfile.TemporaryDirectory(prefix="maveric_mesh_elastic_")
            checkpoint_dir = self._tmpdir.name
        self.checkpoint_dir = checkpoint_dir
        self.max_restarts = max_restarts
        self.threads = threads
        self.attempt_timeout_s = attempt_timeout_s
        self._job = _MeshJob(world_size, config, weights, os.path.join(checkpoint_dir, "latest"),
                             os.path.join(checkpoint_dir, "events.jsonl"), checkpoint_every,
                             step_timeout_s, fault_hook, device, system_kwargs)
        self.restarts = 0
        self.failures: List[str] = []
        self.attempts: List[dict] = []

    def close(self) -> None:
        """Release the owned checkpoint directory (no-op if user-supplied)."""
        if self._tmpdir is not None:
            self._tmpdir.cleanup()
            self._tmpdir = None

    def _record(self, attempt: int, t_spawn: float, failure: Optional[str]) -> None:
        ev = []
        if os.path.exists(self._job.events_path):
            with open(self._job.events_path) as f:
                ev = [e for e in map(json.loads, f) if e["attempt"] == attempt]
        at = {e["event"]: e for e in ev if e["event"] in ("enter", "built", "restored")}
        begun = [e["frame"] for e in ev if e["event"] == "begin"]
        done = {e["frame"]: e["s"] for e in ev if e["event"] == "step"}
        rec = {"attempt": attempt, "failure": failure, "steps": done,
               "saves": {e["frame"]: e["s"] for e in ev if e["event"] == "saved"},
               "failed_at": begun[-1] if failure is not None and begun else None}
        if "enter" in at:
            rec["spawn_s"] = at["enter"]["t"] - t_spawn
        if "built" in at:
            rec["build_s"] = at["built"]["t"] - at["enter"]["t"]
        if "restored" in at:
            rec["restore_s"] = at["restored"]["t"] - at["built"]["t"]
            rec["resumed_at"] = at["restored"]["frame"]
        self.attempts.append(rec)

    def run(self, frames: Sequence[np.ndarray]) -> MeshRun:
        """Process every frame on the mesh, restarting the group from the
        newest checkpoint after each detected failure. Returns rank 0's
        MeshRun; raises the final failure (its StepFailure class) once
        the restart budget is spent."""
        shutil.rmtree(self._job.ckpt_path, ignore_errors=True)  # this run's checkpoints only
        if os.path.exists(self._job.events_path):
            os.remove(self._job.events_path)
        attempt = 0
        while True:
            resume = os.path.exists(os.path.join(self._job.ckpt_path, "meta.json"))
            t0 = time.time()
            try:
                results = mesh_lib.spawn(_mesh_rank, self._job.world_size,
                                         args=(self._job, list(frames), attempt, resume),
                                         device=self._job.device, threads=self.threads,
                                         timeout_s=self.attempt_timeout_s)
            except mesh_lib.RankFailure as e:
                self._record(attempt, t0, e.detail)
                if e.kind not in _FAILURES:
                    raise
                self.failures.append(e.detail)
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise _FAILURES[e.kind](e.detail) from e
                attempt += 1
                continue
            self._record(attempt, t0, None)
            return results[0]

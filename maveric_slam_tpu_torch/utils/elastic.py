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

Two pieces:

- ``FailureDetector``: classifies one step: ``StepTimeout`` (deadline
  exceeded; the step runs in a worker thread so a wedged device call
  cannot freeze the driver), ``StepCrash`` (an exception escaped the step),
  ``StateCorruption`` (a non-finite pose or a non-rigid rotation after an
  otherwise successful step).
- ``ElasticRunner``: drives a SlamSystem over a frame stream with periodic
  checkpoints, and on a detected failure rebuilds the engine, restores the
  newest checkpoint and replays the gap, within ``max_restarts`` (repeated
  failure on the same frame is a real bug, not bad luck).

A CUDA engine builds or loads its kernels when it is constructed
(`SlamSystem.__init__`), outside every timed step: a first-use build does
not count against a step's deadline, and a build that fails raises from the
constructor instead of being retried as a crash.
"""

from __future__ import annotations

import os
import tempfile
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np

from .. import slam as slam_mod
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
                 frame: Optional[int] = None) -> None:
        result: dict = {}

        def work():
            try:
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

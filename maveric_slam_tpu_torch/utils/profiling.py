"""Profiling hooks (port of maveric_slam_tpu/utils/profiling.py).

The reference marks regions with comments for external timing
(/*** MEASURE THIS ***/, e.g. src/local_bundle_adjustment.c:153) and logs
via printf. Here: wall-clock scopes with device synchronisation, running
statistics, and torch.profiler traces viewable in TensorBoard or
chrome://tracing.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import torch


def _sync() -> None:
    """Wait for the CUDA device, if this process has initialised it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class Timer:
    """Accumulating named timers with device-synchronised boundaries."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def scope(self, name: str, sync: bool = True) -> Iterator[None]:
        """Time the block under `name`; with `sync`, the CUDA device is
        synchronised on both sides, so the time covers its work."""
        if sync:
            _sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync:
                _sync()
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {
            name: {
                "total_s": self.totals[name],
                "count": self.counts[name],
                "mean_ms": 1000.0 * self.totals[name] / max(self.counts[name], 1),
            }
            for name in self.totals
        }

    def report(self) -> str:
        """One line a scope, the largest total first."""
        lines = []
        for name, s in sorted(self.summary().items(), key=lambda kv: -kv[1]["total_s"]):
            lines.append(
                f"{name:32s} {s['count']:6d}x  {s['mean_ms']:8.2f} ms/call"
                f"  {s['total_s']:8.2f} s total"
            )
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str) -> Iterator[torch.profiler.profile]:
    """Capture a torch.profiler trace of the block (the CPU, and the CUDA
    device when there is one) into `logdir` as a Chrome/TensorBoard trace
    file (`*.pt.trace.json`): the port's counterpart of the JAX package's
    `xla_trace`. Yields the profiler, whose `key_averages()` sums it."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
        activities=activities,
        on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir),
    ) as prof:
        yield prof
        _sync()


def block(tree):
    """Wait for the CUDA device's queued work (accurate timing boundaries);
    returns `tree` unchanged."""
    _sync()
    return tree

"""Profiling hooks (port of maveric_slam_tpu/utils/profiling.py).

The reference marks regions with comments for external timing
(/*** MEASURE THIS ***/, e.g. src/local_bundle_adjustment.c:153) and logs
via printf. Here: wall-clock scopes with device synchronisation, running
statistics, torch.profiler traces viewable in TensorBoard or
chrome://tracing, and the program's own spans (`span`).

Spans. The engine (slam.py), the tracker (frontend/tracker.py) and the
pose graph (backend/pose_graph.py) name their stages with `span(name)`.
A span measures the host: the time from entering the block to leaving it,
which is the dispatch of its device work plus whatever the host waits for.
A span that holds a host copy (`.cpu()`, `_HostCopy.result()`, or an
upload of a host tensor, which PyTorch synchronises) measures the host's
wait for the device's queued work there too. No span synchronises the
device itself.

- With no torch.profiler session active and no Timer recording, `span`
  returns one shared `contextlib.nullcontext()`: no allocation and no clock
  read.
- Under torch.profiler, a span is a `record_function` range, in the trace
  beside the aten operations and kernels and on their clock.
- Under `Timer.recording()`, a span adds its host seconds to that Timer's
  `totals` and `counts` under its name. A span inside another adds to both
  names: totals are inclusive.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

_NULL = contextlib.nullcontext()
_recording: Optional["Timer"] = None  # the Timer that spans add into


def _sync() -> None:
    """Wait for the CUDA device, if this process has initialised it."""
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Span:
    __slots__ = ("name", "timer", "range", "t0")

    def __init__(self, name: str, timer: Optional["Timer"], profiled: bool):
        self.name, self.timer = name, timer
        self.range = torch.profiler.record_function(name) if profiled else None

    def __enter__(self) -> None:
        if self.range is not None:
            self.range.__enter__()
        self.t0 = time.perf_counter()

    def __exit__(self, *exc) -> bool:
        if self.timer is not None:
            self.timer.totals[self.name] += time.perf_counter() - self.t0
            self.timer.counts[self.name] += 1
        if self.range is not None:
            self.range.__exit__(*exc)
        return False


def span(name: str):
    """A context manager that marks one stage of the program as `name`
    (see the module's docstring): a shared null context unless a
    torch.profiler session is active or a Timer is recording."""
    profiled = torch.autograd._profiler_enabled()
    if _recording is None and not profiled:
        return _NULL
    return _Span(name, _recording, profiled)


class Timer:
    """Accumulating named timers: `scope` blocks with device-synchronised
    boundaries, and the program's spans while `recording`."""

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

    @contextlib.contextmanager
    def recording(self) -> Iterator["Timer"]:
        """Within the block, every program span adds its host time to this
        Timer (no device synchronisation). Recordings nest: the Timer that
        was recording before takes over again on exit."""
        global _recording
        prev, _recording = _recording, self
        try:
            yield self
        finally:
            _recording = prev

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

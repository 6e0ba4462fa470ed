"""The program's own spans in a traced run: `record_function` ranges that
the port opens around its stages (maveric_slam_tpu_torch/utils/profiling.py),
found by name among the traced span's host events (`run.trace.cpu_events`).

A program without a span of that name gives no occurrences, so every reader
built on these returns None there rather than a number.
"""

from __future__ import annotations

from typing import List, Tuple


def occurrences(trace, name: str) -> List[Tuple[float, float]]:
    """(start_s, end_s) of each outermost occurrence of span `name`, clipped
    to the traced span [t0, t1]; an occurrence inside another of the same
    name is part of it."""
    found = sorted((max(s, trace.t0), min(e, trace.t1)) for n, s, e in trace.cpu_events
                   if n == name and e > trace.t0 and s < trace.t1)
    out: List[Tuple[float, float]] = []
    for s, e in found:
        if out and s < out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def seconds(trace, name: str) -> float:
    """The summed seconds of the span's outermost occurrences."""
    return sum(e - s for s, e in occurrences(trace, name))


def count(trace, name: str) -> int:
    """The number of the span's outermost occurrences."""
    return len(occurrences(trace, name))


def per(run, names, divisor: str, scale: float = 1e3):
    """`scale` x the summed seconds of the spans `names` over the count of
    span `divisor`; None when the run has no trace or `divisor` never
    occurs in it."""
    tr = run.trace
    if tr is None:
        return None
    n = count(tr, divisor)
    if n == 0:
        return None
    return scale * sum(seconds(tr, name) for name in names) / n


def per_frame(run, value) -> float | None:
    """`value(trace)` over the traced frames; None when the run has no
    trace, no frames, or no `slam.process` span (a program without spans)."""
    tr = run.trace
    if tr is None or tr.frames <= 0 or count(tr, "slam.process") == 0:
        return None
    return value(tr) / tr.frames

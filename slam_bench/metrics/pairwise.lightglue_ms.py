"""The host's ms a relocalisation call in the matcher (`pairwise.match`:
LightGlue's dispatch and whatever the host waits for there), over the
calls (`pairwise.batch`) of the traced span."""

from slam_bench import spans


def read(run):
    return spans.per(run, ("pairwise.match",), "pairwise.batch")

"""The host's wait for each frame's packed copy to reach it
(`slam.fetch_wait`, the span around `_HostCopy.result()` in
`SlamSystem._consume`), in ms a traced frame: at fetch_delay 0, the wait for
the device to finish the frame's step."""

from slam_bench import spans


def read(run):
    return spans.per_frame(run, lambda tr: 1e3 * spans.seconds(tr, "slam.fetch_wait"))

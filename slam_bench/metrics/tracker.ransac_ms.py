"""The host's ms a tracking step in LO-RANSAC (`tracker.ransac`: point
normalisation, the noise draws and `ransac_essential`), over the steps
(`tracker.step`) of the traced span."""

from slam_bench import spans


def read(run):
    return spans.per(run, ("tracker.ransac",), "tracker.step")

"""The host's ms a tracking step in the Gauss-Newton PnP refinement
(`tracker.refine_pose`: `pnp.refine_pose` and its fall-back to RANSAC's
pose), over the steps (`tracker.step`) of the traced span."""

from slam_bench import spans


def read(run):
    return spans.per(run, ("tracker.refine_pose",), "tracker.step")

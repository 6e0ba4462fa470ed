"""The host's ms a pose-graph solve (`slam.pose_graph`: the skeleton's graph
built and uploaded, 8 LM iterations on the device and their result's copy,
every pose moved with its node), over the solves in the traced span. None
where no loop edge passed the correction gate there."""

from slam_bench import spans


def read(run):
    return spans.per(run, ("slam.pose_graph",), "slam.pose_graph")

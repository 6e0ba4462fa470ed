"""Pose-graph solves a traced frame: the count of `slam.pose_graph` spans,
which is the rise of the engine's counter `pose_graph_solves` over the
traced span (each is raised where the other opens). How often a loop edge
passes the 0.5 m correction gate depends on the seed's image noise."""

from slam_bench import spans


def read(run):
    return spans.per_frame(run, lambda tr: spans.count(tr, "slam.pose_graph"))

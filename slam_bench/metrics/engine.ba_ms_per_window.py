"""The host's ms a window BA: its dispatch (`slam.ba.dispatch`: landmark
triangulation, the problem's upload, the solve's enqueue) and its apply
(`slam.ba.apply`: the wait for the solve's result, the poses written back
and the depths fed to the tracker), over the windows applied in the traced
span."""

from slam_bench import spans


def read(run):
    return spans.per(run, ("slam.ba.dispatch", "slam.ba.apply"), "slam.ba.apply")

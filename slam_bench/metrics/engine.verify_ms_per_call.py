"""The host's ms a loop verification (`slam.loop.verify`: the candidate
pair's upload, RANSAC on the device and the copy of its result, which waits
for it), over the verifications in the traced span."""

from slam_bench import spans


def read(run):
    return spans.per(run, ("slam.loop.verify",), "slam.loop.verify")

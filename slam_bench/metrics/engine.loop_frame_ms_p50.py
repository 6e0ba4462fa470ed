"""The median wall of the window's frames during which the engine's public
counter `SlamSystem.verifications` rose: loop verification, and the pose
graph where a closure is accepted."""

import statistics


def read(run):
    frames = run.records.get("frames")
    if frames is None:
        return None
    walls = [w for _, w, _, verified in frames if verified]
    return 1e3 * statistics.median(walls) if walls else None

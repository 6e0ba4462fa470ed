"""The median wall of the window's frames that neither dispatch a window
BA nor verify a loop: the tracking step and the engine's per-frame host
work. (In this traffic every BA frame is a keyframe that verifies a loop
candidate, so the BA has no frames of its own.)"""

import statistics


def read(run):
    frames = run.records.get("frames")
    if frames is None:
        return None
    walls = [w for _, w, is_ba, verified in frames if not is_ba and not verified]
    return 1e3 * statistics.median(walls) if walls else None

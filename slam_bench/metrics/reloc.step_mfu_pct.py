"""A relocalisation call's share of the card's peak: the least time of the
query's SuperPoint convolutions (stage 1 on the int8 tensor cores, the rest
as float32 products) and of LightGlue's operations on every candidate pair
at the float32 peak (`lightglue_count.pair_least_s`), over the traced
span's time a query."""

from slam_bench import lightglue_count, yardstick


def read(run):
    tr = run.trace
    if tr is None or tr.frames == 0 or "lightglue" not in run.config:
        return None
    cfg = run.config
    least = (yardstick.frame_least_s(cfg["rows"], cfg["cols"])
             + len(run.traffic["offsets"]) * lightglue_count.pair_least_s(cfg))
    return 100.0 * least * tr.frames / tr.window_s

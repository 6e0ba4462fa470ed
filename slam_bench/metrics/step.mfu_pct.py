"""The whole step's share of the card's peak: the least time of the
frames' SuperPoint convolutions (stage 1 on the int8 tensor cores, the
rest as float32 products, whatever implements them) over the traced span's
time a frame."""

from slam_bench import yardstick


def read(run):
    tr = run.trace
    if tr is None or tr.frames == 0:
        return None
    least = yardstick.frame_least_s(run.config["rows"], run.config["cols"])
    return 100.0 * least * tr.frames / tr.window_s

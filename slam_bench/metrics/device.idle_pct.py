"""The share of the traced span in which no operation ran on the device
(the union of the device records; the profiler's marker kernels left out)."""


def read(run):
    tr = run.trace
    if tr is None or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)

"""Stage 1's share of its roofline: the least time of the fused stem's
launches in the traced span (int8 operations at 1979 TOP/s against bytes
at 3.35 TB/s, the larger, from each launch's shape) over the device time
of the kernels named below. Nothing when the span launched none."""

from slam_bench import yardstick

NAMES = ("stem_kernel",)


def read(run):
    tr = run.trace
    if tr is None:
        return None
    device = yardstick.kernel_device_s(tr.device_events, NAMES)
    least = yardstick.kernel_least_total_s(tr.kernel_calls, ("fused_stem",)).get("fused_stem", 0.0)
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device

"""The five hand-written kernels' share of their rooflines together: the
sum of their launches' least times in the traced span (each from its
shape, every input byte read once and every output byte written once)
over the sum of their device times."""

from slam_bench import yardstick


def read(run):
    tr = run.trace
    if tr is None:
        return None
    names = [n for syms in yardstick.KERNEL_SYMBOLS.values() for n in syms]
    device = yardstick.kernel_device_s(tr.device_events, names)
    least = sum(yardstick.kernel_least_total_s(tr.kernel_calls, tuple(yardstick.KERNEL_SYMBOLS)).values())
    if device <= 0 or least <= 0:
        return None
    return 100.0 * least / device

"""LightGlue's attention against its roofline: the least time of the self
and cross blocks' attention products of every pair in the traced span (at
the float32 peak, against q, k, v and outputs at HBM bandwidth;
`lightglue_count.attention_least_s`) over the device time of the kernels
that compute them, found by name: scaled_dot_product_attention's fused
kernels and any later replacement whose name holds one of NAMES."""

from slam_bench import lightglue_count

NAMES = ("fmha", "attention", "flash")


def read(run):
    tr = run.trace
    if tr is None or tr.frames == 0 or "lightglue" not in run.config:
        return None
    device = sum(e - s for n, s, e in tr.device_events if any(k in n.lower() for k in NAMES))
    if device <= 0:
        return None
    pairs = tr.frames * len(run.traffic["offsets"])
    return 100.0 * pairs * lightglue_count.attention_least_s(run.config) / device

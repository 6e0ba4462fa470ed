"""Each per-layer reader on a hand-made trace and hand-made records."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from slam_bench import harness, yardstick

METRICS = Path(__file__).resolve().parents[1] / "metrics"
CFG = {"rows": 192, "cols": 640}


def reader(name):
    return harness.load_module(METRICS / f"{name}.py", f"test_metric_{name}")


def _trace():
    stem = ("fused_stem", (0,) * 9 + (16, 192, 640, 0))
    svd = ("svd3", (0, 0, 0, 0, 4096, 6, 0))
    events = [("(anonymous namespace)::stem_kernel(float const*, int)", 0.0, 0.4e-3),
              ("svd3_kernel(float const*)", 0.5e-3, 0.5e-3 + 5e-6),
              ("Memcpy DtoH (Device -> Pinned)", 0.6e-3, 0.7e-3),
              ("void at::native::im2col_kernel<float>", 0.65e-3, 1.0e-3)]
    return SimpleNamespace(device_events=events, cpu_events=[], window_s=2.0e-3, t0=0.0, t1=2.0e-3,
                           frames=16, busy_s=yardstick.interval_union_s([(s, e) for _, s, e in events]),
                           kernel_calls=[stem, svd])


def test_device_readers():
    run = SimpleNamespace(trace=_trace(), records={}, config=CFG)
    assert reader("device.idle_pct").read(run) == pytest.approx(100 * (1 - (0.4e-3 + 5e-6 + 0.4e-3) / 2e-3))
    assert reader("device.launches_per_frame").read(run) == pytest.approx(3 / 16)
    assert reader("step.mfu_pct").read(run) == pytest.approx(
        100 * yardstick.frame_least_s(192, 640) * 16 / 2e-3)
    stem_least = yardstick.kernel_least_s("fused_stem", _trace().kernel_calls[0][1])
    assert stem_least == pytest.approx(16 * 4.65e-6, rel=1e-2)  # the kernel table's bound, x 16
    assert reader("kernel.fused_stem.roofline_pct").read(run) == pytest.approx(100 * stem_least / 0.4e-3)
    svd_least = 4096 * (9 + 21) * 4 / yardstick.HBM_BYTES_PER_S
    assert reader("kernels.roofline_pct").read(run) == pytest.approx(
        100 * (stem_least + svd_least) / (0.4e-3 + 5e-6))


def test_readers_find_nothing():
    empty = SimpleNamespace(device_events=[], cpu_events=[], window_s=1.0, t0=0.0, t1=1.0, frames=0,
                            busy_s=0.0, kernel_calls=[])
    run = SimpleNamespace(trace=empty, records={}, config=CFG)
    for name in ("step.mfu_pct", "device.launches_per_frame", "kernel.fused_stem.roofline_pct",
                 "kernels.roofline_pct", "tracker.dispatch_ms", "engine.track_frame_ms_p50",
                 "engine.loop_frame_ms_p50"):
        assert reader(name).read(run) is None, name


def test_host_readers():
    frames = [(4, 0.08, True, False), (5, 0.05, False, False), (8, 0.10, True, False),
              (9, 0.40, False, True), (12, 0.50, True, True)]
    run = SimpleNamespace(trace=None, records={"frames": frames, "dispatch_s": [0.01, 0.03]}, config=CFG)
    assert reader("engine.track_frame_ms_p50").read(run) == pytest.approx(50.0)
    assert reader("engine.loop_frame_ms_p50").read(run) == pytest.approx(450.0)
    assert reader("tracker.dispatch_ms").read(run) == pytest.approx(20.0)


def test_breakdown_names_gaps_by_host_op():
    tr = _trace()
    tr.cpu_events = [("aten::mm", 1.0e-3, 1.9e-3), ("slam_bench.outer", 0.0, 2e-3)]
    b = harness.breakdown(tr)
    assert b["device_ops"][0][0].startswith("(anonymous namespace)::stem_kernel")
    assert b["idle_gaps"][0] == ["aten::mm", pytest.approx(1.0e-3)]


def test_yardstick_pieces():
    assert yardstick.interval_union_s([(0, 2), (1, 3), (5, 6)]) == 4
    assert yardstick.idle_gaps([(1, 2), (3, 4)], 0, 5) == [(0, 1), (2, 3), (4, 5)]
    assert yardstick.percentile([1, 2, 3, 4], 50) == 2.5
    assert yardstick.weighted_values([(0.5, 2), (0.1, 1)]) == [0.5, 0.5, 0.1]

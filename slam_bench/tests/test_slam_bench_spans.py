"""The readers of the program's spans (`spans.py` and the metrics built on
it) on hand-made traces: nesting, clipping to the traced span, and None
where the span a reader divides by never occurs."""

from pathlib import Path
from types import SimpleNamespace

import pytest

from slam_bench import harness, spans

METRICS = Path(__file__).resolve().parents[1] / "metrics"
ENGINE = ("engine.fetch_wait_ms", "engine.ba_ms_per_window", "engine.verify_ms_per_call",
          "engine.pose_graph_ms_per_solve", "engine.pose_graph_solves_per_frame")
TRACKER = ("tracker.ransac_ms", "tracker.refine_pose_ms")


def reader(name):
    return harness.load_module(METRICS / f"{name}.py", f"test_span_metric_{name}")


def _trace(cpu, frames=2, t0=0.0, t1=1.0):
    return SimpleNamespace(device_events=[], cpu_events=cpu, window_s=t1 - t0, t0=t0, t1=t1,
                           frames=frames, busy_s=0.0, kernel_calls=[])


def _run(cpu, frames=2, t0=0.0, t1=1.0):
    return SimpleNamespace(trace=_trace(cpu, frames, t0, t1), records={}, config={})


def _engine_events():
    """Two engine frames: the second a keyframe with a window BA, a loop
    verification and a pose-graph solve (seconds)."""
    return [
        ("slam.process", 0.00, 0.05), ("tracker.step", 0.00, 0.03), ("tracker.ransac", 0.010, 0.014),
        ("tracker.refine_pose", 0.020, 0.028), ("aten::mm", 0.021, 0.022),
        ("slam.consume", 0.04, 0.05), ("slam.fetch_wait", 0.040, 0.043),
        ("slam.process", 0.10, 0.50), ("tracker.step", 0.10, 0.13), ("tracker.ransac", 0.110, 0.116),
        ("tracker.refine_pose", 0.120, 0.126), ("slam.consume", 0.14, 0.50),
        ("slam.fetch_wait", 0.140, 0.145), ("slam.ba.dispatch", 0.15, 0.17), ("slam.ba.apply", 0.17, 0.20),
        ("slam.loop.verify", 0.21, 0.24), ("slam.pose_graph", 0.25, 0.49),
        ("slam.pose_graph.solve", 0.26, 0.46),
    ]


def test_occurrences_nesting_and_clipping():
    tr = _trace([("a", 0.1, 0.5), ("a", 0.2, 0.3), ("b", 0.15, 0.2), ("a", 0.6, 0.7),
                 ("a", -0.2, 0.05), ("a", 0.95, 1.4), ("a", 1.5, 1.6), ("a", -0.5, -0.1)])
    assert spans.occurrences(tr, "a") == [(0.0, 0.05), (0.1, 0.5), (0.6, 0.7), (0.95, 1.0)]
    assert spans.count(tr, "a") == 4
    assert spans.seconds(tr, "a") == pytest.approx(0.05 + 0.4 + 0.1 + 0.05)
    assert spans.count(tr, "b") == 1 and spans.count(tr, "c") == 0 and spans.seconds(tr, "c") == 0


def test_engine_readers():
    run = _run(_engine_events())
    assert reader("engine.fetch_wait_ms").read(run) == pytest.approx(1e3 * (0.003 + 0.005) / 2)
    assert reader("engine.ba_ms_per_window").read(run) == pytest.approx(1e3 * (0.02 + 0.03))
    assert reader("engine.verify_ms_per_call").read(run) == pytest.approx(30.0)
    assert reader("engine.pose_graph_ms_per_solve").read(run) == pytest.approx(240.0)
    assert reader("engine.pose_graph_solves_per_frame").read(run) == pytest.approx(0.5)


def test_tracker_readers():
    run = _run(_engine_events())
    assert reader("tracker.ransac_ms").read(run) == pytest.approx(1e3 * (0.004 + 0.006) / 2)
    assert reader("tracker.refine_pose_ms").read(run) == pytest.approx(1e3 * (0.008 + 0.006) / 2)


def test_readers_clip_to_the_traced_span():
    """A frame whose spans straddle t0 counts its part inside the span."""
    run = _run(_engine_events(), t0=0.042, t1=0.48)
    assert reader("engine.fetch_wait_ms").read(run) == pytest.approx(1e3 * (0.001 + 0.005) / 2)
    assert reader("engine.pose_graph_ms_per_solve").read(run) == pytest.approx(1e3 * (0.48 - 0.25))
    assert reader("tracker.ransac_ms").read(run) == pytest.approx(6.0)


def test_readers_none_where_the_divisor_never_occurs():
    no_keyframe = [e for e in _engine_events() if not e[0].startswith(("slam.ba", "slam.loop",
                                                                        "slam.pose_graph"))]
    run = _run(no_keyframe)
    for name in ("engine.ba_ms_per_window", "engine.verify_ms_per_call",
                 "engine.pose_graph_ms_per_solve"):
        assert reader(name).read(run) is None, name
    assert reader("engine.pose_graph_solves_per_frame").read(run) == 0.0
    assert reader("engine.fetch_wait_ms").read(run) == pytest.approx(4.0)


@pytest.mark.parametrize("name", ENGINE + TRACKER)
def test_readers_none_without_program_spans(name):
    """A program that opens no spans (an older tree) and a run without a
    trace give no number: the metric is left out of the line."""
    aten_only = [("aten::mm", 0.1, 0.2), ("cudaLaunchKernel", 0.3, 0.31)]
    assert reader(name).read(_run(aten_only)) is None
    assert reader(name).read(SimpleNamespace(trace=None, records={}, config={})) is None


def test_bench_lists_each_span_metric(bench):
    per_layer = {m["name"]: m for m in bench["per_layer"]}
    for name in ENGINE:
        assert per_layer[name]["workloads"] == ["kitti192_engine_patrol"], name
        assert per_layer[name]["layer"] == "engine"
    for name in TRACKER:
        assert set(per_layer[name]["workloads"]) == {w["name"] for w in bench["workloads"]}, name
        assert per_layer[name]["layer"] == "tracker" and per_layer[name]["moves"] == "frames_per_s"
    # Each reads the program's spans from the profiler's trace.
    assert {per_layer[name]["source"] for name in ENGINE + TRACKER} == {"device_trace"}

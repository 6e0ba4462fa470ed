"""The port's spans and counters (utils/profiling.py, slam.py,
frontend/tracker.py, backend/pose_graph.py), on the CPU:

- `profiling.span` off, on under a Timer's recording and on under
  torch.profiler; Timer recordings nest; no span synchronises a device;
- every span of the engine, the tracker and the pose graph, nested under
  its parent, on the closing 96x320 orbit of tests/test_torch_slam.py part
  (c) (the port alone, with its own noise): frames 0-99 untraced, the
  last 25, which close loops, under torch.profiler and a Timer's recording;
- each counter of `SlamSystem.counters` rises over those frames by the
  count of its span;
- poses and statistics bitwise equal with tracing on and off;
- the batched and chunked steps' spans, and the `track` CLI's counters.
"""

import dataclasses

import numpy as np
import pytest
import torch

from maveric_slam_tpu_torch import config as tconfig
from maveric_slam_tpu_torch import slam as tslam
from maveric_slam_tpu_torch.data import synthetic
from maveric_slam_tpu_torch.frontend import tracker as trk
from maveric_slam_tpu_torch.models import superpoint as tsp
from maveric_slam_tpu_torch.utils import profiling
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

H, W, ORBIT_N = 96, 320, 96
N_ORBIT, N_UNTRACED = 125, 100

# Each span and the span it nests in (None: outermost).
ENGINE_SPANS = {
    "slam.process": None,
    "tracker.step": "slam.process",
    "tracker.extract": "tracker.step",
    "tracker.match": "tracker.step",
    "tracker.camera": "tracker.step",
    "tracker.ransac": "tracker.step",
    "tracker.scale": "tracker.step",
    "tracker.refine_pose": "tracker.step",
    "tracker.state": "tracker.step",
    "slam.words": "slam.process",
    "slam.consume": "slam.process",
    "slam.fetch_wait": "slam.consume",
    "slam.track_table": "slam.consume",
    "slam.ba.apply": "slam.consume",
    "slam.ba.problem": "slam.consume",
    "slam.ba.dispatch": "slam.consume",
    "slam.lcd": "slam.consume",
    "slam.loop": "slam.consume",
    "slam.loop.verify": "slam.loop",
    "slam.pose_graph": "slam.loop",
    "slam.pose_graph.build": "slam.pose_graph",
    "slam.pose_graph.solve": "slam.pose_graph",
    "slam.pose_graph.apply": "slam.pose_graph",
    "pose_graph.normal_system": "slam.pose_graph.solve",
    "pose_graph.lu_solve": "slam.pose_graph.solve",
    "pose_graph.update": "slam.pose_graph.solve",
}
# A BA window still in flight when a loop is verified is applied first.
ALSO_UNDER = {"slam.ba.apply": "slam.loop"}
TAIL_SPANS = ("tracker.match", "tracker.camera", "tracker.ransac", "tracker.scale",
              "tracker.refine_pose", "tracker.state")
PREFIXES = ("slam.", "tracker.", "pose_graph.")


def _config():
    cam = tconfig.CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=48.0, width=W, height=H)
    d = tconfig.DEFAULT_CONFIG
    return dataclasses.replace(
        d, camera=cam, frontend=dataclasses.replace(d.frontend, height=H, width=W),
        ransac=dataclasses.replace(d.ransac, inlier_thresh=3.0 / 400.0))


CFG = _config()


def _spans(prof):
    """[(name, parent span or None)] of every program span in the trace, in
    the order they open (from the profiler's raw records: building its
    event tree for every aten operation takes a minute here)."""
    ranges = sorted(((e.start_ns(), -e.duration_ns(), e.name())
                     for e in prof.profiler.kineto_results.events()
                     if e.name().startswith(PREFIXES)), key=lambda r: r[:2])
    out, open_ = [], []  # open_: the enclosing spans' (end, name)
    for start, neg_dur, name in ranges:
        while open_ and open_[-1][0] <= start:
            open_.pop()
        out.append((name, open_[-1][1] if open_ else None))
        open_.append((start - neg_dur, name))
    return out


@pytest.fixture(scope="module")
def params():
    return tsp.load_params(device="cpu")


@pytest.fixture(scope="module")
def frames():
    poses = synthetic.orbit_poses(ORBIT_N, radius=8.0)
    return [synthetic.render_box_room(CFG.working_camera.K, poses[k % ORBIT_N], H, W)
            for k in range(N_ORBIT)]


def _engine(params, frames, traced: bool):
    """The engine over the orbit; with `traced`, the last frames under
    torch.profiler and a Timer's recording. Returns (engine, counters and
    verifications before the traced frames, the spans, the Timer)."""
    slam = tslam.SlamSystem(params, CFG, ba_every=4, enable_loop_closure=True, fetch_delay=0,
                            device="cpu")
    for f in frames[:N_UNTRACED]:
        slam.process(f)
    before = dict(slam.counters, verifications=slam.verifications, loops=len(slam.loop_events))
    timer = profiling.Timer()
    if not traced:
        for f in frames[N_UNTRACED:]:
            slam.process(f)
        return slam, before, None, None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.recording():
            for f in frames[N_UNTRACED:]:
                slam.process(f)
    return slam, before, _spans(prof), timer


@pytest.fixture(scope="module")
def runs(params, frames):
    return {"off": _engine(params, frames, False), "on": _engine(params, frames, True)}


def test_span_off_path_is_one_null_context():
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("slam.process"), profiling.span("tracker.step")
    assert a is b and a is profiling._NULL
    with a:
        pass
    assert profiling.span("x") is a


def test_span_closes_and_records_when_its_body_raises():
    timer = profiling.Timer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with timer.recording():
            with pytest.raises(ValueError):
                with profiling.span("slam.raised"):
                    with profiling.span("tracker.inner"):
                        raise ValueError("inside a span")
            with profiling.span("slam.after"):
                pass
    assert dict(timer.counts) == {"slam.raised": 1, "tracker.inner": 1, "slam.after": 1}
    assert _spans(prof) == [("slam.raised", None), ("tracker.inner", "slam.raised"),
                            ("slam.after", None)]
    assert profiling.span("x") is profiling._NULL


def test_recordings_nest_and_restore():
    outer, inner = profiling.Timer(), profiling.Timer()
    with outer.recording():
        with profiling.span("a"):
            with inner.recording() as t:
                assert t is inner
                with profiling.span("b"):
                    pass
            with profiling.span("c"):
                pass
    assert dict(outer.counts) == {"a": 1, "c": 1} and dict(inner.counts) == {"b": 1}
    assert outer.totals["a"] > 0.0 and inner.totals["b"] > 0.0
    assert profiling._recording is None and profiling.span("a") is profiling._NULL
    with pytest.raises(RuntimeError):
        with inner.recording():
            raise RuntimeError("inside a recording")
    assert profiling._recording is None


def test_no_span_synchronises_the_device(monkeypatch, params, frames):
    """Spans on, under the profiler and a recording, through a whole engine
    frame, with the CUDA device reported initialised and its synchronize
    made to fail."""
    def refuse():
        raise AssertionError("a span synchronised the device")

    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", refuse)
    slam = tslam.SlamSystem(params, CFG, ba_every=4, enable_loop_closure=True, fetch_delay=0,
                            device="cpu")
    timer = profiling.Timer()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with timer.recording():
            for f in frames[:5]:
                slam.process(f)
    assert timer.counts["slam.process"] == 5 and timer.counts["slam.ba.dispatch"] == 1


@pytest.mark.parametrize("name", sorted(ENGINE_SPANS))
def test_engine_span_nests_under_its_parent(runs, name):
    spans = runs["on"][2]
    parents = {p for n, p in spans if n == name}
    allowed = {ENGINE_SPANS[name], ALSO_UNDER.get(name, ENGINE_SPANS[name])}
    assert ENGINE_SPANS[name] in parents and parents <= allowed, (name, parents)


def test_every_engine_span_is_in_the_table(runs):
    assert {n for n, _ in runs["on"][2]} == set(ENGINE_SPANS)


# counter -> its rise over the traced frames, from the span counts c, the
# loop closures' rise and the counters' rises r
COUNTER_SPANS = {
    "keyframes": lambda c, loops, r: c["slam.lcd"],
    "ba_dispatched": lambda c, loops, r: c["slam.ba.dispatch"],
    "ba_skipped": lambda c, loops, r: c["slam.ba.problem"] - c["slam.ba.dispatch"],
    "verifications": lambda c, loops, r: c["slam.loop.verify"],
    "loops_accepted": lambda c, loops, r: loops,
    "pose_graph_solves": lambda c, loops, r: c["slam.pose_graph"],
}


@pytest.mark.parametrize("counter", sorted(COUNTER_SPANS))
def test_counter_rises_by_its_span_count(runs, counter):
    slam, before, spans, _ = runs["on"]
    counts = {n: sum(1 for m, _ in spans if m == n) for n in ENGINE_SPANS}
    now = dict(slam.counters, verifications=slam.verifications)
    rise = {k: now[k] - before[k] for k in now}
    loops = len(slam.loop_events) - before["loops"]
    assert rise[counter] == COUNTER_SPANS[counter](counts, loops, rise), (counter, rise, counts)
    # Every window has landmarks enough; the first closure in the traced
    # frames corrects the drift, and later ones may pass the gate or not.
    if counter != "ba_skipped":
        assert rise[counter] > 0, (counter, rise)
    assert counts["pose_graph.lu_solve"] == 8 * counts["slam.pose_graph"]
    assert counts["slam.loop"] == counts["slam.loop.verify"]
    # With fetch_delay 0 every window is applied as it is dispatched.
    assert counts["slam.ba.apply"] == counts["slam.ba.dispatch"]


def test_counters_are_every_name_and_zero_at_construction(params):
    slam = tslam.SlamSystem(params, CFG, device="cpu")
    assert slam.counters == dict.fromkeys(tslam.COUNTERS, 0) and len(tslam.COUNTERS) == 5


def test_timer_and_profiler_count_the_same_spans(runs):
    _, _, spans, timer = runs["on"]
    counts = {}
    for n, _ in spans:
        counts[n] = counts.get(n, 0) + 1
    assert dict(timer.counts) == counts
    assert timer.counts["slam.process"] == N_ORBIT - N_UNTRACED
    s = timer.summary()
    for child, parent in ENGINE_SPANS.items():
        if parent is not None:
            assert s[child]["total_s"] <= s[parent]["total_s"], (child, parent)


def test_tracing_leaves_poses_and_stats_bitwise(runs):
    off, on = runs["off"][0], runs["on"][0]
    assert off.stats == on.stats
    assert np.array_equal(np.stack(off.poses), np.stack(on.poses))
    assert [dataclasses.astuple(e) for e in off.loop_events] == [
        dataclasses.astuple(e) for e in on.loop_events]
    assert off.counters == on.counters


@pytest.mark.parametrize("mode", ["batched", "chunk"])
def test_stream_and_chunk_spans(params, frames, mode):
    imgs = torch.from_numpy(np.stack(frames[:3]))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        if mode == "batched":
            states = trk.init_states_batched(params, imgs[:2], CFG)
            trk.track_step_batched(params, states, imgs[1:3], CFG)
            outer, tails = "tracker.step", 1
        else:
            state = trk.init_state(params, imgs[0], CFG)
            trk.track_chunk(params, state, imgs[1:3], CFG)
            outer, tails = "tracker.chunk", 2
    spans = _spans(prof)
    assert [s for s in spans if s[0] == outer] == [(outer, None)]
    assert [s for s in spans if s[0] == "tracker.extract"] == [("tracker.extract", outer)]
    for name in TAIL_SPANS:
        assert [s for s in spans if s[0] == name] == [(name, outer)] * tails, name


def test_track_cli_prints_the_counters(tmp_path, capsys, monkeypatch):
    """The closing `counters:` line: the engine's counters, then its loop
    verifications (an engine stand-in over two blank images)."""
    cv2 = pytest.importorskip("cv2")
    from maveric_slam_tpu_torch.cli import track as track_cli

    class Engine:
        def __init__(self, *a, **k):
            self.counters = dict(zip(tslam.COUNTERS, range(1, len(tslam.COUNTERS) + 1)))
            self.verifications, self.loop_events, self.stats = 7, [], []

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            pass

        def process(self, image):
            pass

        def trajectory(self):
            return np.repeat(np.eye(4)[None], 2, 0)

    monkeypatch.setattr(tslam, "SlamSystem", Engine)
    monkeypatch.setattr(tsp, "load_params", lambda **k: None)
    img_dir = tmp_path / "images"
    img_dir.mkdir()
    for k in range(2):
        cv2.imwrite(str(img_dir / f"{k:06d}.png"), np.zeros((8, 16), np.uint8))
    track_cli.main([str(img_dir), "--out-dir", str(tmp_path / "out"), "--device", "cpu"])
    line = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("counters: ")]
    assert line == ["counters: keyframes=1 ba_dispatched=2 ba_skipped=3 loops_accepted=4 "
                    "pose_graph_solves=5 verifications=7"]

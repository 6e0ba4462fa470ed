"""The port's profiling hooks and the rest of its visualization, on the
CPU:

- `profiling.Timer` counts, means and report order; `profiling.trace`
  writes a trace file under its logdir; `block` returns its argument;
- `draw_features`, `draw_tracks` and `draw_epilines` pixel-equal to the JAX
  package's on the same seeded inputs (skipped without cv2).
"""

import time

import numpy as np
import pytest
import torch

from maveric_slam_tpu.tracks import Observation as JObservation
from maveric_slam_tpu.utils import visualization as jviz
from maveric_slam_tpu_torch.tracks import Observation
from maveric_slam_tpu_torch.utils import profiling
from maveric_slam_tpu_torch.utils import visualization as tviz
import torch_threads  # noqa: F401  (the tests' one torch thread policy)


def test_timer_counts_means_and_report_order():
    timer = profiling.Timer()
    for _ in range(3):
        with timer.scope("short"):
            time.sleep(0.002)
    with timer.scope("long", sync=False):
        time.sleep(0.03)
    with pytest.raises(ValueError):
        with timer.scope("raised"):
            raise ValueError("inside a scope")
    s = timer.summary()
    assert {k: v["count"] for k, v in s.items()} == {"short": 3, "long": 1, "raised": 1}
    assert s["short"]["total_s"] >= 0.006 and s["long"]["total_s"] >= 0.03
    assert s["short"]["mean_ms"] == pytest.approx(1000 * s["short"]["total_s"] / 3)
    lines = timer.report().splitlines()
    assert [ln.split()[0] for ln in lines][0] == "long"
    totals = [s[ln.split()[0]]["total_s"] for ln in lines]
    assert totals == sorted(totals, reverse=True)
    assert "3x" in next(ln for ln in lines if ln.startswith("short"))


def test_trace_writes_a_trace_file(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        x = profiling.block(torch.ones(8, 8) @ torch.ones(8, 8))
    assert torch.equal(x, torch.full((8, 8), 8.0))
    files = list(tmp_path.rglob("*.pt.trace.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0, list(tmp_path.rglob("*"))
    assert any(e.key == "aten::mm" for e in prof.key_averages())


def _image_and_points(seed, n=12, h=48, w=64):
    rng = np.random.default_rng(seed)
    img = rng.random((h, w)).astype(np.float32)
    xy = rng.uniform(2, min(h, w) - 2, size=(n, 2)).astype(np.float32)
    return rng, img, xy


def test_draw_features_matches_jax():
    pytest.importorskip("cv2")
    rng, img, xy = _image_and_points(5)
    mask = rng.random(len(xy)) > 0.3
    for kw in ({}, {"mask": mask, "color": (255, 0, 17)}):
        np.testing.assert_array_equal(tviz.draw_features(img, xy, **kw), jviz.draw_features(img, xy, **kw))


def test_draw_tracks_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    rng, img, _ = _image_and_points(6)
    tracks, scores = [], {}
    for tid in range(8):
        pts = rng.uniform(0, 60, size=(int(rng.integers(1, 6)), 2))
        tracks.append((tid, [(f, (float(x), float(y))) for f, (x, y) in enumerate(pts)]))
        if tid % 3:
            scores[tid] = float(rng.random() * 1.2 - 0.1)  # beyond both ends of the ramp too
    mine = [(tid, [Observation(*o) for o in obs]) for tid, obs in tracks]
    theirs = [(tid, [JObservation(*o) for o in obs]) for tid, obs in tracks]
    got = tviz.draw_tracks(img, mine, scores, out_path=str(tmp_path / "tracks.png"))
    np.testing.assert_array_equal(got, jviz.draw_tracks(img, theirs, scores))
    np.testing.assert_array_equal(tviz.draw_tracks(img, mine), jviz.draw_tracks(img, theirs))
    assert (tmp_path / "tracks.png").stat().st_size > 0


def test_draw_epilines_matches_jax(tmp_path):
    pytest.importorskip("cv2")
    rng, img, xy0 = _image_and_points(9)
    xy1 = xy0 + rng.normal(0, 2, size=xy0.shape).astype(np.float32)
    F = rng.normal(size=(3, 3))
    F[1, 2] = -F[1, 0]  # xy0[0] = (1, 0)'s line in image 1 has l[1] = 0: not drawn
    xy0[0] = (1.0, 0.0)
    for f in (F, np.eye(3, dtype=np.float32)):
        got = tviz.draw_epilines(img, img * 0.5, xy0, xy1, f, out_path=str(tmp_path / "epi.png"))
        np.testing.assert_array_equal(got, jviz.draw_epilines(img, img * 0.5, xy0, xy1, f))
        assert got.shape == (48, 128, 3)

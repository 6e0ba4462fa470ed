"""The port's map-side modules against the JAX package on the CPU: the
device feature pool (`mapping/feature_pool.py`), the track table
(`tracks.py`) and the trajectory metrics (`utils/evaluation.py`). Every bar
is exact: the pool and the track table hold integers, and the port's
track table and metrics are numpy copies of the JAX package's.
"""

import numpy as np
import pytest
import torch

from maveric_slam_tpu import tracks as jtracks
from maveric_slam_tpu.mapping import feature_pool as jpool
from maveric_slam_tpu.utils import evaluation as jeval
from maveric_slam_tpu_torch import tracks as ttracks
from maveric_slam_tpu_torch.mapping import feature_pool as tpool
from maveric_slam_tpu_torch.utils import evaluation as teval
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

FIELDS = ("first_seen", "last_seen", "num_sightings")


def synthetic_frames(rng, num_frames=30, per_frame=200, overlap=75, max_id=5000):
    """tests/test_feature_pool.py's stress pattern: frames carrying ~`overlap`
    ids over from the previous one (local_feature_matching.c:53-127)."""
    frames = []
    prev = rng.choice(max_id, per_frame, replace=False)
    frames.append(prev)
    for _ in range(num_frames - 1):
        keep = rng.choice(prev, overlap, replace=False)
        fresh = rng.choice(np.setdiff1d(np.arange(max_id), keep), per_frame - overlap, replace=False)
        prev = np.concatenate([keep, fresh])
        frames.append(prev)
    return frames


def _observe_both(pools, ids, frame, remove=True):
    jp, tp = pools
    ids = np.asarray(ids, np.int32)
    jp = jpool.observe_batch(jp, ids, np.int32(frame))
    tp = tpool.observe_batch(tp, torch.from_numpy(ids), frame)
    if remove:
        jp = jpool.remove_old(jp, np.int32(frame))
        tp = tpool.remove_old(tp, frame)
    return jp, tp


def _assert_pool_equal(jp, tp):
    for name in FIELDS:
        np.testing.assert_array_equal(getattr(tp, name).numpy(), np.asarray(getattr(jp, name)), name)


def test_pool_stress_matches_jax():
    """A seeded sequence of observe_batch / remove_old, each frame's ids
    with duplicates, -1 entries and (every third frame) word 0 added: the
    tables equal JAX's field by field after every frame, and both keep the
    invariant."""
    rng = np.random.default_rng(44)
    pools = (jpool.create(5000, window=8), tpool.create(5000, window=8))
    for f, ids in enumerate(synthetic_frames(rng)):
        extra = [-1, ids[0], ids[1], -1] + ([0, 0] if f % 3 == 0 else [])
        pools = _observe_both(pools, np.concatenate([ids, extra]), f)
        _assert_pool_equal(*pools)
        assert int(tpool.check_invariant(pools[1], f)) == int(jpool.check_invariant(pools[0], np.int32(f))) == 0
        assert int(tpool.size(pools[1])) == int(jpool.size(pools[0]))
    assert int(tpool.size(pools[1])) > 900  # the last 8 frames hold ~980 distinct ids


def test_pool_covisibility_weights():
    pools = (jpool.create(100, window=8), tpool.create(100, window=8))
    for f in range(3):
        pools = _observe_both(pools, [5, 7], f, remove=False)
    pools = _observe_both(pools, [9], 2, remove=False)
    q = np.array([5, 7, 9, 11, -1], np.int32)
    got = tpool.covisibility_weights(pools[1], torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jpool.covisibility_weights(pools[0], q)))
    np.testing.assert_array_equal(got, [3, 3, 1, 0, 0])


@pytest.mark.parametrize("ids,sighted", [
    ([3, 3, 3], {3}),  # duplicates count once
    ([-1, -1, 3], {3}),  # invalid ids never touch word 0
    ([0, -1, 0, -1], {0}),  # word 0 beside invalid ids: seen once
    ([-1, -1], set()),
])
def test_pool_duplicates_and_invalid_beside_word_zero(ids, sighted):
    pools = (jpool.create(50, window=8), tpool.create(50, window=8))
    for f in range(2):  # the same frame twice at frame 1 must not count twice
        pools = _observe_both(pools, ids, min(f, 1), remove=False)
    pools = _observe_both(pools, ids, 1, remove=False)
    _assert_pool_equal(*pools)
    seen = pools[1].num_sightings.numpy()
    assert set(np.nonzero(seen)[0].tolist()) == sighted
    assert all(seen[w] == 2 for w in sighted)  # frames 0 and 1


def test_pool_age_out_and_invariant_bits():
    pools = (jpool.create(20, window=4), tpool.create(20, window=4))
    for f in range(10):
        pools = _observe_both(pools, [5] if f < 6 else [6], f, remove=False)
    for cur in (9, 12, 20):
        j, t = jpool.remove_old(pools[0], np.int32(cur)), tpool.remove_old(pools[1], cur)
        _assert_pool_equal(j, t)
    # A hand-broken table: stale survivor (1), first > last (2), and a
    # present word without sightings (4).
    broken = pools[1]._replace(first_seen=pools[1].first_seen.clone(),
                               num_sightings=pools[1].num_sightings.clone())
    broken.first_seen[6] = 99
    broken.num_sightings[6] = 0
    jbroken = pools[0]._replace(first_seen=broken.first_seen.numpy(),
                                num_sightings=broken.num_sightings.numpy())
    assert int(tpool.check_invariant(broken, 9)) == int(jpool.check_invariant(jbroken, np.int32(9))) == 7


def _track_sequence(seed, num_frames=24, num_cells=64, n=20):
    """Seeded tracker-like output: each frame's n distinct cells, matches
    into the previous frame's cells (some shared, some -1), scores, masks and
    word ids with -1 entries."""
    rng = np.random.default_rng(seed)
    prev = rng.choice(num_cells, n, replace=False)
    out = []
    for f in range(num_frames):
        cells = rng.choice(num_cells, n, replace=False).astype(np.int32)
        matched = np.where(rng.random(n) < 0.8, rng.choice(prev, n), -1).astype(np.int32)
        out.append(dict(cells_new=cells, xy_new=rng.random((n, 2)).astype(np.float32) * 100,
                        matched_prev_cell=matched, score=rng.random(n).astype(np.float32),
                        mask=rng.random(n) < 0.9,
                        word_ids=np.where(rng.random(n) < 0.8, rng.integers(0, 500, n), -1)))
        prev = cells
    return out


def _assert_tables_equal(j, t):
    assert (t.next_id, t.num_cells, t.max_length) == (j.next_id, j.num_cells, j.max_length)
    np.testing.assert_array_equal(t.cell_to_track, j.cell_to_track)
    assert t.observations == j.observations
    assert t.scores == j.scores and t.words == j.words


@pytest.mark.parametrize("seed", [0, 1])
def test_track_table_matches_jax(seed):
    """advance / get_tracks / window_problem on a seeded sequence, with and
    without covisibility priorities."""
    j, t = jtracks.TrackTable(64, max_length=8), ttracks.TrackTable(64, max_length=8)
    for f, kw in enumerate(_track_sequence(seed)):
        j.advance(f, **kw)
        t.advance(f, **kw)
        _assert_tables_equal(j, t)
    for min_length in (2, 3, 8):
        assert t.get_tracks(min_length) == j.get_tracks(min_length)
    assert len(t.get_tracks(3)) > 5
    frames = list(range(16, 24))
    prio = {tid: float(tid % 5) for tid in t.observations}
    for priorities in (None, prio):
        for cap in (8, 64):
            got = t.window_problem(frames, cap, priorities=priorities)
            want = j.window_problem(frames, cap, priorities=priorities)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def _trajectory(rng, n):
    """Seeded cam-to-world poses along a noisy curve."""
    poses = np.tile(np.eye(4), (n, 1, 1))
    for k in range(1, n):
        w = rng.normal(size=3) * 0.05
        th = np.linalg.norm(w)
        kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
        R = np.eye(3) + np.sin(th) * kx + (1 - np.cos(th)) * kx @ kx
        step = np.eye(4)
        step[:3, :3], step[:3, 3] = R, rng.normal(size=3) * 0.3 + [0, 0, 1]
        poses[k] = poses[k - 1] @ step
    return poses


@pytest.mark.parametrize("align_scale", [True, False])
def test_evaluation_matches_jax(align_scale):
    rng = np.random.default_rng(5)
    gt = _trajectory(rng, 40)
    est = gt.copy()
    est[:, :3, 3] = 1.7 * gt[:, :3, 3] + rng.normal(size=(40, 3)) * 0.1
    assert teval.ate(est, gt, align_scale=align_scale) == jeval.ate(est, gt, align_scale=align_scale)
    assert teval.rpe(est, gt, delta=2) == jeval.rpe(est, gt, delta=2)
    s, R, t = teval.umeyama_alignment(est[:, :3, 3], gt[:, :3, 3])
    assert abs(s - 1 / 1.7) < 0.05

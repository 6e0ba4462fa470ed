"""Degenerate input through the port, held against the JAX package on the
CPU: the six cases of tests/test_degenerate.py, each asserted on both
packages and the two compared.

- RANSAC on zero valid matches, on fewer than eight, and on identical
  points (zero baseline), with JAX's own Gumbel noise injected into the
  port: inlier counts and masks equal;
- top-N on an all-dustbin grid: nothing selected in either;
- the tracker on a black frame, black -> real, real -> real and on
  repeated identical frames. tests/test_degenerate.py reads KITTI frames
  160-162, which the repository does not hold; here frames 0-2 of the
  96x320 orbit of tests/test_torch_tracker.py stand in, and the port takes
  the JAX tracker's noise step by step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as smoke
from maveric_slam_tpu import config as jconfig
from maveric_slam_tpu import slam as jslam
from maveric_slam_tpu.frontend import tracker as jtracker
from maveric_slam_tpu.geometry import ransac as jransac
from maveric_slam_tpu.models import superpoint as jsp
from maveric_slam_tpu.ops import softmax_topn as jst
from maveric_slam_tpu_torch import config as tconfig
from maveric_slam_tpu_torch.data import synthetic
from maveric_slam_tpu_torch.frontend import tracker as ttracker
from maveric_slam_tpu_torch.geometry import ransac as transac
from maveric_slam_tpu_torch.models import superpoint as tsp
from maveric_slam_tpu_torch.ops import softmax_topn as tst
from test_torch_tracker import H, W, _config, jax_ransac_noise
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

NUM_HYP = 64  # tests/test_degenerate.py's RANSAC cases


def ransac_noise(key, num_hypotheses, m):
    """The Gumbel noise JAX's `ransac_essential(key, ...)` draws over m
    points with `num_hypotheses` minimal hypotheses."""
    g = jax.vmap(lambda k: jax.random.gumbel(k, (m,)))
    lo_k = transac.lo_hypotheses(num_hypotheses)
    return (np.array(g(jax.random.split(key, num_hypotheses))),
            np.array(g(jax.random.split(jax.random.fold_in(key, 1), lo_k))))


def both_ransac(seed, p1, p2, mask):
    """(JAX's result, the port's result with JAX's noise) at the test's
    threshold and hypothesis count."""
    key = jax.random.PRNGKey(seed)
    j = jransac.ransac_essential(key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask),
                                 inlier_thresh=1e-2, num_hypotheses=NUM_HYP)
    gmin, glo = ransac_noise(key, NUM_HYP, p1.shape[0])
    t = transac.ransac_essential(torch.from_numpy(p1), torch.from_numpy(p2), torch.from_numpy(mask),
                                 inlier_thresh=1e-2, num_hypotheses=NUM_HYP,
                                 gumbel_min=torch.from_numpy(gmin), gumbel_lo=torch.from_numpy(glo))
    return j, t


def assert_same_inliers(j, t):
    assert int(t.num_inliers) == int(j.num_inliers)
    np.testing.assert_array_equal(t.inliers.numpy(), np.asarray(j.inliers))
    assert np.isfinite(t.R.numpy()).all() and np.isfinite(t.t.numpy()).all()


def test_ransac_zero_valid_matches():
    m = 64
    p = np.zeros((m, 2), np.float32)
    mask = np.zeros(m, bool)
    j, t = both_ransac(0, p, p.copy(), mask)
    for r in (j, t):
        assert int(r.num_inliers) == 0
        assert not bool(np.asarray(r.inliers).any())
    assert_same_inliers(j, t)


def test_ransac_fewer_than_sample_size_valid():
    rng = np.random.default_rng(7)
    m = 64
    p1 = rng.normal(0, 0.3, (m, 2)).astype(np.float32)
    p2 = p1 + rng.normal(0, 0.01, (m, 2)).astype(np.float32)
    mask = np.zeros(m, bool)
    mask[:5] = True  # < 8-point minimum
    j, t = both_ransac(1, p1, p2, mask)
    for r in (j, t):
        assert int(r.num_inliers) <= 5
        assert not bool(np.asarray(r.inliers)[~mask].any())
    assert_same_inliers(j, t)


def test_ransac_identical_points_zero_baseline():
    rng = np.random.default_rng(8)
    m = 128
    p = rng.normal(0, 0.3, (m, 2)).astype(np.float32)
    mask = np.ones(m, bool)
    j, t = both_ransac(2, p, p.copy(), mask)
    for r in (j, t):
        assert 0 <= int(r.num_inliers) <= m
    assert_same_inliers(j, t)


def test_top_n_all_dustbin_grid():
    j = jst.top_n_select(jst.SoftmaxGrid(probs=jnp.full((24, 80), -1.0),
                                         indices=jnp.full((24, 80), 64, jnp.int32)), n=100, mode="prob")
    t = tst.top_n_select(tst.SoftmaxGrid(probs=torch.full((24, 80), -1.0),
                                         indices=torch.full((24, 80), 64, dtype=torch.int32)),
                         n=100, mode="prob")
    assert int(t.num_selected) == int(j.num_selected) == 0
    assert not bool(t.mask.any()) and not bool(np.asarray(j.mask).any())
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))


def run_both(jp, tp, first, seq):
    """The JAX tracker (jit, PRNGKey(0)) over the sequence, and the port's
    with each step's noise taken from the JAX state's key: ([JAX steps],
    [port steps], JAX's final state, the port's, [(JAX's state scale, the
    port's) after each step])."""
    jcfg, tcfg = _config(jconfig), _config(tconfig)
    m, k = tcfg.frontend.top_n, tcfg.ransac.num_hypotheses
    lo_k = transac.lo_hypotheses(k)
    js = jtracker.init_state(jp, jnp.asarray(first), jcfg, 0)
    ts = ttracker.init_state(tp, torch.from_numpy(first), tcfg, 0)
    jout, tout, scales = [], [], []
    for f in seq:
        gmin, glo, _ = jax_ransac_noise(js.key, k, lo_k, m)
        js, a = jtracker.track_step(jp, js, jnp.asarray(f), jcfg)
        ts, b = ttracker.track_step(tp, ts, torch.from_numpy(f), tcfg,
                                    torch.from_numpy(gmin), torch.from_numpy(glo))
        jout.append(a)
        tout.append(b)
        scales.append((float(js.scale), float(ts.scale)))
    return jout, tout, js, ts, scales


@pytest.fixture(scope="module")
def tracker_runs():
    jp = jsp.load_params()
    tp = tsp.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    K = _config(tconfig).working_camera.K
    poses = synthetic.orbit_poses(96)
    frames = [synthetic.render_box_room(K, poses[k], H, W) for k in range(3)]
    return {name: run_both(jp, tp, seq[0], seq[1:])
            for name, seq in smoke.degenerate_sequences(frames).items()}


def _same_flags(jout, tout):
    assert [bool(s.valid) for s in tout] == [bool(s.valid) for s in jout]
    assert [int(s.num_inliers) for s in tout] == [int(s.num_inliers) for s in jout]
    assert [int(s.num_matches) for s in tout] == [int(s.num_matches) for s in jout]


def test_black_frame_yields_flagged_fallback(tracker_runs):
    """real -> black: not valid, the previous step's R and t (atol 1e-6), no
    match; black -> real stays not valid; real -> real recovers."""
    jout, tout, jstate, tstate, _ = tracker_runs["black"]
    for steps, to_np, final_scale in ((jout, np.asarray, np.asarray(jstate.scale)),
                                      (tout, lambda x: x.numpy(), tstate.scale.numpy())):
        step0, step1, step2, step3 = steps
        assert bool(step0.valid)
        assert not bool(step1.valid)
        np.testing.assert_allclose(to_np(step1.R), to_np(step0.R), atol=1e-6)
        np.testing.assert_allclose(to_np(step1.t), to_np(step0.t), atol=1e-6)
        assert np.isfinite(to_np(step1.R)).all()
        assert not bool(to_np(step1.match_mask).any())
        assert not bool(step2.valid)
        assert np.isfinite(to_np(step2.t)).all()
        assert bool(step3.valid) and int(step3.num_inliers) > 20
        assert np.isfinite(to_np(step3.R)).all()
        assert np.isfinite(final_scale)
    _same_flags(jout, tout)


def test_repeated_identical_frames(tracker_runs):
    """A zero-baseline stream: finite poses and scale on every step."""
    jout, tout, _, _, scales = tracker_runs["repeated"]
    for steps, to_np in ((jout, np.asarray), (tout, lambda x: x.numpy())):
        for s in steps:
            assert np.isfinite(to_np(s.R)).all() and np.isfinite(to_np(s.t)).all()
    assert np.isfinite(scales).all()
    _same_flags(jout, tout)


def test_identical_revisit_loop_edge_is_flow_bounded():
    """A loop candidate on a pixel-identical revisit: every match an inlier,
    zero flow, and unit depths out of range (the triangulation of a pair
    without baseline), so fewer than 8 points can scale the edge. The edge
    must not take the drifted trajectory's 10 m between the two frames: the
    flow bound pins it at 0.05 m. Here the port departs from the JAX
    package, whose fallback is unbounded (ROADMAP Faults (l))."""
    from maveric_slam_tpu_torch import slam as tslam

    n = 100
    slam = tslam.SlamSystem(tsp.load_params(device="cpu"), _config(tconfig), device="cpu")
    slam.poses = [np.eye(4) for _ in range(101)]
    slam.poses[100][:3, 3] = [6.0, 0.0, 8.0]  # odometry drift: 10 m
    slam.rel_poses = [(np.eye(3), np.zeros(3))] * 100
    out = np.concatenate([[n], np.eye(3).ravel(), [0.0, 0.0, 1.0], [0.0], np.ones(n),
                          np.full(n, 1e4)]).astype(np.float32)
    slam._verify_loop = lambda flat: out

    def entry(frame):
        return {"frame": frame, "desc": np.zeros((n, 256), np.int8), "mask": np.ones(n, bool),
                "xy": np.zeros((n, 2), np.float32), "depth": np.full(n, 5.0, np.float32),
                "depth_ok": np.ones(n, bool)}

    ev = slam._verify_and_close_loop(entry(4), entry(100), 100, 0.9)
    assert ev is not None and (ev.frame, ev.matched_frame) == (100, 4)
    assert abs(np.linalg.norm(slam.loop_edges[-1][3]) - 0.05) < 1e-6


# Loop-edge cases on which the JAX engine takes its depth-ratio branch (at
# least 8 good points), where the port's edge must be JAX's: (unit depth,
# flow median px, guess translation m, edge length the case pins). The
# keyframe's depths are 8 m, fx = 400 and the odometry steps 0.1 m.
DEPTH_RATIO_CASES = {
    "depth ratio": (10.0, 30.0, [6.0, 0.0, 8.0], 0.8),  # 8 / 10; neither bound binds
    "plausibility clamp": (0.5, 60.0, [0.3, 0.0, 0.4], 1.0),  # 16 m > 0.5 m guess + 5 steps
    "flow bound": (10.0, 2.0, [6.0, 0.0, 8.0], 0.11),  # 1.5 * 2 px * 8 m / 400 + 0.05
}


@pytest.mark.parametrize("case", list(DEPTH_RATIO_CASES))
def test_depth_ratio_loop_edge_matches_jax(case, monkeypatch):
    """Where the JAX engine scales a loop edge by the depth ratio, the port
    scales it the same way: both packages' `_verify_and_close_loop` on one
    verification result (60 of 100 points inliers with good depths) give
    the same edge, to the 1e-4 of tests/test_torch_slam.py's loop
    verification bar. The port departs from JAX only on the fallback branch
    (test_identical_revisit_loop_edge_is_flow_bounded, ROADMAP Faults (l))."""
    from maveric_slam_tpu_torch import slam as tslam

    z_unit, flow, guess, want = DEPTH_RATIO_CASES[case]
    n = 100
    c, s_ = np.cos(0.05), np.sin(0.05)
    R = np.array([[c, 0.0, s_], [0.0, 1.0, 0.0], [-s_, 0.0, c]])
    t_dir = np.array([0.6, 0.0, 0.8])
    inl = (np.arange(n) < 60).astype(np.float64)
    out = np.concatenate([[60], R.ravel(), t_dir, [flow], inl, np.full(n, z_unit)]).astype(np.float32)
    monkeypatch.setattr(jslam, "_verify_loop_device", lambda *a: out)

    def entry(frame):
        return {"frame": frame, "desc": np.zeros((n, 256), np.int8), "mask": np.ones(n, bool),
                "xy": np.zeros((n, 2), np.float32), "depth": np.full(n, 8.0, np.float32),
                "depth_ok": np.ones(n, bool)}

    edges = []
    for mod, cfg in ((jslam, jconfig), (tslam, tconfig)):
        slam = object.__new__(mod.SlamSystem)  # only what the edge reads
        slam.config, slam.key, slam.loop_edges = _config(cfg), jax.random.PRNGKey(0), []
        slam.poses = [np.eye(4) for _ in range(101)]
        slam.poses[100][:3, 3] = guess
        slam.rel_poses = [(np.eye(3), np.array([0.0, 0.0, 0.1]))] * 100
        slam._verify_loop = lambda flat: out
        slam._optimize_skeleton_graph = lambda matched, cur: None
        ev = slam._verify_and_close_loop(entry(4), entry(100), 100, 0.9)
        assert ev is not None and (ev.frame, ev.matched_frame, ev.num_inliers) == (100, 4, 60)
        edges.append(slam.loop_edges[-1])
    (jm, jc, jR, jt), (tm, tc, tR, tt) = edges
    assert (jm, jc) == (tm, tc) == (4, 100)
    assert abs(np.linalg.norm(jt) - want) < 1e-5, (case, np.linalg.norm(jt))
    np.testing.assert_allclose(tR, jR, atol=1e-4)
    np.testing.assert_allclose(tt, jt, atol=1e-4)

"""The comparison: the reference against itself reads nought, a wrong pose
is caught, and the limits judge."""

import numpy as np
import pytest
import torch

from slam_bench.reference import check
from slam_bench.scene import Scene


def _setup(small):
    cfg = check.build_config(small)
    scene = Scene(small["rows"], small["cols"], small["fx"], small["orbit_frames_per_turn"])
    scene.render(range(4), "cpu")
    params = check.load_params("cpu")
    return cfg, scene, params


def test_reference_against_itself_and_a_wrong_pose(small):
    cfg, scene, params = _setup(small)
    prev, new = scene.inputs([0, 1], 5, 0), scene.inputs([1, 2], 5, 1)
    noise = check.replay_noise([0, 1], [1], cfg, "cpu")[1]
    feats = check.extract(params, new, cfg)
    ref_new, _, res = check.follow_step(params, cfg, prev, new, None, feats.top.cells, noise, "cpu")
    tally = check.Tally()
    grid = {"desc": ref_new.desc_q, "probs": ref_new.probs, "indices": ref_new.indices, "xy": ref_new.xy}
    tally.grids(grid, ref_new)
    mine = {k: getattr(res, k) for k in ("R", "t", "cells_new", "match_score", "depth_top",
                                         "depth_top_ok")}
    tally.result(mine, res)
    numbers = tally.numbers()
    assert numbers["desc_diff"] == 0 and numbers["top_diff"] == 0
    assert numbers["pose_gap_deg"] == 0.0 and numbers["depth_gap"] == 0.0
    limits = {k: 0.0 for k in numbers}
    assert check.judge(numbers, limits)[0]

    # A pose turned by 1 degree about the camera's y axis.
    c, s = np.cos(np.radians(1.0)), np.sin(np.radians(1.0))
    turn = torch.tensor([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=torch.float32)
    wrong = check.Tally()
    wrong.result({**mine, "R": res.R @ turn}, res)
    assert abs(wrong.numbers()["pose_gap_deg"] - 1.0) < 1e-3
    ok, compared = check.judge(wrong.numbers(), {"pose_gap_deg": 0.5, "top_diff": 0, "score_gap": 0,
                                                 "depth_gap": 0.0, "desc_diff": 0, "idx_diff": 0,
                                                 "prob_gap": 0, "xy_gap_px": 0})
    assert not ok and compared["pose_gap_deg"]["value"] > 0.5

    # One stream of two turned, over three steps: the median cannot tell,
    # the third largest rotation gap can.
    one = check.Tally()
    R_one = torch.cat([res.R[:1] @ turn, res.R[1:]])
    for _ in range(3):
        one.result({**mine, "R": R_one}, res)
    assert one.numbers()["pose_gap_deg"] == pytest.approx(0.5, abs=1e-3)
    assert one.numbers()["pose_rot_deg_3rd"] == pytest.approx(1.0, abs=1e-3)
    assert not check.judge(one.numbers(), {**{k: 0 for k in numbers}, "pose_gap_deg": 0.5,
                                           "pose_rot_deg_3rd": 0.5})[0]


def test_program_order_is_taken_only_for_equal_selections(small):
    cfg, scene, params = _setup(small)
    feats = check.extract(params, scene.inputs([0, 1], 5, 0), cfg)
    top = feats.top
    flipped = torch.flip(top.cells, dims=[-1])
    same = check.in_program_order(top, flipped)
    assert torch.equal(same.cells, flipped)
    assert torch.equal(torch.sort(same.probs, -1).values, torch.sort(top.probs, -1).values)
    other = flipped.clone()
    other[0, 0] = -7  # not in the reference's selection: stream 0 keeps its own order
    kept = check.in_program_order(top, other)
    assert torch.equal(kept.cells[0], top.cells[0]) and torch.equal(kept.cells[1], flipped[1])


def test_judge():
    ok, compared = check.judge({"a": 1.0, "b": None, "c": 0}, {"a": 2.0, "c": 0})
    assert ok and list(compared) == ["a", "c"]
    assert not check.judge({"a": 3.0}, {"a": 2.0})[0]
    assert not check.judge({"a": 1.0}, {})[0]
    assert not check.judge({"a": float("nan")}, {"a": 2.0})[0]


def _ba_problem(cfg, seed=3):
    """A window of 8 poses along the x axis looking down z, 64 landmarks in
    front, observed with 0.5 px of noise, poses and points perturbed."""
    g = torch.Generator().manual_seed(seed)
    K = torch.from_numpy(cfg.working_camera.K).double()
    P, L = cfg.ba.num_poses, 64
    R = torch.eye(3, dtype=torch.float64).repeat(P, 1, 1)
    t = torch.stack([-0.1 * torch.arange(P, dtype=torch.float64), torch.zeros(P), torch.zeros(P)], -1)
    X = torch.rand(L, 3, generator=g, dtype=torch.float64) * torch.tensor([4.0, 2.0, 4.0]) + torch.tensor(
        [-2.0, -1.0, 4.0])
    p = torch.einsum("pij,lj->lpi", R, X) + t[None]
    uv = (K[:2, :2] @ (p[..., :2] / p[..., 2:]).unsqueeze(-1)).squeeze(-1) + K[:2, 2]
    uv = uv + 0.5 * torch.randn(uv.shape, generator=g, dtype=torch.float64)
    t_in = t + 0.02 * torch.randn(t.shape, generator=g, dtype=torch.float64) * (torch.arange(P) >= 2)[:, None]
    X_in = X + 0.05 * torch.randn(X.shape, generator=g, dtype=torch.float64)
    return {"R": R.float(), "t": t_in.float(), "X": X_in.float(), "uv": uv.float(),
            "mask": torch.ones(L, P, dtype=torch.bool)}


def test_backend_gaps_read_nought_sound_and_one_unchanged(small):
    """The window BA and the pose graph against their float64 re-solves: a
    solve in float32 misses almost nothing of the correction, a solve that
    returns its input misses all of it."""
    cfg = check.build_config(small)
    problem = _ba_problem(cfg)
    R, t = check.resolve_ba(problem, cfg, "cpu", torch.float64)
    tally = check.Tally()
    tally.ba(problem, {"R": R.float(), "t": t.float()}, cfg, "cpu")
    tally.ba(problem, {"R": problem["R"], "t": problem["t"]}, cfg, "cpu")
    sound, unchanged = tally.backend["ba_gap"]
    assert sound < 1e-3 and unchanged == pytest.approx(1.0)

    n = 8
    g = torch.Generator().manual_seed(5)
    R0 = torch.eye(3).repeat(n, 1, 1)
    t0 = torch.stack([torch.arange(n, dtype=torch.float32), torch.zeros(n), torch.zeros(n)], -1)
    i = torch.arange(n - 1)
    graph = {"R": R0, "t": t0 + 0.1 * torch.randn(t0.shape, generator=g),
             "edge_i": torch.cat([i, torch.tensor([0])]), "edge_j": torch.cat([i + 1, torch.tensor([n - 1])]),
             "R_meas": torch.eye(3).repeat(n, 1, 1),
             "t_meas": torch.cat([torch.tensor([[1.0, 0, 0]]).repeat(n - 1, 1), torch.tensor([[n - 1.0, 0, 0]])]),
             "weight": torch.ones(n)}
    R, t = check.resolve_pg(graph, "cpu")
    pg = check.Tally()
    pg.pg(graph, {"R": R.float(), "t": t.float()}, "cpu")
    pg.pg(graph, {"R": graph["R"], "t": graph["t"]}, "cpu")
    sound, unchanged = pg.backend["pg_gap"]
    assert sound < 1e-3 and unchanged == pytest.approx(1.0)
    numbers = pg.numbers()
    assert numbers["pg_gap"] == pytest.approx((sound + unchanged) / 2)
    assert not check.judge(numbers, {"pg_gap": 0.1})[0]

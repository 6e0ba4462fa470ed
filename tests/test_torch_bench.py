"""The port's bench and profiling tools (`maveric_slam_tpu_torch.bench`) on
the CPU: their inputs against the JAX tools', their operation counts, and
their control flow at 96x320 with two rounds. No number a CPU run returns
is a device measurement; the CLIs refuse to run without a card."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from maveric_slam_tpu_torch.bench import (common, headline, profile, scaling, suite,
                                          synthetic_accuracy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))
import scaling_bench  # noqa: E402  (the JAX package's tool)

CPU = torch.device("cpu")
H, W = 96, 320


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """These runs are thousands of small ops; with the tier-1 suite's
    workers on the same cores, torch's default of a thread a core makes
    each op's parallel region wait on busy cores. Two threads each keeps
    them moving; nothing here compares numbers across thread counts."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)

# tools/profile_roofline.py:172-199: each layer's conv_flops(hc, wc, cin,
# cout, k) at 192x640, the 1x1 heads with k = 1 (2 hc wc cin cout).
ROOFLINE_LAYERS = {
    "conv1a": (192, 640, 1, 64, 3), "conv1b": (192, 640, 64, 64, 3),
    "conv2a": (96, 320, 64, 64, 3), "conv2b": (96, 320, 64, 64, 3),
    "conv3a": (48, 160, 64, 128, 3), "conv3b": (48, 160, 128, 128, 3),
    "conv4a": (24, 80, 128, 128, 3), "conv4b": (24, 80, 128, 128, 3),
    "convPa": (24, 80, 128, 256, 3), "convPb": (24, 80, 256, 65, 1),
    "convDa": (24, 80, 128, 256, 3), "convDb": (24, 80, 256, 256, 1),
}


def _conv_flops(hc, wc, cin, cout, k=3):
    return 2 * hc * wc * cin * cout * k * k


@pytest.mark.parametrize("shape", [(1024, 8), (4096, 8)])
def test_build_problem_bitwise_equal_to_the_jax_tool(shape):
    want = scaling_bench.build_problem(*shape)
    got = scaling.build_problem(*shape)
    for name in ("K", "R", "t", "X", "uv", "mask"):
        a, b = np.asarray(getattr(want, name)), getattr(got, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(b, a, name)


def test_superpoint_flops_total():
    layers = common.superpoint_flops(192, 640)
    assert abs(sum(layer["ops"] for layer in layers) / 1e9 - 20.84) <= 0.01
    assert [layer["name"] for layer in layers] == list(ROOFLINE_LAYERS)
    assert {layer["unit"] for layer in layers[:2]} == {"int8 tensor cores"}
    assert {layer["unit"] for layer in layers[2:]} == {"f32 CUDA cores"}


@pytest.mark.parametrize("name", list(ROOFLINE_LAYERS))
def test_superpoint_flops_layer(name):
    layer = {lay["name"]: lay for lay in common.superpoint_flops(192, 640)}[name]
    assert layer["ops"] == _conv_flops(*ROOFLINE_LAYERS[name])


def test_unique_frames_deterministic_per_seed():
    frames = [np.full((8, 12), 0.5, np.float32), np.full((8, 12), 0.25, np.float32)]
    a, b, c = (common.unique_frames(frames, s) for s in (3, 3, 4))
    for x, y, z, f in zip(a, b, c, frames):
        assert x.dtype == np.float32 and x.shape == f.shape
        np.testing.assert_array_equal(x, y)
        assert not np.array_equal(x, z) and not np.array_equal(x, f)
        assert 0.01 < float(np.std(x - f)) < 0.03


def _finite_numbers(x):
    if isinstance(x, dict):
        return all(_finite_numbers(v) for v in x.values())
    if isinstance(x, list):
        return all(_finite_numbers(v) for v in x)
    return not isinstance(x, float) or np.isfinite(x)


CPU_DEVICE = {"name": "cpu: a control-flow run, no device measurement", "power_limit": None, "count": 0}


def test_headline_schema():
    out = headline.run(CPU, h=H, w=W, rounds=2, batched_rounds=2, chunks=2, streams=(2,), chunk=2,
                       baseline_iters=2)
    for key in ("metric", "value", "unit", "vs_baseline", "aggregate_fps_2_streams", "chunked_fps_k2",
                "ms_per_frame_single", "superpoint_gflop_per_frame", "achieved_tflops_best", "mfu",
                "device", "sync", "checks"):
        assert key in out, key
    assert out["device"] == CPU_DEVICE
    assert out["value"] > 0 and 0 < out["mfu"] <= 1 and _finite_numbers(out)
    assert set(out["checks"]) == {"single", "streams_2", "chunked_k2"}
    assert abs(out["mfu"] - common.frame_least_s(H, W) * out["aggregate_fps_2_streams"]) < 1e-12


def test_headline_quick():
    """--quick (tools/quickbench.py's role): one stream and the streams
    only, no chunks and no CPU baseline."""
    out = headline.run(CPU, h=H, w=W, rounds=2, batched_rounds=2, streams=(2,), quick=True)
    assert set(out["checks"]) == {"single", "streams_2"} and out["vs_baseline"] is None
    assert not any(k.startswith("chunked") for k in out) and 0 < out["mfu"] <= 1


def test_headline_check_fails_a_wrong_result():
    orbit = common.Orbit(H, W)
    R = np.broadcast_to(np.eye(3), (4, 3, 3))  # the identity: 3.75 deg off each step
    with pytest.raises(RuntimeError, match="bench check failed"):
        headline.step_checks("identity", np.ones(4, bool), np.full(4, 80), R, orbit)


def test_suite_schema():
    out = suite.run(CPU, h=H, w=W, pairwise_iters=1, rounds=2, engine_frames=64, ba_calls=1,
                    relin_calls=1, lcd_frames=256, lcd_calls=1, multi_rank_landmarks=1024,
                    ba_landmarks=128)
    assert out["device"] == CPU_DEVICE
    metrics = [r["metric"] for r in out["results"]]
    assert metrics == ["pairwise_pnp_pairs_per_s", "tracked_frames_per_s_chip", "slam_fps_integrated",
                       "window_ba_ms_per_iteration", "lcd_queries_per_s",
                       "multi_rank_ba_ms_per_iteration"]
    engine = out["results"][2]
    for key in ("ms_per_frame", "slam_host_ms", "slam_loop_ms", "slam_fetch_wait_ms", "slam_other_ms",
                "slam_device_busy_ms"):
        assert key in engine, key
    assert engine["checks"]["loop_closures"] > 0 and engine["slam_loop_ms"] > 0
    assert all(r["value"] > 0 for r in out["results"]) and _finite_numbers(out)
    assert "gloo" in out["results"][5]["unit"]


def test_scaling_sweep_schema():
    report = scaling.sweep("cpu", landmarks=1024, iterations=2, ranks=(1, 2), rounds=1)
    assert [r["ranks"] for r in report["rows"]] == [1, 2]
    for r in report["rows"]:
        assert r["backend"] == "gloo" and r["ms_per_iteration"] > 0 and r["compute_ms"] > 0
    assert report["rows"][0]["efficiency"] == 1.0
    assert report["device"] == CPU_DEVICE
    assert "| 2 | gloo |" in scaling.render_markdown(report)


def test_synthetic_accuracy_schema():
    out = synthetic_accuracy.run(CPU, seeds=2, frames_n=6)
    for key in ("scenario", "config", "ate_rmse_full_engine_m", "ate_rmse_odometry_only_m",
                "improvement", "rpe_rot_deg_mean", "loop_closures", "seeds",
                "ate_rmse_full_engine_m_over_seeds", "ate_rmse_odometry_only_m_over_seeds", "device"):
        assert key in out, key
    assert [r["seed"] for r in out["seeds"]] == [0, 1]
    assert out["seeds"][0]["valid_steps"] == 5 and out["device"] == CPU_DEVICE


def test_profile_schemas():
    st = profile.step(CPU, h=H, w=W, iters=1)
    assert [r["stage"] for r in st["rows"]] == [
        "init_state (extract)", "track_step", "extract_quantized", "superpoint_int8", "windowed_match",
        "normalize_points", "ransac_essential", "triangulate", "refine_pose"]
    b = profile.batched(CPU, h=H, w=W, streams=(2,), iters=1)
    assert [r["streams"] for r in b["rows"]] == [2] * 8
    rf = profile.roofline(CPU, h=H, w=W, iters=1)
    assert len(rf["rows"]) == 9
    assert abs(sum(r["gop"] for r in rf["rows"]) - sum(
        lay["ops"] for lay in common.superpoint_flops(H, W)) / 1e9) < 1e-9
    for r in rf["rows"]:
        assert r["ms"] > 0 and r["least_mb"] > 0 and 0 < r["share_of_bound"]
    assert "| net |" in profile.markdown(rf)
    assert all(x["device"] == CPU_DEVICE for x in (st, b, rf))


@pytest.mark.parametrize("module, argv", [
    ("headline", []), ("suite", []), ("scaling", []), ("profile", ["roofline"]),
    ("synthetic_accuracy", [])])
def test_cli_refuses_without_a_card(module, argv):
    """No CPU fallback: each CLI exits non-zero, with a message, when
    torch.cuda.is_available() is false."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", f"maveric_slam_tpu_torch.bench.{module}", *argv],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr, out.stderr[-2000:]
    assert out.stdout == ""

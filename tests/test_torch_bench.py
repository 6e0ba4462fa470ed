"""The port's profiling tools (`maveric_slam_tpu_torch.bench`) on the CPU:
their operation counts and their control flow at 96x320. No number a CPU run
returns is a device measurement; the CLIs refuse to run without a card."""

import os
import subprocess
import sys

import pytest
import torch

from maveric_slam_tpu_torch.bench import common, profile, synthetic_accuracy
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
H, W = 96, 320


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


CPU_DEVICE = {"name": "cpu: a control-flow run, no device measurement", "power_limit": None, "count": 0}


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
    ("profile", ["roofline"]), ("synthetic_accuracy", [])])
def test_cli_refuses_without_a_card(module, argv):
    """No CPU fallback: each CLI exits non-zero, with a message, when
    torch.cuda.is_available() is false."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "-m", f"maveric_slam_tpu_torch.bench.{module}", *argv],
                         capture_output=True, text=True, cwd=REPO, timeout=120)
    assert out.returncode != 0 and "no CUDA device" in out.stderr, out.stderr[-2000:]
    assert out.stdout == ""

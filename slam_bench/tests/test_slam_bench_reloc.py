"""The `reloc` client's cell, `kitti376_lightglue_reloc16`.

The cell resolves, its configuration states the published widths and its
cuts, and LightGlue's count and the three readers read what they should. It runs on the
CPU at 96x320, with LightGlue cut to 2 layers, 2 candidates a query and a
48-frame orbit: sound, it is correct; with each fault planted in LightGlue
on the timed path, and with the int4 control, it is not.
`test_controls_on_the_card` runs both controls at the cell's own size."""

import json
import os
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest
import torch

from slam_bench import controls, harness, lightglue_count, yardstick
from slam_bench.reference import check

from .conftest import cpu_threads

WORKLOAD = "kitti376_lightglue_reloc16"
TRAFFIC = {"offsets": [-2, 2], "warm_calls": 1, "sample_calls": 2}


def reader(name):
    return harness.load_module(harness.HERE / "metrics" / f"{name}.py", f"test_metric_{name}")


def test_cell_resolves(at_root, bench):
    res = harness.resolve(bench, WORKLOAD, at_root)
    assert res.limits and res.per_layer and {m["name"] for m in res.per_layer} == set(res.readers)
    built = check.build_config(res.config)
    assert (built.frontend.height, built.frontend.width) == (res.config["rows"], res.config["cols"])
    assert (at_root / "slam_bench" / "clients" / f"{res.traffic['client']}.py").exists()


def test_lightglue_configuration_states_the_published_widths(bench):
    entry = {c["name"]: c for c in bench["configs"]}["sp_lightglue_kitti_376x1240"]
    cfg = json.loads((harness.HERE.parent / entry["file"]).read_text())
    lg = cfg["lightglue"]
    assert (lg["input_dim"], lg["descriptor_dim"], lg["n_layers"], lg["num_heads"], lg["head_dim"],
            lg["mlp_dim"], lg["filter_threshold"]) == (256, 256, 9, 4, 64, 512, 0.1)
    assert (lg["depth_confidence"], lg["width_confidence"]) == (-1, -1)
    assert set(entry["reduced"]) == {"cols", "depth_confidence", "width_confidence",
                                     "database_keyframes"} == set(cfg["reduced"])
    assert cfg["max_keypoints"] == 1000 and (cfg["rows"], cfg["cols"]) == (376, 1240)
    assert cfg["database_keyframes"] == cfg["orbit_frames_per_turn"]


def test_lightglue_count():
    """The figures of a pair at K = 1000: 2.33 GFLOP a self block, 3.90 a
    cross block (S once), 0.78 the assignment, 77.86 the pair."""
    cfg = {"max_keypoints": 1000, "lightglue": {"descriptor_dim": 256, "mlp_dim": 512, "n_layers": 9}}
    assert lightglue_count.self_block_ops(cfg) == 2_334_720_000
    assert lightglue_count.cross_block_ops(cfg) == 3_895_296_000
    assert lightglue_count.assignment_ops(cfg) == 775_168_000
    assert lightglue_count.pair_ops(cfg) == 77_857_792_000
    assert lightglue_count.attention_ops(cfg) == 9 * 7 * 512_000_000
    assert 16 * lightglue_count.pair_least_s(cfg) == pytest.approx(18.593e-3, rel=1e-4)


def test_reloc_readers(bench):
    cfg = json.loads((harness.HERE / "configs" / "sp_lightglue_kitti_376x1240.json").read_text())
    traffic = json.loads((harness.HERE / "traffic" / "reloc16.json").read_text())
    events = [("fmha_cutlassF_f32_aligned_64x64_rf_sm80(PyTorchMemEffAttention::AttentionKernel)",
               0.0, 20e-3), ("sm80_xmma_gemm_f32f32", 20e-3, 40e-3)]
    cpu = [("pairwise.batch", 0.0, 60e-3), ("pairwise.match", 1e-3, 13e-3),
           ("pairwise.batch", 60e-3, 120e-3), ("pairwise.match", 61e-3, 69e-3)]
    tr = SimpleNamespace(device_events=events, cpu_events=cpu, window_s=0.12, t0=0.0, t1=0.12,
                         frames=2, busy_s=0.04, kernel_calls=[])
    run = SimpleNamespace(trace=tr, records={}, config=cfg, traffic=traffic)
    least = yardstick.frame_least_s(376, 1240) + 16 * lightglue_count.pair_least_s(cfg)
    assert reader("reloc.step_mfu_pct").read(run) == pytest.approx(100 * least * 2 / 0.12)
    assert reader("lightglue.attention_roofline_pct").read(run) == pytest.approx(
        100 * 32 * lightglue_count.attention_least_s(cfg) / 20e-3)
    assert reader("pairwise.lightglue_ms").read(run) == pytest.approx(10.0)
    none = SimpleNamespace(trace=None, records={}, config=cfg, traffic=traffic)
    empty = SimpleNamespace(trace=SimpleNamespace(device_events=[], cpu_events=[], window_s=1.0, t0=0.0,
                                                  t1=1.0, frames=0, busy_s=0.0, kernel_calls=[]),
                            records={}, config=cfg, traffic=traffic)
    for name in ("reloc.step_mfu_pct", "lightglue.attention_roofline_pct", "pairwise.lightglue_ms"):
        assert reader(name).read(none) is None and reader(name).read(empty) is None, name


def _skip_last_layer(lg, monkeypatch):
    for name in ("self_block", "cross_block"):
        fn = getattr(lg, name)

        def block(W, i, x, *a, _fn=fn, **kw):
            last = sum(1 for k in W if k.endswith("self_attn.Wqkv.weight")) - 1
            return x if i == last else _fn(W, i, x, *a, **kw)

        monkeypatch.setattr(lg, name, block)


def _no_rotary(lg, monkeypatch):
    monkeypatch.setattr(lg, "apply_rotary", lambda enc, t: t)


def _cross_transposed(lg, monkeypatch):
    """m_1 from the row softmax of S, transposed, in place of the row
    softmax of S^T."""
    import torch.nn.functional as F

    def cross_block(W, i, x, bias, heads):
        p = f"transformers.{i}.cross_attn"
        qk = lg._heads(lg._linear(W, f"{p}.to_qk", x), heads)
        v = lg._heads(lg._linear(W, f"{p}.to_v", x), heads)
        (qk0, qk1), (v0, v1), (b0, b1) = qk.chunk(2), v.chunk(2), bias.chunk(2)
        s = qk0 @ qk1.transpose(-1, -2) / qk.shape[-1] ** 0.5 + b1
        a = F.softmax(s, -1)
        m = torch.cat([a @ v1, a.transpose(-1, -2) @ v0])
        return lg.ffn(W, p, x, lg._linear(W, f"{p}.to_out", lg._merge(m)))

    monkeypatch.setattr(lg, "cross_block", cross_block)


def _single_softmax(lg, monkeypatch):
    """The assignment's column softmax replaced by the row softmax: one
    softmax direction, counted twice."""
    import torch.nn.functional as F

    def log_assignment(W, i, x, mask0, mask1):
        p = f"log_assignment.{i}"
        md = lg._linear(W, f"{p}.final_proj", x) / x.shape[-1] ** 0.25
        z = lg._linear(W, f"{p}.matchability", x)[..., 0]
        (md0, md1), (z0, z1) = md.chunk(2), z.chunk(2)
        sim = (md0 @ md1.transpose(-1, -2)).masked_fill(~mask1[:, None, :], -torch.inf)
        core = 2 * F.log_softmax(sim, 2) + F.logsigmoid(z0)[:, :, None] + F.logsigmoid(z1)[:, None, :]
        core = core.masked_fill(~(mask0[:, :, None] & mask1[:, None, :]), -torch.inf)
        top = torch.cat([core, torch.where(mask0, F.logsigmoid(-z0), -torch.inf)[:, :, None]], 2)
        bottom = torch.cat([torch.where(mask1, F.logsigmoid(-z1), -torch.inf),
                            torch.zeros_like(z1[:, :1])], 1)[:, None, :]
        return torch.cat([top, bottom], 1)

    monkeypatch.setattr(lg, "log_assignment", log_assignment)


def _padding_unmasked(lg, monkeypatch):
    """Padded keypoints treated as valid everywhere."""
    fn = lg.LightGlue.__call__

    def call(self, xy0, xy1, desc0, desc1, mask0, mask1, size):
        return fn(self, xy0, xy1, desc0, desc1, torch.ones_like(mask0), torch.ones_like(mask1), size)

    monkeypatch.setattr(lg.LightGlue, "__call__", call)


def _filter_not_mutual(lg, monkeypatch):
    """The filter's mutual test dropped: every row's argmax counts."""
    fn = lg.filter_matches

    def filter_matches(scores, threshold):
        matches0, mscores0, _ = fn(scores, threshold)
        best = scores[:, :-1, :-1].max(2)
        return matches0, mscores0, torch.where(torch.isfinite(best.values), best.indices, -1)

    monkeypatch.setattr(lg, "filter_matches", filter_matches)


FAULTS = {"skip_last_layer": _skip_last_layer, "no_rotary": _no_rotary,
          "cross_transposed": _cross_transposed, "single_softmax": _single_softmax,
          "padding_unmasked": _padding_unmasked, "filter_not_mutual": _filter_not_mutual}


@pytest.fixture
def reloc_small(small):
    """The CPU tests' configuration with the LightGlue block, 2 layers, the
    cell's room scale and a 48-frame orbit."""
    entry = json.loads((harness.HERE / "configs" / "sp_lightglue_kitti_376x1240.json").read_text())
    return {**small, "orbit_frames_per_turn": 48, "database_keyframes": 48,
            "room_scale": entry["room_scale"], "lightglue": {**entry["lightglue"], "n_layers": 2}}


def _run(at_root, bench, cfg, plant):
    """One run on the CPU; `plant(port, ctx)` changes the timed path first."""
    cpu_threads()
    res = harness.resolve(bench, WORKLOAD, at_root)
    res.config, res.traffic = cfg, {**res.traffic, **TRAFFIC}
    with controls.restored(harness.port_modules()):
        return harness.run_cell(res, 2**33 + 17, 1.0, False, torch.device("cpu"),
                                time.perf_counter(), plant=plant)


def test_sound_run_is_correct(at_root, bench, reloc_small):
    out = _run(at_root, bench, reloc_small, None)
    assert out["correct"], out["numbers"]
    n = out["numbers"]
    assert n["kpt_diff"] == 0 and n["match_diff"] == 0 and n["assign_log_gap"] < 1e-3
    assert n["mutual_diff"] == 0
    assert out["window"]["records"]["pairs"] > 0


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(at_root, bench, reloc_small, fault, monkeypatch):
    from maveric_slam_tpu_torch.models import lightglue as lg

    out = _run(at_root, bench, reloc_small, lambda port, ctx: FAULTS[fault](lg, monkeypatch))
    assert not out["correct"], out["numbers"]


def test_int4_control_is_not_correct(at_root, bench, reloc_small):
    out = _run(at_root, bench, reloc_small, controls.PLANTS["control_int4"])
    assert not out["correct"], out["numbers"]


@pytest.mark.cuda
@pytest.mark.parametrize("plant", ["control_tf32", "control_int4"])
def test_controls_on_the_card(at_root, plant):
    """Each control on three seeds at the cell's own size: never correct."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = subprocess.run(
        [sys.executable, "slam_bench/controls.py", "--workload", WORKLOAD, "--plant", plant,
         "--seeds", str(2**33 + 1), str(2**33 + 2), str(2**33 + 3), "--seconds", "6"],
        cwd=at_root, capture_output=True, text=True, timeout=900, env={**os.environ})
    assert out.returncode == 0, out.stderr[-2000:]
    lines = [json.loads(x) for x in out.stdout.splitlines()]
    assert len(lines) == 3
    assert not any(x["correct"] for x in lines), [x["numbers"] for x in lines]

"""The result's last line, the refusal without a card, and the import
check."""

import json
import shutil
import subprocess
import sys
import types

from slam_bench import harness


def _out(trace):
    return {"correct": True, "frames": 320, "memory_peak_bytes": 123,
            "metrics": {"frames_per_s": {"value": 10.5, "unit": "frames/s"}},
            "device_extra": {"busy_s": 0.5, "window_s": 1.5} if trace else {},
            "breakdown": {"device_ops": [["k", 0.1]], "idle_gaps": [["aten::mm", 0.01]]},
            "compared": {"desc_diff": {"value": 0, "limit": 0}}}


def test_result_line_schema():
    for trace in (False, True):
        out = _out(trace)
        if not trace:
            out.pop("breakdown")
        line = harness.result_line(out, "NVIDIA H100 80GB HBM3", 1)
        assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert list(line)[-1] == "compared"
        dev = line["device"]
        assert dev["platform"] == "gpu" and dev["count"] == 1 and dev["memory_peak_bytes"] == 123
        assert ("busy_s" in dev) == trace and ("window_s" in dev) == trace
        assert ("breakdown" in line) == trace
        json.dumps(line)
    assert harness.comparison_lines({"desc_diff": {"value": 0, "limit": 0}}) == [
        "compared desc_diff 0 limit 0"]


def test_refuses_without_a_card(at_root):
    out = subprocess.run([sys.executable, "slam_bench/run.py", "--workload", "kitti192_streams16",
                          "--seed", str(2**33 + 1), "--seconds", "1", "--trace", "0"],
                         cwd=at_root, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_refuses_without_the_program(tmp_path, at_root):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    files, a run gives no result."""
    shutil.copytree(at_root / "slam_bench", tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(at_root / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    out = subprocess.run([sys.executable, "slam_bench/run.py", "--workload", "kitti192_streams16",
                          "--seed", "7", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and out.stdout == ""


def test_import_check_compares_whole_top_level_names(monkeypatch):
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "maveric_slam_tpu_torch_like", types.ModuleType("x"))
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "maveric_slam_tpu.data", types.ModuleType("maveric_slam_tpu.data"))
    monkeypatch.setitem(sys.modules, "jaxlib", types.ModuleType("jaxlib"))
    assert harness.forbidden_modules() == ["jaxlib", "maveric_slam_tpu.data"]


def test_harness_and_reference_import_no_jax_and_no_program(at_root):
    code = ("import sys; sys.path.insert(0, '.');"
            "import slam_bench.harness, slam_bench.reference.check, slam_bench.controls;"
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'maveric_slam_tpu', 'maveric_slam_tpu_torch')))")
    out = subprocess.run([sys.executable, "-c", code], cwd=at_root, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"

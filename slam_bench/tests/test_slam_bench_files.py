"""Every name in BENCHMARK.json resolves to its files, and a cell, a mix
or a metric is added by adding files only."""

import json
import re
import shutil
import subprocess
import sys

import pytest

from slam_bench import harness
from slam_bench.reference import check

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                          "per_layer"}
    assert bench["paths"] == ["slam_bench"]
    assert 1 <= bench["run_seconds"] <= 51


def test_names_and_units(bench):
    names = [c["name"] for c in bench["configs"]] + [w["name"] for w in bench["workloads"]]
    names += [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert {"setup_s", "frames_per_s", "frame_ms_p50", "frame_ms_p95"} <= e2e
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:  # the cell reports the metric this one moves
            moved = {e["name"]: e for e in bench["end_to_end"]}[m["moves"]]
            assert w in moved.get("workloads", [w]), (m["name"], w)


@pytest.mark.parametrize("workload", ["kitti192_engine_patrol", "kitti376_streams16",
                                      "kitti192_streams16"])
def test_workload_resolves(at_root, bench, workload):
    res = harness.resolve(bench, workload, at_root)
    assert res.limits, "every cell has its limits file"
    assert {m["name"] for m in res.per_layer} == set(res.readers)
    for reader in res.readers.values():
        assert callable(reader.read)
    assert (at_root / "slam_bench" / "clients" / f"{res.traffic['client']}.py").exists()


@pytest.mark.parametrize("name", ["sp_kitti_192x640", "sp_kitti_376x1240"])
def test_config_is_as_run(at_root, bench, name):
    entry = {c["name"]: c for c in bench["configs"]}[name]
    cfg = json.loads((at_root / entry["file"]).read_text())
    built = check.build_config(cfg)
    assert (built.frontend.height, built.frontend.width) == (cfg["rows"], cfg["cols"])
    assert built.frontend.height % 8 == 0 and built.frontend.width % 8 == 0
    assert set(entry["reduced"]) <= set(cfg)


def test_config_mismatch_raises(small):
    small["top_n"] = 99
    with pytest.raises(ValueError, match="top_n"):
        check.build_config(small)


def test_dummy_workload_is_files_only(tmp_path, at_root, bench):
    """A new cell with a new mix and limits, added as files in a copy of the
    checkout, resolves without a line of code changed."""
    shutil.copytree(at_root / "slam_bench", tmp_path / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "slam_bench" / "traffic" / "streams4.json").write_text(json.dumps(
        {"client": "streams", "streams": 4, "phase_step": 12, "warm_steps": 2, "sample_steps": 2,
         "trace_units": 4}))
    (tmp_path / "slam_bench" / "limits" / "kitti192_streams4.json").write_text(
        (at_root / "slam_bench" / "limits" / "kitti192_streams16.json").read_text())
    bench["workloads"].append({"name": "kitti192_streams4", "config": "sp_kitti_192x640",
                               "traffic": "streams4", "chips": 1, "why": "a dummy"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import json, sys; from pathlib import Path; sys.path.insert(0, '.');"
            "from slam_bench import harness;"
            "r = harness.resolve(json.loads(Path('BENCHMARK.json').read_text()), 'kitti192_streams4', Path('.'));"
            "print(r.traffic['streams'], r.config['name'], len(r.readers), sorted(r.limits)[0])")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[:2] == ["4", "sp_kitti_192x640"]

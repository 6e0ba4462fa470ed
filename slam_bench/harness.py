"""One run of one cell: set-up, the measured window, the traced span, the
per-layer readers and the comparison with the reference.

`run_cell` takes everything by argument, so that the tests can drive a run
on the CPU at a small size and plant faults in the timed path; `run.py` is
the command that the benchmark's contract names.
"""

from __future__ import annotations

import importlib.util
import json
import os
import random
import sys
import time
from pathlib import Path
from types import SimpleNamespace
from typing import Callable, Dict, List, Optional

from . import yardstick
from .scene import Scene

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "maveric_slam_tpu")
MARKERS = 256  # empty kernels on each side of the traced span, which take the profiler's lost records


class Reservoir:
    """A uniform sample of at most k items from a stream of unknown length,
    drawn from `rng` (the run's seed)."""

    def __init__(self, k: int, rng: random.Random):
        self.k, self.rng, self.seen, self.items = k, rng, 0, []

    def offer(self, item) -> None:
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = self.rng.randrange(self.seen)
            if j < self.k:
                self.items[j] = item


def load_module(path: Path, name: str):
    """A module from a file of the benchmark, found by the name that
    BENCHMARK.json gives (names may hold dots, which imports cannot)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def resolve(bench: dict, workload: str, root: Path) -> SimpleNamespace:
    """The cell's entry, its configuration file, its traffic file, its
    limits and its per-layer metrics' readers, by name."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    config = json.loads((root / cfg_entry["file"]).read_text())
    traffic = json.loads((HERE / "traffic" / f"{cell['traffic']}.json").read_text())
    limits_path = HERE / "limits" / f"{workload}.json"
    limits = json.loads(limits_path.read_text())["limits"] if limits_path.exists() else {}
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    layer = [m for m in bench["per_layer"] if workload in m.get("workloads", [workload])]
    readers = {m["name"]: load_module(HERE / "metrics" / f"{m['name']}.py", f"slam_bench_metric_{i}")
               for i, m in enumerate(layer)}
    return SimpleNamespace(cell=cell, config=config, traffic=traffic, limits=limits,
                           end_to_end=e2e, per_layer=layer, readers=readers)


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def set_cache_dirs(root: Path) -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton")):
        os.environ[var] = str(root / "build" / "slam_bench" / sub)
    os.environ.setdefault("USE_FLAX", "0")


def port_modules():
    """The system under test: the port's modules that a client calls through
    (by attribute, so that a planted fault or control reaches the timed path)."""
    import maveric_slam_tpu_torch  # noqa: F401  (sets TF32 off)
    from maveric_slam_tpu_torch import slam
    from maveric_slam_tpu_torch.backend import ba, pose_graph
    from maveric_slam_tpu_torch.frontend import tracker
    from maveric_slam_tpu_torch.models import superpoint
    from maveric_slam_tpu_torch.ops.kernels import _build

    return SimpleNamespace(slam=slam, ba=ba, pose_graph=pose_graph, tracker=tracker,
                           superpoint=superpoint, build=_build)


class KernelCalls:
    """Records the integer arguments of each launch of the program's kernels
    through their C entry points, while a traced span runs."""

    def __init__(self, lib):
        self.lib, self.calls, self.orig = lib, [], {}

    def __enter__(self):
        for name in yardstick.KERNEL_SYMBOLS:
            fn = getattr(self.lib, name)
            self.orig[name] = fn

            def rec(*args, _fn=fn, _name=name):
                self.calls.append((_name, tuple(a for a in args)))
                return _fn(*args)

            setattr(self.lib, name, rec)
        return self

    def __exit__(self, *exc):
        for name, fn in self.orig.items():
            setattr(self.lib, name, fn)


def _kineto_events(prof):
    """(device events [(name, start_s, end_s)], cpu events, traced span
    (start_s, end_s)) from the profiler's raw records."""
    import torch

    dev, cpu, span = [], [], None
    for e in prof.profiler.kineto_results.events():
        s = e.start_ns() * 1e-9
        t = s + e.duration_ns() * 1e-9
        name = e.name()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not e.is_user_annotation() and yardstick.MARKER_SYMBOL not in name:
                dev.append((name, s, t))
        elif name == "slam_bench.traced":
            span = (s, t)
        else:
            cpu.append((name, s, t))
    return dev, cpu, span


def trace_span(client, units: int, device, port) -> SimpleNamespace:
    """Runs `units` more units of the cell under torch.profiler, between
    marker kernels, and reduces the trace: device events inside the span,
    the span's length, the frames it delivered, the kernels' launch
    arguments, busy time and the breakdown."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    frames = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(MARKERS):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
        with KernelCalls(port.build.library()) as calls:
            with record_function("slam_bench.traced"):
                for _ in range(units):
                    frames += client.unit(window=False)
                torch.cuda.synchronize()
        for _ in range(MARKERS):
            torch.cuda._sleep(0)
        torch.cuda.synchronize()
    dev, cpu, span = _kineto_events(prof)
    t0, t1 = span
    dev = [(n, max(s, t0), min(e, t1)) for n, s, e in dev if e > t0 and s < t1]
    busy = yardstick.interval_union_s([(s, e) for _, s, e in dev])
    return SimpleNamespace(device_events=dev, cpu_events=cpu, window_s=t1 - t0, t0=t0, t1=t1,
                           frames=frames, busy_s=busy, kernel_calls=calls.calls)


def breakdown(tr) -> dict:
    """The ten device operations that took most time, and the ten longest
    idle gaps, each named by the innermost host operation running at its
    middle."""
    by_name: Dict[str, float] = {}
    for n, s, e in tr.device_events:
        by_name[n] = by_name.get(n, 0.0) + (e - s)
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    gaps = sorted(yardstick.idle_gaps([(s, e) for _, s, e in tr.device_events], tr.t0, tr.t1),
                  key=lambda g: g[0] - g[1])[:10]
    named = []
    for a, b in gaps:
        mid = (a + b) / 2
        cover = [(e - s, n) for n, s, e in tr.cpu_events if s <= mid <= e]
        named.append([min(cover)[1] if cover else "host idle", b - a])
    return {"device_ops": [[n, v] for n, v in ops], "idle_gaps": named}


def run_cell(res: SimpleNamespace, seed: int, seconds: float, trace: bool, device,
             t_start: float, plant: Optional[Callable] = None) -> dict:
    """One run of a cell on `device`. `plant(port, ctx)`, if given, changes
    the timed path before set-up (the controls and the faults of the tests).
    Returns the result's fields."""
    root = Path.cwd()
    set_cache_dirs(root)
    port = port_modules()
    built_s = None
    if device.type == "cuda":
        port.build.library()
        built_s = port.build.build_seconds
    cfgj, traffic = res.config, res.traffic
    scene = Scene(cfgj["rows"], cfgj["cols"], float(cfgj["fx"]), int(cfgj["orbit_frames_per_turn"]))
    from .reference import check

    ctx = SimpleNamespace(
        port=port, cfg=check.build_config(cfgj, sys.modules["maveric_slam_tpu_torch.config"]),
        cfgfile=cfgj, traffic=traffic, seed=seed, device=device, scene=scene,
        rng=random.Random(seed), params=None, weights=None)
    if plant is not None:
        plant(port, ctx)
    ctx.params = port.superpoint.load_params(ctx.weights, device=device)
    client_mod = load_module(HERE / "clients" / f"{traffic['client']}.py", "slam_bench_client")
    client = client_mod.Client(ctx)
    try:
        return _measure(res, client, ctx, scene, seconds, trace, t_start, built_s)
    finally:
        client.close()


def _measure(res, client, ctx, scene, seconds, trace, t_start, built_s) -> dict:
    import torch
    from .reference import check

    device, port, cfgj, traffic = ctx.device, ctx.port, ctx.cfgfile, ctx.traffic
    scene.render(client.orbit_indices(), device)
    client.warm()
    _sync(device)
    setup_s = time.perf_counter() - t_start

    units: List[tuple] = []
    t_begin = time.perf_counter()
    while time.perf_counter() - t_begin < seconds:
        t0 = time.perf_counter()
        n = client.unit(window=True)
        units.append((t0, time.perf_counter(), n))
    window_s = units[-1][1] - t_begin
    tr = trace_span(client, int(traffic["trace_units"]), device, port) if trace else None
    peak = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0

    out: Dict[str, object] = {}
    run = SimpleNamespace(units=units, window_s=window_s, records=client.records(), trace=tr,
                          config=cfgj, traffic=traffic)
    if not trace:
        lat = yardstick.weighted_values([(b - a, n) for a, b, n in units])
        e2e = {"frames_per_s": sum(n for _, _, n in units) / window_s,
               "frame_ms_p50": yardstick.percentile(lat, 50) * 1e3,
               "frame_ms_p95": yardstick.percentile(lat, 95) * 1e3,
               "setup_s": setup_s}
        out["metrics"] = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]} for m in res.end_to_end}
    else:
        metrics = {}
        for m in res.per_layer:
            v = res.readers[m["name"]].read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        out["metrics"] = metrics
        out["breakdown"] = breakdown(tr)
    out["device_extra"] = {"busy_s": tr.busy_s, "window_s": tr.window_s} if trace else {}
    out["memory_peak_bytes"] = int(peak)
    out["frames"] = sum(n for _, _, n in units)
    walls = sorted(b - a for a, b, _ in units)
    out["window"] = {"units": len(units), "seconds": window_s,
                     "unit_ms_p50_p90_p95_p99_max": [
                         1e3 * yardstick.percentile(walls, q) for q in (50, 90, 95, 99, 100)],
                     "records": {k: len(v) if isinstance(v, list) else v
                                 for k, v in run.records.items()}}
    frames = run.records.get("frames")
    if frames:
        out["window"]["verified_frames"] = sum(1 for f in frames if f[3])
        out["window"]["ba_frames"] = sum(1 for f in frames if f[2])
    out["build_seconds"] = built_s

    # The comparison, once the window has closed and the peak is read.
    tally = check.Tally()
    check.strict_f32()
    client.check(tally, check)
    numbers = tally.numbers()
    out["correct"], out["compared"] = check.judge(numbers, res.limits)
    out["numbers"] = numbers
    out["detail"] = tally.detail()
    return out


def _sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize()


def result_line(out: dict, device_kind: str, count: int) -> dict:
    """The contract's last line: `compared` comes last."""
    dev = {"platform": "gpu", "kind": device_kind, "count": count,
           "memory_peak_bytes": out["memory_peak_bytes"], **out["device_extra"]}
    line = {"correct": bool(out["correct"]), "attempted": out["frames"],
            "failed": 0, "metrics": out["metrics"],
            "device": dev}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["compared"] = out["compared"]
    return line


def comparison_lines(compared: dict) -> List[str]:
    return [f"compared {k} {v['value']!r} limit {v['limit']!r}" for k, v in compared.items()]


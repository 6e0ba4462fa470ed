"""Where each benchmark cell's time goes, by the port's own spans
(maveric_slam_tpu_torch/utils/profiling.py), on the card:

    python tools/torch_span_report.py [--cells NAME ...] [--out build/span_report.json]

from the checkout's root. For each cell of BENCHMARK.json, set up and warmed
by slam_bench's own `harness.run_cell` (seed SEED), whose window and check
this tool replaces:

1. traced: the cell's `trace_units` under torch.profiler, as slam_bench
   traces them (`harness.trace_span`): each span's ms a unit (outermost
   occurrences), the self time of `slam.process`, `slam.consume` and
   `tracker.step` (their time outside every program span inside them), the
   host's synchronising CUDA calls inside each span (by the innermost span
   around them), each traced engine frame's spans, and the ten longest
   device idle gaps named by the innermost program span over their middle
   (beside `harness.breakdown`'s names);
2. recorded: units in alternating blocks with a `Timer.recording()` of the
   spans and without, no profiler (the engine ENGINE_FRAMES frames each
   way, the stream cells STREAM_STEPS steps each way): ms a unit both ways,
   and each span's ms a unit from the recording;
3. profiled: blocks of twice `trace_units` under torch.profiler, in the
   order with, without, without, with the program's spans (without: every
   span the null context): ms a unit each way, the spans' cost when traced;
4. the host's cost of one span: off, under a recording, under the profiler.

`--device cpu --config FILE` rehearses the control flow on the CPU at a
small configuration (no device numbers). Prints one JSON line a cell and
writes them all to --out.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

# One host thread for the CPU math libraries, as slam_bench/run.py sets.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"
ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PREFIXES = ("slam.", "tracker.", "pose_graph.", "pairwise.", "lightglue.")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize", "cudaMemcpy",
              "cudaMemcpyAsync")
SELF = ("slam.process", "slam.consume", "tracker.step")
SEED = 2**33 + 7
ENGINE_FRAMES, STREAM_STEPS = 200, 50  # units each way of the recorded A/B


def _cell(cell: str, device, config: str | None, traffic: dict) -> dict:
    """The cell's report. `harness.run_cell` sets the cell up (its seed
    SEED) and hands the client to `harness._measure`, which is replaced here
    by the scene's render, the client's warm-up (as `_measure` starts) and
    the three measurements."""
    from slam_bench import harness

    res = harness.resolve(json.loads((ROOT / "BENCHMARK.json").read_text()), cell, ROOT)
    if config:
        res.config = json.loads(Path(config).read_text())
    res.traffic.update(traffic)

    def measure(res, client, ctx, scene, *_):
        scene.render(client.orbit_indices(), device)
        client.warm()
        _sync(device)
        units = int(res.traffic["trace_units"])
        engine = res.traffic["client"] == "engine"
        return {"traced": _analyse(_trace(client, units, device, ctx.port), units),
                "recorded": _record(client, device, ENGINE_FRAMES if engine else STREAM_STEPS),
                "profiled": _profiled(client, device, 2 * units)}

    saved, harness._measure = harness._measure, measure
    try:
        return harness.run_cell(res, SEED, 0.0, False, device, time.perf_counter())
    finally:
        harness._measure = saved


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize()


def _trace(client, units: int, device, port):
    """The traced span: `harness.trace_span` on a card; on the CPU the same
    units under a CPU-only profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from slam_bench import harness

    if device.type == "cuda":
        return harness.trace_span(client, units, device, port)
    frames = 0
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function("slam_bench.traced"):
            for _ in range(units):
                frames += client.unit(window=False)
    _, cpu, (t0, t1) = harness._kineto_events(prof)
    return SimpleNamespace(device_events=[], cpu_events=cpu, window_s=t1 - t0, t0=t0, t1=t1,
                           frames=frames, busy_s=0.0)


def _innermost(events, t):
    """The shortest event of `events` (name, start, end) covering t."""
    cover = [(e - s, n) for n, s, e in events if s <= t <= e]
    return min(cover)[1] if cover else None


def _analyse(tr, units: int) -> dict:
    from slam_bench import harness, spans, yardstick

    prog = [ev for ev in tr.cpu_events if ev[0].startswith(PREFIXES) and ev[2] > tr.t0 and ev[1] < tr.t1]
    names = sorted({n for n, _, _ in prog})
    ms = {n: 1e3 * spans.seconds(tr, n) / units for n in names}
    counts = {n: spans.count(tr, n) for n in names}
    self_ms = {}
    for name in SELF:
        total = 0.0
        for s, e in spans.occurrences(tr, name):
            inner = [(max(a, s), min(b, e)) for n, a, b in prog
                     if n != name and a >= s and b <= e]
            total += (e - s) - yardstick.interval_union_s(inner)
        if counts.get(name):
            self_ms[name] = 1e3 * total / units
    syncs = {}
    for n, s, e in tr.cpu_events:
        if n in SYNC_CALLS and tr.t0 < s < tr.t1:
            owner = _innermost(prog, (s + e) / 2) or "(no span)"
            k = syncs.setdefault(owner, {})
            k.setdefault(n, [0, 0.0])
            k[n][0] += 1
            k[n][1] += 1e3 * (e - s) / units
    # The ten longest gaps in `harness.breakdown`'s order, beside its names.
    bd = harness.breakdown(tr) if tr.device_events else {"device_ops": None, "idle_gaps": []}
    gaps = sorted(yardstick.idle_gaps([(s, e) for _, s, e in tr.device_events], tr.t0, tr.t1),
                  key=lambda g: g[0] - g[1])[:10] if tr.device_events else []
    named_gaps = [[_innermost(prog, (a + b) / 2), name, 1e3 * (b - a)]
                  for (a, b), (name, _) in zip(gaps, bd["idle_gaps"])]
    frames = []
    for s, e in spans.occurrences(tr, "slam.process"):
        inside = {}
        for n, a, b in prog:
            if a >= s and b <= e and n != "slam.process":
                inside[n] = inside.get(n, 0.0) + 1e3 * (b - a)
        frames.append({"ms": 1e3 * (e - s), "spans": inside})
    return {"units": units, "frames": tr.frames, "window_ms": 1e3 * tr.window_s,
            "busy_ms": 1e3 * tr.busy_s, "span_ms_per_unit": ms, "span_counts": counts,
            "self_ms_per_unit": self_ms, "syncs_count_ms_per_unit": syncs, "idle_gaps": named_gaps,
            "device_ops": bd["device_ops"],
            "engine_frames": frames}


def _record(client, device, units: int, blocks: int = 4) -> dict:
    """Alternating blocks of units without and with a Timer's recording."""
    from maveric_slam_tpu_torch.utils import profiling

    timer = profiling.Timer()
    walls = {"off": [], "on": []}
    for b in range(blocks):
        mode = "on" if b % 2 else "off"
        for _ in range(units // (blocks // 2)):
            t0 = time.perf_counter()
            if mode == "on":
                with timer.recording():
                    client.unit(window=False)
            else:
                client.unit(window=False)
            _sync(device)
            walls[mode].append(time.perf_counter() - t0)
    n_on = len(walls["on"])
    return {"ms_per_unit_off": 1e3 * sum(walls["off"]) / len(walls["off"]),
            "ms_per_unit_on": 1e3 * sum(walls["on"]) / n_on,
            "median_ms_off": 1e3 * sorted(walls["off"])[len(walls["off"]) // 2],
            "median_ms_on": 1e3 * sorted(walls["on"])[n_on // 2],
            "units_each_way": n_on,
            "span_ms_per_unit": {n: 1e3 * v / n_on for n, v in sorted(timer.totals.items())},
            "span_counts": dict(sorted(timer.counts.items()))}


def _profiled(client, device, units: int) -> dict:
    """ms a unit under torch.profiler with the program's spans and with
    none, in blocks of `units` in the order with, without, without, with."""
    from torch.profiler import ProfilerActivity, profile

    from maveric_slam_tpu_torch.utils import profiling

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    span = profiling.span
    blocks = {"spans": [], "no_spans": []}
    try:
        for mode in ("spans", "no_spans", "no_spans", "spans"):
            profiling.span = span if mode == "spans" else (lambda name: profiling._NULL)
            with profile(activities=acts):
                _sync(device)
                t0 = time.perf_counter()
                for _ in range(units):
                    client.unit(window=False)
                _sync(device)
                blocks[mode].append(1e3 * (time.perf_counter() - t0) / units)
    finally:
        profiling.span = span
    return {"ms_per_unit_spans": sum(blocks["spans"]) / 2,
            "ms_per_unit_no_spans": sum(blocks["no_spans"]) / 2,
            "blocks_ms_per_unit": blocks, "units_a_block": units}


def _span_cost_us(n: int = 20000) -> dict:
    import torch

    from maveric_slam_tpu_torch.utils import profiling

    def loop():
        t0 = time.perf_counter()
        for _ in range(n):
            with profiling.span("x"):
                pass
        return 1e6 * (time.perf_counter() - t0) / n

    out = {"off": loop()}
    with profiling.Timer().recording():
        out["recording"] = loop()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out["profiler"] = loop()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", nargs="*", default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default=None, help="a configuration file in place of the cell's")
    ap.add_argument("--traffic", default="{}", help="JSON: traffic parameters to override")
    ap.add_argument("--out", default=str(ROOT / "build" / "span_report.json"))
    args = ap.parse_args(argv)

    import torch

    torch.set_num_threads(1)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_span_report: no CUDA device", file=sys.stderr)
        return 3
    cells = args.cells or [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
    report = {"device": torch.cuda.get_device_name(0) if device.type == "cuda" else "cpu (no device numbers)",
              "span_cost_us": _span_cost_us(), "cells": {}}
    print(json.dumps({"span_cost_us": report["span_cost_us"]}), flush=True)
    for cell in cells:
        out = report["cells"][cell] = _cell(cell, device, args.config, json.loads(args.traffic))
        line = {k: v for k, v in out["traced"].items() if k != "engine_frames"}
        print(json.dumps({"cell": cell, "traced": line, "recorded": out["recorded"],
                          "profiled": out["profiled"]}), flush=True)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(report, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

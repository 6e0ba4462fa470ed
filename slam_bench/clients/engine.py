"""One camera through `SlamSystem.process`, closed loop: the next frame is
submitted when the previous frame's pose is on the host (fetch_delay 0).

The camera ping-pongs over the first `images` orbit frames, so it revisits
places and the backend closes loops. The first `warm_frames` frames warm
the engine (its first window BA, loop verification and pose graph); the
window continues the same engine.

Traffic parameters: images, ba_every, loop_closure, fetch_delay,
warm_frames, sample_frames (frames the reference checks, drawn from the
seed over the window, besides the first step), sample_ba and sample_pg
(window BA and pose-graph solves of the window that the reference
re-solves, drawn from the seed), trace_units (frames under the profiler).
"""

from __future__ import annotations

import time

import torch

from slam_bench.clients.streams import RESULT_FIELDS
from slam_bench.harness import Reservoir
from slam_bench.scene import ping_pong


class Client:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.images_n = int(t["images"])
        self.ba_every = int(t["ba_every"])
        self.warm_frames = int(t["warm_frames"])
        self.frame = 0
        self.system = None
        self.walls = []  # (frame index, seconds, dispatched a BA, verified a loop)
        self.sample = Reservoir(int(t["sample_frames"]), ctx.rng)
        self.ba_solves = Reservoir(int(t["sample_ba"]), ctx.rng)
        self.pg_solves = Reservoir(int(t["sample_pg"]), ctx.rng)
        self.first = None
        self.last = None
        self.pg_warm = None  # the warm-up's last pose-graph solve
        self.window = False
        self._hook()

    def _hook(self) -> None:
        """Keeps each frame's step result, and the window's BA and pose-graph
        problems with their solutions, for the reference (references only:
        nothing is copied or waited for)."""
        port, drv = self.ctx.port, self
        step_fn, ba_fn, pg_fn = port.tracker.track_step, port.ba.bundle_adjust, port.pose_graph.optimize

        def track_step(*a, **kw):
            state, res = step_fn(*a, **kw)
            drv.last = {k: getattr(res, k)[None] for k in RESULT_FIELDS}
            return state, res

        def bundle_adjust(problem, *a, **kw):
            solved, stats = ba_fn(problem, *a, **kw)
            if drv.window:
                drv.ba_solves.offer(({k: getattr(problem, k) for k in BA_FIELDS},
                                     {"R": solved.R, "t": solved.t}))
            return solved, stats

        def optimize(graph, *a, **kw):
            opt, costs = pg_fn(graph, *a, **kw)
            solve = (graph._asdict(), {"R": opt.R, "t": opt.t})
            if drv.window:
                drv.pg_solves.offer(solve)
            else:
                drv.pg_warm = solve
            return opt, costs

        port.tracker.track_step = track_step
        port.ba.bundle_adjust = bundle_adjust
        port.pose_graph.optimize = optimize

        def unhook():
            port.tracker.track_step = step_fn
            port.ba.bundle_adjust = ba_fn
            port.pose_graph.optimize = pg_fn

        self._unhook = unhook
        self._pg_optimize = pg_fn

    def close(self) -> None:
        self._unhook()

    def orbit_indices(self):
        return range(self.images_n)

    def image(self, k: int) -> torch.Tensor:
        return self.ctx.scene.inputs([ping_pong(k, self.images_n)], self.ctx.seed, k)

    def warm(self) -> None:
        ctx = self.ctx
        t = ctx.traffic
        self.system = ctx.port.slam.SlamSystem(
            ctx.params, ctx.cfg, seed=engine_seed(ctx.seed), ba_every=self.ba_every,
            enable_loop_closure=bool(t["loop_closure"]), fetch_delay=int(t["fetch_delay"]),
            device=ctx.device)
        for _ in range(self.warm_frames):
            self.unit(window=False)
        # The window must not pay the linear solver's first call, which the
        # warm-up reaches only where a loop correction passed its gate.
        pg, dev = ctx.port.pose_graph, ctx.device
        eye = torch.eye(3, device=dev).repeat(8, 1, 1)
        z = torch.zeros(8, dtype=torch.int64, device=dev)
        self._pg_optimize(pg.PoseGraph(R=eye, t=torch.zeros(8, 3, device=dev), edge_i=z, edge_j=z + 1,
                                       R_meas=eye, t_meas=torch.zeros(8, 3, device=dev),
                                       weight=torch.ones(8, device=dev)), iterations=1)

    def unit(self, window: bool) -> int:
        k = self.frame
        img = self.image(k)[0].cpu().numpy()
        sys_ = self.system
        prev = sys_.state
        v0 = sys_.verifications
        self.window = window
        t0 = time.perf_counter()
        sys_.process(img)
        wall = time.perf_counter() - t0
        self.frame = k + 1
        if k == 0:
            return 1
        keep = (k, _prev_fields(prev), _grid_fields(sys_.state), self.last)
        if k == 1:
            self.first = keep
        if window:
            is_ba = k >= 3 and k % self.ba_every == 0
            self.walls.append((k, wall, is_ba, sys_.verifications > v0))
            self.sample.offer(keep)
        return 1

    def records(self) -> dict:
        return {"frames": self.walls, "ba_solves": self.ba_solves.seen,
                "pg_solves": self.pg_solves.seen}

    def check(self, tally, check) -> None:
        ctx = self.ctx
        samples = [self.first] + sorted(self.sample.items, key=lambda k: k[0])
        self.system = None
        rcfg = check.build_config(ctx.cfgfile)
        rparams = check.load_params(ctx.device)
        noise = check.replay_noise([engine_seed(ctx.seed)], [k[0] for k in samples], rcfg, ctx.device)
        for k, prev, grid, res in samples:
            ref_new, _, ref_res = check.follow_step(
                rparams, rcfg, self.image(k - 1), self.image(k), None if k == 1 else prev,
                res["cells_new"], noise[k], ctx.device)
            tally.grids(grid, ref_new)
            tally.result(res, ref_res)
        # Every fourth frame dispatches a window BA: a window without one
        # misses all of its work. The pose graph runs only where a loop edge
        # disagrees with the trajectory by the gate: a window with no solve
        # has the warm-up's last one compared.
        if not self.ba_solves.items:
            tally.backend_missing("ba_gap")
        for problem, solved in self.ba_solves.items:
            tally.ba(problem, solved, rcfg, ctx.device)
        for graph, solved in self.pg_solves.items or [s for s in [self.pg_warm] if s]:
            tally.pg(graph, solved, ctx.device)


BA_FIELDS = ("R", "t", "X", "uv", "mask")


def engine_seed(seed: int) -> int:
    """The engine's tracker seed (its verifications draw from seed + 1)."""
    return int(seed) % (1 << 62)


def _prev_fields(state) -> dict:
    return {k: getattr(state, k)[None] for k in ("depth", "depth_valid", "scale", "prev_R", "prev_t")}


def _grid_fields(state) -> dict:
    return {k: getattr(state, k)[None] for k in ("desc", "probs", "indices", "xy")}

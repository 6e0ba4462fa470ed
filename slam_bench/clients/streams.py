"""S independent camera streams through `track_step_batched`, closed loop.

A step submits one frame of every stream and is done when all S poses are
on the host; the next step is submitted then. Stream s starts at orbit
phase `phase_step` x s and moves one orbit frame a step. Step 0 starts the
streams (`init_states_batched`), the next `warm_steps` steps warm up.

Traffic parameters: streams, phase_step, warm_steps, sample_steps (steps
the reference checks, drawn from the seed over the window, besides the
first step), trace_units (steps under the profiler).
"""

from __future__ import annotations

import time

import torch

from slam_bench.harness import Reservoir


class Client:
    def __init__(self, ctx):
        self.ctx = ctx
        t = ctx.traffic
        self.S, self.phase = int(t["streams"]), int(t["phase_step"])
        self.warm_steps = int(t["warm_steps"])
        self.step = 0
        self.states = None
        self.dispatch_s = []
        self.sample = Reservoir(int(t["sample_steps"]), ctx.rng)
        self.first = None

    def orbit_indices(self):
        return range(self.ctx.scene.n)

    def images(self, step: int) -> torch.Tensor:
        return self.ctx.scene.inputs([self.phase * s + step for s in range(self.S)],
                                     self.ctx.seed, step)

    def warm(self) -> None:
        trk = self.ctx.port.tracker
        self.states = trk.init_states_batched(self.ctx.params, self.images(0), self.ctx.cfg)
        for _ in range(self.warm_steps):
            self.unit(window=False)

    def unit(self, window: bool) -> int:
        trk, ctx = self.ctx.port.tracker, self.ctx
        j = self.step + 1
        images = self.images(j)
        prev = self.states
        t0 = time.perf_counter()
        states, res = trk.track_step_batched(ctx.params, prev, images, ctx.cfg)
        t1 = time.perf_counter()
        torch.cat([res.R.reshape(self.S, 9), res.t], 1).cpu()  # the poses on the host
        self.states, self.step = states, j
        keep = (j, _prev_fields(prev), _grid_fields(states), _result_fields(res))
        if j == 1:
            self.first = keep
        if window:
            self.dispatch_s.append(t1 - t0)
            self.sample.offer(keep)
        return self.S

    def close(self) -> None:
        pass

    def records(self) -> dict:
        return {"dispatch_s": self.dispatch_s, "streams": self.S}

    def check(self, tally, check) -> None:
        """The reference on the first step and on the sampled steps."""
        ctx = self.ctx
        samples = [self.first] + sorted(self.sample.items, key=lambda k: k[0])
        self.states = None
        rcfg = check.build_config(ctx.cfgfile)
        rparams = check.load_params(ctx.device)
        noise = check.replay_noise(list(range(self.S)), [k[0] for k in samples], rcfg, ctx.device)
        for j, prev, grid, res in samples:
            ref_new, _, ref_res = check.follow_step(
                rparams, rcfg, self.images(j - 1), self.images(j), None if j == 1 else prev,
                res["cells_new"], noise[j], ctx.device)
            tally.grids(grid, ref_new)
            tally.result(res, ref_res)


def _prev_fields(state) -> dict:
    return {k: getattr(state, k) for k in ("depth", "depth_valid", "scale", "prev_R", "prev_t")}


def _grid_fields(state) -> dict:
    return {k: getattr(state, k) for k in ("desc", "probs", "indices", "xy")}


def _result_fields(res) -> dict:
    return {k: getattr(res, k) for k in RESULT_FIELDS}


RESULT_FIELDS = ("R", "t", "cells_new", "match_score", "depth_top", "depth_top_ok")

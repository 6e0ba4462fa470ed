"""Relocalisation: one query frame a call, matched by LightGlue against the
keyframes that place retrieval shortlisted, through the port's batched
pairwise path; closed loop, one call in flight.

The scene is the benchmark's orbit with the room, the orbit and the
camera's positions `room_scale` times larger (the configuration's key):
every frame has the same geometry and a texture `room_scale` times finer,
so that SuperPoint keeps K = max_keypoints keypoints in every frame, as it
does on a KITTI frame. The database is the orbit's frames,
`database_keyframes` of them.

At set-up the golden features of every orbit frame, rendered with the
run's noise at unit 0, are extracted through the port
(`pairwise.extract_features`) and kept on the device as the keyframe
database, and LightGlue is built from the configuration's `lightglue`
block, its weights drawn from `weights_seed`. Call c (1, 2, ...) takes
orbit frame c mod n as the query, with noise from (seed, c), extracts its
golden features through the port, and matches it against the database
keyframes at the orbit offsets `offsets` with
`pairwise.pairwise_pose_batched` (P = len(offsets) pairs, the query on side
0; RANSAC's noise from a generator seeded from (seed, c), `ransac_seed`).
The call is done when the P poses, inlier counts and valid flags are on
the host, and delivers one frame: the query localised.

With LightGlue's weights drawn at random no match passes its filter, so
every pair is marked not valid and RANSAC runs on no matches; `check`
holds the filter's mutual argmax before its threshold to the reference.

Traffic parameters: offsets, warm_calls, sample_calls (calls the reference
checks, drawn from the seed over the window, besides the first call),
trace_units (calls under the profiler).
"""

from __future__ import annotations

import dataclasses
import sys
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from slam_bench.harness import Reservoir
from slam_bench.scene import RENDER_THREADS, render_box_room, unit_seed

RANSAC_SALT = 0x2545F4914F6CDD1D  # keeps RANSAC's generator apart from the image noise's
DB_BLOCK = 32  # database frames extracted at once
ROOM = (15.0, 3.0, 15.0)  # render_box_room's room: its half extents in metres


def render_scaled(scene, scale: float, indices, device) -> None:
    """`Scene.render` with the room and the camera's positions `scale`
    times larger: the same frames, the texture's cells `scale` times
    finer."""
    idx = sorted({int(k) % scene.n for k in indices})

    def one(k):
        T = scene.poses[k].copy()
        T[:3, 3] *= scale
        return render_box_room(scene.K, T, scene.h, scene.w, half_extent=tuple(scale * e for e in ROOM))

    with ThreadPoolExecutor(RENDER_THREADS) as pool:
        imgs = list(pool.map(one, idx))
    scene.slot = {k: i for i, k in enumerate(idx)}
    scene.frames = torch.from_numpy(np.stack(imgs)).to(device)


def ransac_seed(seed: int, call: int) -> int:
    return unit_seed(seed, call) ^ RANSAC_SALT


class Client:
    def __init__(self, ctx):
        # The program's LightGlue and batched pairwise path: a program that
        # lacks them fails here, before any set-up.
        from maveric_slam_tpu_torch import config as pconfig
        from maveric_slam_tpu_torch.frontend import pairwise
        from maveric_slam_tpu_torch.models import lightglue

        self.ctx, self.pairwise = ctx, pairwise
        t, block = ctx.traffic, ctx.cfgfile["lightglue"]
        self.offsets = [int(o) for o in t["offsets"]]
        self.P = len(self.offsets)
        self.warm_calls = int(t["warm_calls"])
        fields = {f.name for f in dataclasses.fields(pconfig.LightGlueConfig)}
        lgcfg = pconfig.LightGlueConfig(**{k: v for k, v in block.items() if k in fields})
        self.model = lightglue.LightGlue(lgcfg, ctx.device)
        self._check_sizes(block)
        if int(ctx.cfgfile["database_keyframes"]) != ctx.scene.n:
            raise ValueError("the database is the orbit's frames: database_keyframes must equal "
                             "orbit_frames_per_turn")
        scene, scale = ctx.scene, float(ctx.cfgfile["room_scale"])
        scene.render = lambda indices, device: render_scaled(scene, scale, indices, device)
        self.call = 0
        self.db = None
        self.cand = None
        self.sample = Reservoir(int(t["sample_calls"]), ctx.rng)
        self.first = None
        self.pairs = self.pairs_8 = 0  # window pairs, and those with >= sample_size matches

    def _check_sizes(self, block: dict) -> None:
        """The sizes the configuration states are those of the model run."""
        W, d = self.model.weights, int(block["descriptor_dim"])
        run = {"input_dim": W["transformers.0.self_attn.Wqkv.weight"].shape[1],
               "descriptor_dim": W["transformers.0.self_attn.out_proj.weight"].shape[0],
               "n_layers": sum(1 for k in W if k.endswith("self_attn.Wqkv.weight")),
               "num_heads": self.model.config.num_heads,
               "head_dim": d // self.model.config.num_heads,
               "mlp_dim": W["transformers.0.self_attn.ffn.0.weight"].shape[0],
               "add_scale_ori": W["posenc.Wr.weight"].shape[1] != 2}
        for k, v in run.items():
            if block[k] != v:
                raise ValueError(f"lightglue.{k} is {block[k]} in the file and {v} as run")

    def orbit_indices(self):
        return range(self.ctx.scene.n)

    def _db_images(self) -> torch.Tensor:
        return self.ctx.scene.inputs(list(self.orbit_indices()), self.ctx.seed, 0)

    def warm(self) -> None:
        ctx, n = self.ctx, self.ctx.scene.n
        images = self._db_images()
        parts = [self.pairwise.extract_features(ctx.params, images[i:i + DB_BLOCK], ctx.cfg)
                 for i in range(0, n, DB_BLOCK)]
        del images
        self.db = type(parts[0])(*(torch.cat(f) for f in zip(*parts)))
        self.cand = torch.tensor([[(q + o) % n for o in self.offsets] for q in range(n)],
                                 device=ctx.device)
        for _ in range(self.warm_calls):
            self.unit(window=False)

    def query_image(self, call: int) -> torch.Tensor:
        return self.ctx.scene.inputs([call % self.ctx.scene.n], self.ctx.seed, call)

    def unit(self, window: bool) -> int:
        ctx, pw = self.ctx, self.pairwise
        c = self.call + 1
        q = c % ctx.scene.n
        fq = pw.extract_features(ctx.params, self.query_image(c), ctx.cfg)
        idx = self.cand[q]
        f0 = type(fq)(*(f.expand(self.P, *f.shape[1:]) for f in fq))
        f1 = type(fq)(*(f[idx] for f in self.db))
        gen = torch.Generator(device=ctx.device).manual_seed(ransac_seed(ctx.seed, c))
        res = pw.pairwise_pose_batched(f0, f1, ctx.cfg, self.model, generator=gen)
        host = torch.cat([res.R.reshape(self.P, 9), res.t, res.num_inliers[:, None].float(),
                          res.valid[:, None].float(), res.num_matches[:, None].float()], 1).cpu()
        self.call = c
        keep = (c, fq, idx, res)
        if c == 1:
            self.first = keep
        if window:
            self.sample.offer(keep)
            self.pairs += self.P
            self.pairs_8 += int((host[:, -1] >= ctx.cfg.ransac.sample_size).sum())
        return 1

    def close(self) -> None:
        pass

    def records(self) -> dict:
        return {"pairs": self.pairs, "pairs_with_sample_size_matches": self.pairs_8,
                "counters": self.model.counters}

    def check(self, tally, check) -> None:
        """The reference on the first call and on the sampled calls."""
        from slam_bench.reference import lightglue as rlg
        from slam_bench.reference.frozen.frontend import extractor as rext

        ctx = self.ctx
        block = ctx.cfgfile["lightglue"]
        rcfg = check.build_config(ctx.cfgfile)
        rparams = check.load_params(ctx.device)
        W = {k: v.to(ctx.device) for k, v in rlg.init_weights(
            int(block["n_layers"]), int(block["descriptor_dim"]), int(block["num_heads"]),
            int(block["weights_seed"])).items()}
        size = (rcfg.frontend.width, rcfg.frontend.height)
        db_images = self._db_images()
        samples = [self.first] + sorted(self.sample.items, key=lambda k: k[0])
        decided = mutual = slots = 0
        for c, fq, idx, res in samples:
            ref_q = rext.extract_golden(rparams, self.query_image(c)[0], rcfg)
            ref_c = [rext.extract_golden(rparams, db_images[int(k)], rcfg) for k in idx.tolist()]
            prog = {"q_xy": fq.xy[0], "q_desc": fq.desc[0], "q_mask": fq.mask[0],
                    "c_xy": self.db.xy[idx], "c_desc": self.db.desc[idx], "c_mask": self.db.mask[idx],
                    "matches": res.matches, "mutual": res.mutual, "num_matches": res.num_matches,
                    "R": res.R, "log_assignment": res.log_assignment}
            d, m = rlg.compare_call(tally, prog, ref_q, ref_c, W, block, size, rcfg,
                                    ransac_seed(ctx.seed, c), ctx.device)
            decided, mutual = decided + d, mutual + m
            slots += len(idx) * int(ref_q.mask.sum())
        print(f"reloc: {len(samples)} calls checked, {decided} of {slots} query slots with a "
              f"decided mutual argmax, {mutual} of them mutual", file=sys.stderr)

"""The comparison that decides `correct`: what the timed path produced,
against the frozen plain reference (`reference/frozen`), at the timed sizes.

Each number is a gap between the program's answer and the reference's on
the same inputs, which the benchmark made from the run's seed:

- `desc_diff`, `idx_diff`: int8 descriptor entries and detector winners
  that differ over the sampled frames' whole cell grids (the int8 net and
  the detector on exact integers: 0 in a sound run);
- `prob_gap`, `xy_gap_px`: the widest gap of a cell's winner probability
  and sub-pixel keypoint;
- `top_diff`: the program's top-N cells that the reference did not select;
- `score_gap`: the widest gap of a selected feature's match score;
- `pose_gap_deg`: the median over sampled steps of the larger of the
  angle between the two rotations and the angle between the two
  translation directions. The reference follows the program from the
  program's own state: it extracts both frames itself, draws the step's
  RANSAC noise from its own generator seeded as the program's, and takes
  only the previous step's depth map, scale and fallback pose from the
  program's state. The first step of a run, which has no such state, is
  followed from the reference's own start;
- `depth_gap`: the median over sampled steps of the median relative gap
  of the depths the step wrote for its selected features, over features
  both sides wrote;
- `pose_rot_deg_3rd`: the third largest, over every sampled (step,
  stream) pair, of the angle between the two rotations alone. Rotation
  is the part of a pose that sound runs reproduce in every slot (the
  translation's direction swings when RANSAC keeps another inlier set);
  a fault in one stream, or on one step in four, turns several pairs;
- `ba_gap`, `pg_gap` (the engine): the median over sampled solves of the
  window BA and of the loop correction's pose graph of the share of a
  re-solve's correction that the program's poses miss: the root-sum-square
  over the solve's poses of the rotation gap (radians) and the
  camera-centre gap between the program's poses and the re-solve's, over
  the same between the solve's input poses and the re-solve's. A solve
  that returns its input reads 1; a solve whose re-solve moves nothing is
  left out. The re-solve starts from the problem the program posed (its
  window poses, landmarks and tracks; its trajectory and loop edges),
  which is the program's own state, with the solver settings that the
  configuration states. The pose graph is re-solved in float64. The BA is
  re-solved in float32, the precision the configuration states: its
  damping is fixed, so a step rejected once is rejected again, and
  whether float32 rounding rejects a step decides whether a solve moves
  at all (against a float64 re-solve, sound runs read a median of up to
  1 over their solves).

Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch

from .frozen import config as rconfig
from .frozen.backend import ba as rba
from .frozen.backend import pose_graph as rpg
from .frozen.frontend import extractor as rext
from .frozen.frontend import tracker as rtrk
from .frozen.geometry import ransac as rransac
from .frozen.models import superpoint as rsp

EXTRACT_BLOCK = 4  # frames a reference extraction holds at once
BA_ANCHORS = 2  # the engine's window BA pins its first two poses: the gauge and the scale
PG_ITERATIONS = 8  # the engine's loop correction runs 8 LM iterations
NO_CORRECTION = 1e-9  # a re-solve that moves the poses less has nothing to compare


def build_config(cfg: dict, mod=rconfig):
    """The SlamConfig of a configuration file, from `mod` (the port's config
    module or the frozen copy): DEFAULT_CONFIG at the file's frame size,
    with the orbit's camera and RANSAC's threshold of 3 px at its focal
    length. Raises where a stated value differs from the one run."""
    import dataclasses

    d = mod.DEFAULT_CONFIG
    h, w, f = cfg["rows"], cfg["cols"], float(cfg["fx"])
    cam = mod.CameraConfig(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h)
    out = dataclasses.replace(
        d, camera=cam, frontend=dataclasses.replace(d.frontend, height=h, width=w),
        ransac=dataclasses.replace(d.ransac, inlier_thresh=3.0 / f))
    stated = {
        "top_n": out.frontend.top_n, "max_keypoints": out.frontend.max_keypoints,
        "num_hypotheses": out.ransac.num_hypotheses, "sample_size": out.ransac.sample_size,
        "ba_num_poses": out.ba.num_poses, "ba_max_landmarks": out.ba.max_landmarks,
        "ba_max_iterations": out.ba.max_iterations, "vocab_base_nodes": out.loop.num_base_nodes,
        "vocab_words_per_node": out.loop.words_per_base_node,
        "lcd_ring_frames": out.loop.max_db_frames, "exp_taylor_degree": out.frontend.exp_taylor_degree,
    }
    for k, v in stated.items():
        if cfg[k] != v:
            raise ValueError(f"{cfg['name']}: {k} is {cfg[k]} in the file and {v} as run")
    return out


def load_params(device, path: Optional[str] = None):
    return rsp.load_params(path, device=device)


def extract(params, images: torch.Tensor, cfg):
    """The reference's features of (n, H, W) images, in blocks."""
    parts = [rext.extract_quantized_batched(params, images[i:i + EXTRACT_BLOCK], cfg)
             for i in range(0, images.shape[0], EXTRACT_BLOCK)]
    top = rext.st.TopN(*(torch.cat(f) for f in zip(*(p.top for p in parts))))
    return rext.QuantizedFeatures(
        *(torch.cat([getattr(p, n) for p in parts]) for n in ("semi_q", "desc_q", "probs", "indices", "xy")),
        top, parts[0].semi_scale, parts[0].desc_scale)


def replay_noise(seeds: List[int], steps: List[int], cfg, device) -> Dict[int, tuple]:
    """Each stream's RANSAC noise at the given steps (1 = the first step
    after the start), drawn as the program draws it: a generator seeded
    with the stream's seed, two draws a step."""
    n, hyp = cfg.frontend.top_n, cfg.ransac.num_hypotheses
    lo = rransac.lo_hypotheses(hyp)
    gens = [torch.Generator(device=device).manual_seed(int(s)) for s in seeds]
    want, out = set(steps), {}
    for j in range(1, max(steps) + 1):
        draws = [(rransac.gumbel((hyp, n), g, device), rransac.gumbel((lo, n), g, device)) for g in gens]
        if j in want:
            out[j] = (torch.stack([d[0] for d in draws]), torch.stack([d[1] for d in draws]))
    return out


def strict_f32() -> None:
    """The reference's float32 products stay true float32, whatever the
    program's run switched on."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _angle_deg(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The angle between vectors, by atan2 (well conditioned near 0)."""
    a, b = a.astype(np.float64), b.astype(np.float64)
    return np.degrees(np.arctan2(np.linalg.norm(np.cross(a, b), axis=-1), np.sum(a * b, -1)))


def _rot_deg(R: np.ndarray, R_ref: np.ndarray) -> np.ndarray:
    """The angle of R^T R_ref, by atan2 of its skew and symmetric parts."""
    M = np.einsum("...ji,...jk->...ik", R.astype(np.float64), R_ref.astype(np.float64))
    skew = np.linalg.norm(M - np.swapaxes(M, -1, -2), axis=(-2, -1)) / (2.0 * np.sqrt(2.0))
    return np.degrees(np.arctan2(skew, (np.trace(M, axis1=-2, axis2=-1) - 1.0) / 2.0))


def _missed_share(R, c, R_ref, c_ref, R_in, c_in) -> Optional[float]:
    """The share of the correction (input -> reference) that the program's
    poses (R, c) miss, over all poses of a solve; None where the reference
    moved nothing."""
    def rss(Ra, ca, Rb, cb):
        rot = np.radians(_rot_deg(Ra, Rb))
        return float(np.sqrt(np.sum(rot ** 2) + np.sum((ca.astype(np.float64) - cb) ** 2)))

    corr = rss(R_in, c_in, R_ref, c_ref)
    return None if corr < NO_CORRECTION else rss(R, c, R_ref, c_ref) / corr


def _np64(x) -> np.ndarray:
    return x.detach().cpu().double().numpy()


def resolve_ba(problem: dict, cfg, device, dtype=torch.float32):
    """The re-solve of a window BA problem (R, t, X, uv, mask as the
    program posed it), with the configuration's solver settings."""
    K = torch.from_numpy(cfg.working_camera.K).to(device, dtype)
    prob = rba.BAProblem(K=K, **{k: problem[k].to(device, dtype) for k in ("R", "t", "X", "uv")},
                         mask=problem["mask"].to(device))
    solved, _ = rba.bundle_adjust(prob, iterations=cfg.ba.max_iterations, damping=cfg.ba.lm_damping,
                                  huber_delta=cfg.ba.huber_delta, num_anchored=BA_ANCHORS)
    return solved.R, solved.t


def resolve_pg(graph: dict, device):
    """The float64 re-solve of a pose graph as the program posed it."""
    g = rpg.PoseGraph(**{k: v.to(device, torch.float64 if v.is_floating_point() else v.dtype)
                         for k, v in graph.items()})
    opt, _ = rpg.optimize(g, iterations=PG_ITERATIONS)
    return opt.R, opt.t


def _centres(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Camera centres of camera-from-world poses."""
    return -np.einsum("pji,pj->pi", R, t)


class Tally:
    """The numbers compared, gathered over the samples."""

    def __init__(self):
        self.counts = {"desc_diff": 0, "idx_diff": 0}
        self.maxima = {"prob_gap": 0.0, "xy_gap_px": 0.0}
        self.top_diff = None
        self.score_gap = None
        self.pose: List[float] = []
        self.pose_rot: List[float] = []
        self.pose_dir: List[float] = []
        self.depth: List[float] = []
        self.backend: Dict[str, List[Optional[float]]] = {}

    def ba(self, problem: dict, solved: dict, cfg, device) -> None:
        """One window BA: the program's poses against the re-solve."""
        R_ref, t_ref = (_np64(x) for x in resolve_ba(problem, cfg, device))
        R, t = _np64(solved["R"]), _np64(solved["t"])
        R_in, t_in = _np64(problem["R"]), _np64(problem["t"])
        self.backend.setdefault("ba_gap", []).append(_missed_share(
            R, _centres(R, t), R_ref, _centres(R_ref, t_ref), R_in, _centres(R_in, t_in)))

    def pg(self, graph: dict, solved: dict, device) -> None:
        """One pose-graph solve (world-from-camera poses) against the
        float64 re-solve."""
        R_ref, t_ref = (_np64(x) for x in resolve_pg(graph, device))
        self.backend.setdefault("pg_gap", []).append(_missed_share(
            _np64(solved["R"]), _np64(solved["t"]), R_ref, t_ref, _np64(graph["R"]), _np64(graph["t"])))

    def backend_missing(self, name: str) -> None:
        """A solver that the window must drive and did not: the whole of
        its correction is missed."""
        self.backend[name] = [1.0]

    def grids(self, prog: dict, ref) -> None:
        """prog: desc (n, C, 256) int8, probs, indices, xy of the program's
        cell grids; ref: the reference's features of the same frames."""
        n = prog["desc"].shape[0]
        self.counts["desc_diff"] += int((prog["desc"].reshape(n, -1) != ref.desc_q.reshape(n, -1)).sum())
        pi, ri = prog["indices"].reshape(n, -1), ref.indices.reshape(n, -1)
        self.counts["idx_diff"] += int((pi != ri).sum())
        gap = (prog["probs"].reshape(n, -1) - ref.probs.reshape(n, -1)).abs().max()
        self.maxima["prob_gap"] = max(self.maxima["prob_gap"], float(gap))
        xy = (prog["xy"].reshape(n, -1, 2) - ref.xy.reshape(n, -1, 2)).abs().max()
        self.maxima["xy_gap_px"] = max(self.maxima["xy_gap_px"], float(xy))

    def selection(self, cells: np.ndarray, scores: np.ndarray, ref_cells: np.ndarray,
                  ref_scores: np.ndarray) -> None:
        """Top-N cells (S, N) and their match scores, row order free."""
        missed, gap = 0, 0.0
        for c, s, rc, rs in zip(cells, scores, ref_cells, ref_scores):
            ref = {int(k): float(v) for k, v in zip(rc, rs) if k >= 0}
            for k, v in zip(c, s):
                if k < 0:
                    continue
                if int(k) not in ref:
                    missed += 1
                else:
                    gap = max(gap, abs(float(v) - ref[int(k)]))
        self.top_diff = (self.top_diff or 0) + missed
        self.score_gap = max(self.score_gap or 0.0, gap)

    def poses(self, R, t, R_ref, t_ref) -> None:
        rot, dir_ = np.atleast_1d(_rot_deg(R, R_ref)), np.atleast_1d(_angle_deg(t, t_ref))
        self.pose.extend(float(x) for x in np.maximum(rot, dir_))
        self.pose_rot.extend(float(x) for x in rot)
        self.pose_dir.extend(float(x) for x in dir_)

    def depths(self, depth, ok, ref_depth, ref_ok) -> None:
        """The depths the step wrote for its selected features (S, N), in
        the same order on both sides."""
        both = ok & ref_ok
        for d, r, m in zip(depth, ref_depth, both):
            if m.any():
                self.depth.append(float(np.median(np.abs(d[m] - r[m]) / np.maximum(np.abs(r[m]), 1e-9))))

    def result(self, res: dict, ref_res) -> None:
        """A step's selection, match scores, pose and depths."""
        def np_(x):
            return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)

        self.selection(np_(res["cells_new"]), np_(res["match_score"]), np_(ref_res.cells_new),
                       np_(ref_res.match_score))
        self.poses(np_(res["R"]), np_(res["t"]), np_(ref_res.R), np_(ref_res.t))
        self.depths(np_(res["depth_top"]), np_(res["depth_top_ok"]), np_(ref_res.depth_top),
                    np_(ref_res.depth_top_ok))

    def numbers(self) -> Dict[str, Optional[float]]:
        out: Dict[str, Optional[float]] = {**self.counts, **self.maxima}
        out["top_diff"] = self.top_diff
        out["score_gap"] = self.score_gap
        out["pose_gap_deg"] = float(np.median(self.pose)) if self.pose else None
        out["depth_gap"] = float(np.median(self.depth)) if self.depth else None
        rot = sorted(self.pose_rot, reverse=True)
        out["pose_rot_deg_3rd"] = rot[2] if len(rot) >= 3 else None
        for name, vals in self.backend.items():
            v = [x for x in vals if x is not None]
            out[name] = float(np.median(v)) if v else None
        return out

    def detail(self) -> dict:
        """Every reading behind the medians, for the record."""
        return {"pose_gap_deg": self.pose, "pose_rot_deg": self.pose_rot,
                "pose_dir_deg": self.pose_dir, "depth_gap": self.depth, **self.backend}


def reference_state(ref_prev, prog_prev: Optional[dict], s: int, device):
    """The reference's previous state: its own features of the previous
    frames, and the program's depth map, scale and fallback pose (None: the
    start, with the tracker's initial depth, scale and pose)."""
    n = ref_prev.probs.shape[1] * ref_prev.probs.shape[2]
    if prog_prev is None:
        prog_prev = {"depth": torch.zeros(s, n, device=device),
                     "depth_valid": torch.zeros(s, n, dtype=torch.bool, device=device),
                     "scale": torch.ones(s, device=device),
                     "prev_R": torch.eye(3, device=device).repeat(s, 1, 1),
                     "prev_t": torch.zeros(s, 3, device=device)}
    return rtrk.TrackerState(
        desc=ref_prev.desc_q.reshape(s, n, 256), probs=ref_prev.probs.reshape(s, n),
        indices=ref_prev.indices.reshape(s, n), xy=ref_prev.xy.reshape(s, n, 2),
        depth=prog_prev["depth"], depth_valid=prog_prev["depth_valid"], scale=prog_prev["scale"],
        prev_R=prog_prev["prev_R"], prev_t=prog_prev["prev_t"], generator=None)


def in_program_order(top, prog_cells: torch.Tensor):
    """The reference's top-N in the program's order of the same cells. The
    order of cells of equal probability is no part of the answer, but the
    RANSAC noise is drawn per slot, so the reference takes the program's.
    A stream whose selection differs keeps the reference's order (and
    counts in `top_diff`)."""
    perm = []
    for ref_c, prog_c in zip(top.cells.tolist(), prog_cells.tolist()):
        slots = {}
        for i, c in enumerate(ref_c):
            slots.setdefault(c, []).append(i)
        if sorted(ref_c) != sorted(prog_c):
            perm.append(list(range(len(ref_c))))
        else:
            perm.append([slots[c].pop(0) for c in prog_c])
    idx = torch.tensor(perm, device=top.cells.device)
    return type(top)(*(torch.take_along_dim(f, idx, dim=-1) for f in top[:4]), top.num_selected)


def follow_step(params, cfg, prev_images, images, prog_prev, prog_cells, noise, device):
    """The reference's step from its own features of both frames, in the
    program's order of the selected cells, and the program's previous
    state (see `reference_state`)."""
    ref_prev = extract(params, prev_images, cfg)
    ref_new = extract(params, images, cfg)
    ref_new = ref_new._replace(top=in_program_order(ref_new.top, prog_cells))
    state = reference_state(ref_prev, prog_prev, images.shape[0], device)
    new_state, res = rtrk._step_from_feats(state, ref_new, cfg, noise[0], noise[1])
    return ref_new, new_state, res


def judge(numbers: Dict[str, Optional[float]], limits: Dict[str, float]) -> tuple:
    """(correct, compared): every number that has a reading within its
    limit. A number with no limit, or a limit with no number where the run
    has something to compare, is not correct."""
    compared, ok = {}, True
    for name, value in numbers.items():
        limit = limits.get(name)
        if value is None:
            continue
        if limit is None or not math.isfinite(value) or value > limit:
            ok = False
        compared[name] = {"value": value, "limit": limit}
    return ok, compared

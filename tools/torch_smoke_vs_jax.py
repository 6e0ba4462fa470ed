"""The JAX package's own results on chip_smoke.py's scenes, beside the
port's, on the CPU: where chip_smoke.py's bars against ground truth come
from.

    JAX_PLATFORMS=cpu python tools/torch_smoke_vs_jax.py [stream0] [pairwise] [ba] [pose-graph]
        [slam [--size 96x320|192x640] [--frames N] [--fetch-delay D] [--eager] [--port]
         [--port-ba] [--jax-order]] [tracker [--seeds N]] [steps [--frames N] [--jax-features] [--eager]]
        [steps --size 192x640 [--eager]] [checkpoint [--fetch-delay D]] [degenerate] [long [--frames N]]
        [synthetic [--seeds N]] [loop-edges [--seeds N]] [mesh [--ranks R [R ...]] [--verbose]]

- stream0: chip_smoke.py's batched stream 0 (orbit frames 0-5 at 192x640,
  RANSAC noise from torch.Generator().manual_seed(1) for all 16 streams)
  through JAX's jitted `track_step` and the port's `track_step`; each step's
  rotation and translation-direction error against the ground truth.
- pairwise: `pairwise_pose` on chip_smoke.py's PAIRS with its noise.
- ba: dense and factor-list `bundle_adjust` on `ba_scene` (P = 8,
  L = 1024); the reprojection RMSE before and after.
- pose-graph: `optimize` on `loop_graph` (256 nodes, 288 edges, 8
  iterations); the position errors before and after; then the port's
  solve with the edges in ORDERS seeded orders against its own, the
  spread behind chip_smoke.py's card-against-CPU bars.
- slam: the JAX SlamSystem (jit, its own noise) over a closing orbit: the
  full engine's and the odometry's ATE, the loop closures, the inlier
  counts. --size 96x320 (the default) is tests/test_torch_slam.py's 125-frame
  orbit, and the port also runs there on the CPU with the JAX engine's noise
  (per-frame count and word differences, ATE, loop pairs); --size 192x640 is
  chip_smoke.py's [slam] scene (250 frames), where the port runs only with
  --port. --frames cuts the run, --fetch-delay sets the engines'. --eager
  also runs the JAX engine with jit disabled and prints, per odometry step,
  the gaps between JAX jit, JAX eager and the port (JAX's own jit/eager
  spread; ~15 s a frame at 96x320): with --frames 13 the source of
  tests/test_torch_slam.py's odometry bar. --port-ba also runs the JAX engine
  with its window BA solved by the port's (`_window_ba_packed` on the CPU).
  --jax-order also runs the port with each frame's top-N list put in the
  JAX engine's order (the same cells, which the port's detector orders by
  probs an ulp apart from XLA's: ROADMAP Faults (l)), with JAX's noise.
- tracker: the free-running `Tracker` of each package over the 125-frame
  96x320 orbit, each drawing its own noise (JAX: PRNGKey(seed); the port: a
  torch.Generator seeded seed) for seeds 0 .. --seeds N - 1 (1 unless
  given); the ATE of each odometry chain, and their spread over the seeds.
- steps: the port's `track_step` run from the JAX Tracker's own state at
  every step of the JAX Tracker's chain (jit, PRNGKey(0), the 96x320 orbit,
  --frames N of it), with the frame and that step's noise: per step the
  gaps in R, t and the scale, and over the chain the mean and spread of the
  port's scale and translation norm against JAX's. A fault of the port
  shows as a bias; rounding as a scatter around 0. --jax-features feeds
  the port's step JAX's features of the new frame too (descriptors, probs,
  winners and xy from JAX's next state, the top-N selected from them by
  the port), so that only the step's tail differs. --eager also runs JAX's
  step with jit disabled from the same state and prints the same gaps
  between JAX's two runs (~15 s a step): the reference's own spread.
  With --size 192x640 it runs chip_smoke.py's [track] scene instead
  (orbit frames 0-10 at 192x640 and their noise through `_KeyedRandom`),
  JAX alone: with --eager, per step the gaps between JAX's jitted step and
  the same step with jit disabled from the same state, the bar of
  chip_smoke.py's [cpu-vs-card] tail (`TAIL_SPREAD`, ROADMAP Faults (g);
  ~1 min in all).
- checkpoint: the JAX engine at --fetch-delay D (3 unless given) over frames
  0-12 of the 96x320 orbit, saved with its own `checkpoint.save` after frame
  6 and resumed into a fresh engine over frames 7-12, against its unbroken
  run: what the save keeps of the frames still in flight; then the port's
  `save` at the same point.

- degenerate: chip_smoke.py's [degenerate] sequences (orbit frames 0-2 at
  192x640 with a black frame, and frame 0 repeated) through JAX's jitted
  `track_step` with the phase's noise: each step's valid flag, counts,
  finiteness and the black frame's fallback against the step before it.
- long: chip_smoke.py's [long] phase through the JAX SlamSystem (jit, its
  own noise) at 192x640: the structural run (--frames N of its 520) with
  `chip_smoke.long_checks`, the loop pairs' image gaps and the pose graph's
  subsampled solves; then the fault-repair pair and its drift figures. The
  source of any [long] bar that departs from tests/test_long_sequence.py's.
- synthetic: the JAX SlamSystem over tests/test_torch_slam.py's 125-frame
  96x320 closing orbit for seeds 0 .. --seeds N - 1, seed s drawing its
  tracking noise from PRNGKey(s) (the engine itself always starts its
  tracker at PRNGKey(0)) and its loop verifications from PRNGKey(s) (the
  engine's seed): the full engine's and the odometry's ATE per seed and
  their distribution, the reference for the port's
  `maveric_slam_tpu_torch.bench.synthetic_accuracy --seeds N` (ROADMAP
  Faults (l)). Seed 0 is SYNTH_ACCURACY.json's run.

- loop-edges: both engines (BA off, loop closure on, each its own noise as
  in `synthetic`) over the 125-frame orbit for seeds 0 .. --seeds N - 1:
  each accepted loop verification's inliers, how many of them have a unit
  depth below 1e-3 or above 1e3, the points that can scale the edge (at
  least 8 or the edge takes the trajectory's own length), and the edge's
  length (ROADMAP Faults (l)).

- mesh: JAX's mesh-mode SlamSystem (`parallel/mesh.make_mesh(n)` on 8
  virtual CPU devices) for each n of --ranks (2 4 8 unless given) over
  chip_smoke.py's [slam] scene (250 frames at 192x640, BA every 4,
  fetch_delay 0) with its tracking noise, against JAX's single engine on
  the same frames and noise: max |dt|, the similarity-aligned RMSE, the
  ATE, BA windows and loop pairs (per-frame gaps with --verbose; ~4 min in
  all). The reference for tools/torch_mesh_spread.py's figures of the
  port (ROADMAP Faults (o)).

JAX's RANSAC draws its noise from a PRNG key; here a stand-in for
`jax.random` inside its RANSAC module hands it the port's noise instead, so
that both packages draw the same samples. `_Random` makes the noise a
constant of the trace, so each call recompiles (about a minute a step at
192x640 on 8 cores); `_KeyedRandom` looks it up by key at run time (the
steps at 192x640 and mesh modes).
"""

from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "mesh" in sys.argv[1:]:  # the mesh mode's 8 virtual devices, as tests/conftest.py asks for
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=8").strip()
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "tests"))  # test_torch_slam's engine runners

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import chip_smoke as smoke  # noqa: E402
from maveric_slam_tpu import config as jconfig  # noqa: E402
from maveric_slam_tpu.backend import ba as jba  # noqa: E402
from maveric_slam_tpu.backend import pose_graph as jpg  # noqa: E402
from maveric_slam_tpu.backend import sparse_ba as jsparse  # noqa: E402
from maveric_slam_tpu.frontend import pairwise as jpairwise  # noqa: E402
from maveric_slam_tpu.frontend import tracker as jtracker  # noqa: E402
from maveric_slam_tpu.geometry import ransac as jransac  # noqa: E402
from maveric_slam_tpu.models import superpoint as jsp  # noqa: E402
from maveric_slam_tpu_torch.backend import ba as tba  # noqa: E402
from maveric_slam_tpu_torch.backend import pose_graph as tpg  # noqa: E402
from maveric_slam_tpu_torch.data import synthetic  # noqa: E402
from maveric_slam_tpu_torch.frontend import tracker as ttracker  # noqa: E402
from maveric_slam_tpu_torch.geometry import ransac as transac  # noqa: E402
from maveric_slam_tpu_torch.models import superpoint as tsp  # noqa: E402
from maveric_slam_tpu_torch.utils.trajectory import relative_from_poses  # noqa: E402


class _Random:
    """`jax.random` as JAX's RANSAC uses it, drawing rows of fixed tables:
    split(key, K) -> rows 0..K-1 of the minimal noise, fold_in(key, 1 + r)
    then split(., K2) -> rows of LO round r's noise, gumbel(row) -> that row.
    `glo` is (K2, M) for one LO round or (rounds, K2, M)."""

    def __init__(self, gmin, glo):
        glo = np.asarray(glo).reshape(-1, *np.shape(glo)[-2:])
        self.table = jnp.asarray(np.concatenate([np.asarray(gmin), *glo]))
        self.k, self.lo_k, self.rounds = gmin.shape[0], glo.shape[1], glo.shape[0]

    def split(self, key, num=2):
        if key.ndim == 0:  # a marker fold_in returned
            return key + jnp.arange(num, dtype=jnp.int32)
        return jnp.arange(num, dtype=jnp.int32)

    def fold_in(self, key, data):
        if not 1 <= data <= self.rounds:
            raise ValueError(f"no noise for LO round {data - 1}: {self.rounds} round(s) given")
        return jnp.asarray(self.k + (data - 1) * self.lo_k, jnp.int32)

    def gumbel(self, k, shape):
        return self.table[k]


class _KeyedRandom:
    """`jax.random` as JAX's RANSAC uses it, with each row of noise looked up
    at run time (a host callback) by the key the caller passed: the rows
    `register(key, gmin, glo)` gave that key (a tracking step's key), else a
    row numpy draws from a generator seeded by the key's bits and the row (a
    loop verification's key). The noise is no constant of the trace, so one
    compiled program serves every step. Inside, a key is uint32[3]: the
    caller's two key words and a row (LO round r's rows from (r + 1) << 16)."""

    _LO = 1 << 16

    def __init__(self):
        self.tables = {}
        self.served = {"registered": 0, "drawn": 0}

    def register(self, key, gmin, glo):
        glo = np.asarray(glo).reshape(-1, *np.shape(glo)[-2:])
        self.tables[tuple(int(x) for x in np.asarray(key))] = (np.asarray(gmin, np.float32),
                                                               glo.astype(np.float32))

    def split(self, key, num=2):
        bits, base = (key[:2], key[2]) if key.shape[-1] == 3 else (key, jnp.uint32(0))
        rows = base + jnp.arange(num, dtype=jnp.uint32)
        return jnp.concatenate([jnp.broadcast_to(bits.astype(jnp.uint32), (num, 2)), rows[:, None]], 1)

    def fold_in(self, key, data):
        return jnp.concatenate([key.astype(jnp.uint32), jnp.full((1,), data * self._LO, jnp.uint32)])

    def _rows(self, k, shape):
        k = np.asarray(k)
        out = np.empty(k.shape[:-1] + tuple(shape), np.float32)
        for i in np.ndindex(k.shape[:-1]):
            a, b, row = (int(x) for x in k[i])
            self.served["registered" if (a, b) in self.tables else "drawn"] += 1
            if (a, b) in self.tables:
                gmin, glo = self.tables[(a, b)]
                out[i] = gmin[row] if row < self._LO else glo[row // self._LO - 1][row % self._LO]
            else:
                out[i] = np.random.default_rng([a, b, row]).gumbel(size=shape)
        return out

    def gumbel(self, k, shape):
        return jax.pure_callback(lambda kk: self._rows(kk, shape),
                                 jax.ShapeDtypeStruct(k.shape[:-1] + tuple(shape), jnp.float32),
                                 k, vmap_method="expand_dims")


class _Jax:
    def __init__(self, random):
        self.random = random

    def __getattr__(self, name):
        return getattr(jax, name)


def _inject(gmin, glo):
    """JAX's RANSAC draws (gmin, glo) from its next trace on."""
    jransac.jax = _Jax(_Random(np.asarray(gmin), np.asarray(glo)))
    jax.clear_caches()


def _inject_keyed():
    """JAX's RANSAC draws from a new `_KeyedRandom` from its next trace on;
    returns it, for the caller to register the tracking steps' noise."""
    keyed = _KeyedRandom()
    jransac.jax = _Jax(keyed)
    jax.clear_caches()
    return keyed


def _jax_config():
    d = jconfig.DEFAULT_CONFIG
    cam = jconfig.CameraConfig(fx=smoke.FOCAL, fy=smoke.FOCAL, cx=smoke.W / 2, cy=smoke.H / 2,
                               width=smoke.W, height=smoke.H)
    return dataclasses.replace(
        d, camera=cam, frontend=dataclasses.replace(d.frontend, height=smoke.H, width=smoke.W),
        ransac=dataclasses.replace(d.ransac, inlier_thresh=3.0 / smoke.FOCAL))


def _params():
    jp = jsp.load_params()
    return jp, tsp.params_from_numpy({n: np.asarray(v) for n, v in jp.items()}, device="cpu")


def stream0(jp, tp, stream=0):
    jcfg, tcfg = _jax_config(), smoke._config()
    orbit = synthetic.orbit_poses(smoke.ORBIT_N)
    poses = orbit[stream * smoke.ORBIT_N // smoke.STREAMS:][:smoke.STREAM_FRAMES]
    frames = [synthetic.render_box_room(tcfg.working_camera.K, p, smoke.H, smoke.W) for p in poses]
    gt_R, gt_t = relative_from_poses(poses)
    m, k = tcfg.frontend.top_n, tcfg.ransac.num_hypotheses
    lo_k = transac.lo_hypotheses(k)
    gen = torch.Generator().manual_seed(1)  # chip_smoke.py's batched noise
    noises = [(transac.gumbel((smoke.STREAMS, k, m), gen, "cpu")[stream],
               transac.gumbel((smoke.STREAMS, lo_k, m), gen, "cpu")[stream])
              for _ in range(smoke.STREAM_FRAMES - 1)]
    jstate = jtracker.init_state(jp, jnp.asarray(frames[0]), jcfg, 0)
    tstate = ttracker.init_state(tp, torch.from_numpy(frames[0]), tcfg, 0)
    worst = {"jax": 0.0, "port": 0.0}
    for j, (f, (gmin, glo)) in enumerate(zip(frames[1:], noises)):
        _inject(gmin, glo)
        jstate, jout = jtracker.track_step(jp, jstate, jnp.asarray(f), jcfg)
        tstate, tout = ttracker.track_step(tp, tstate, torch.from_numpy(f), tcfg, gmin, glo)
        jR, jt, tR, tt = np.asarray(jout.R), np.asarray(jout.t), tout.R.numpy(), tout.t.numpy()
        rj, rt = smoke._rot_deg(jR, gt_R[j]), smoke._rot_deg(tR, gt_R[j])
        worst = {"jax": max(worst["jax"], rj), "port": max(worst["port"], rt)}
        print(f"[stream0] step {j} (frames {j}->{j + 1}): matches jax {int(jout.num_matches)} port "
              f"{int(tout.num_matches)}, inliers jax {int(jout.num_inliers)} port "
              f"{int(tout.num_inliers)}; rot err jax {rj:.4f} port {rt:.4f} deg; t-dir err jax "
              f"{smoke._dir_deg(jt, gt_t[j]):.2f} port {smoke._dir_deg(tt, gt_t[j]):.2f} deg; jax vs "
              f"port {smoke._rot_deg(jR, tR):.4f} deg, max |dt| {np.abs(jt - tt).max():.3g}", flush=True)
    print(f"[stream0] stream {stream}: worst rot err jax {worst['jax']:.4f} deg, port "
          f"{worst['port']:.4f} deg")


def pairwise(jp, tp):
    jcfg, tcfg = _jax_config(), smoke._config()
    orbit = synthetic.orbit_poses(smoke.ORBIT_N)
    frames = {k: synthetic.render_box_room(tcfg.working_camera.K, orbit[k], smoke.H, smoke.W)
              for pair in smoke.PAIRS for k in pair}
    port = smoke.run_pairwise(torch.device("cpu"), frames, smoke.pairwise_noise(tcfg), tcfg)
    for (a, b), (gmin, glo), t in zip(smoke.PAIRS, smoke.pairwise_noise(tcfg), port):
        _inject(gmin, glo)
        j = jpairwise.pairwise_pose(jp, jnp.asarray(frames[a]), jnp.asarray(frames[b]), jcfg,
                                    key=jax.random.PRNGKey(0))
        gt_R, gt_t = relative_from_poses(orbit[[a, b]])
        print(f"[pairwise] frames {a}->{b}: matches jax {int(j.num_matches)} port {t['matches']}, "
              f"inliers jax {int(j.num_inliers)} port {t['inliers']}; rot err jax "
              f"{smoke._rot_deg(np.asarray(j.R), gt_R[0]):.4f} port {smoke._rot_deg(t['R'], gt_R[0]):.4f} "
              f"deg; t-dir err jax {smoke._dir_deg(np.asarray(j.t), gt_t[0]):.3f} port "
              f"{smoke._dir_deg(t['t'], gt_t[0]):.3f} deg; jax vs port rot "
              f"{smoke._rot_deg(np.asarray(j.R), t['R']):.5f} deg, max |dt| "
              f"{np.abs(np.asarray(j.t) - t['t']).max():.3g}", flush=True)


def _rmse(r, mask):
    r, mask = np.asarray(r), np.asarray(mask)
    return float(np.sqrt((np.sum(r * r, -1)[mask]).mean()))


def ba():
    bc = jconfig.DEFAULT_CONFIG.ba
    scene, _ = smoke.ba_scene()
    kw = dict(iterations=bc.max_iterations, damping=bc.lm_damping, huber_delta=bc.huber_delta)
    prob = jba.BAProblem(*scene)
    solved, stats = jba.bundle_adjust(prob, **kw)
    sp_solved, sp_costs = jsparse.bundle_adjust(jsparse.from_dense(prob), **kw)
    tprob = tba.BAProblem(*(torch.from_numpy(np.ascontiguousarray(a)) for a in scene))
    tsolved, tstats = tba.bundle_adjust(tprob, **kw)
    r0 = _rmse(jba._residuals(prob)[0], scene[5])
    r = _rmse(jba._residuals(solved)[0], scene[5])
    rs = _rmse(jba._residuals(prob._replace(R=sp_solved.R, t=sp_solved.t, X=sp_solved.X))[0], scene[5])
    rt = _rmse(tba._residuals(tsolved)[0], tprob.mask)
    print(f"[ba] {int(stats.num_factors)} observations: RMSE {r0:.4f} -> jax dense {r:.5f}, jax "
          f"sparse {rs:.5f}, port dense (CPU) {rt:.5f} px; cost jax "
          f"{' '.join(f'{v:.6g}' for v in np.asarray(stats.cost))}; port "
          f"{' '.join(f'{v:.6g}' for v in tstats.cost.numpy())}; jax vs port max |dR| "
          f"{np.abs(np.asarray(solved.R) - tsolved.R.numpy()).max():.3g} |dt| "
          f"{np.abs(np.asarray(solved.t) - tsolved.t.numpy()).max():.3g}")


ORDERS = 10  # pose-graph: the edge orders the port's sensitivity is measured over


def pose_graph():
    fields, (_, t_gt) = smoke.loop_graph()
    n = t_gt.shape[0]
    opt, costs = jpg.optimize(jpg.PoseGraph(*fields), iterations=smoke.GRAPH_ITERS)
    topt, tcosts = tpg.optimize(tpg.PoseGraph(*(torch.from_numpy(a) for a in fields)),
                                iterations=smoke.GRAPH_ITERS)
    before = np.linalg.norm(fields[1][:n] - t_gt, axis=-1)
    after = np.linalg.norm(np.asarray(opt.t)[:n] - t_gt, axis=-1)
    tafter = np.linalg.norm(topt.t.numpy()[:n] - t_gt, axis=-1)
    print(f"[pose-graph] cost jax {' '.join(f'{v:.6g}' for v in np.asarray(costs))}; port "
          f"{' '.join(f'{v:.6g}' for v in tcosts.numpy())}; position error mean {before.mean():.4f} -> "
          f"jax {after.mean():.4f} port {tafter.mean():.4f} m, last pose {before[-1]:.4f} -> jax "
          f"{after[-1]:.4f} port {tafter[-1]:.4f} m; jax vs port "
          f"{_gaps(smoke.graph_gaps((opt.R, opt.t), (topt.R, topt.t), n))}", flush=True)
    # The port's own sensitivity to the order of its sums: the same edges
    # in seeded random orders, each against the unpermuted solve.
    rng = np.random.default_rng(0)
    worst = {}
    for s in range(ORDERS):
        perm = rng.permutation(fields[2].shape[0])
        f = list(fields[:2]) + [a[perm] for a in fields[2:]]
        popt, pcosts = tpg.optimize(tpg.PoseGraph(*(torch.from_numpy(np.ascontiguousarray(a)) for a in f)),
                                    iterations=smoke.GRAPH_ITERS)
        g = smoke.graph_gaps((popt.R, popt.t), (topt.R, topt.t), n)
        g["cost"] = abs(float(pcosts[-1]) / float(tcosts[-1]) - 1.0)
        worst = {k: max(v, worst.get(k, 0.0)) for k, v in g.items()}
        print(f"[pose-graph] port, edge order {s}: {_gaps(g)}", flush=True)
    print(f"[pose-graph] port, {ORDERS} edge orders, largest: {_gaps(worst)}")


def _gaps(g):
    return ", ".join(f"{k} {v:.3g}" for k, v in g.items())


def _slam_scene(size):
    """(JAX config, port config, frames, ground truth) of the slam mode."""
    if size == "96x320":
        import test_torch_slam as ts

        frames, gt = ts.orbit(ts.N_ORBIT)
        return ts.JCFG, ts.TCFG, frames, gt
    tcfg = smoke._config()
    orbit = synthetic.orbit_poses(smoke.ORBIT_N)[np.arange(smoke.SLAM_FRAMES) % smoke.ORBIT_N]
    frames = [synthetic.render_box_room(tcfg.working_camera.K, p, smoke.H, smoke.W) for p in orbit]
    return _jax_config(), tcfg, frames, orbit


def _engine_summary(label, slam, gt):
    from maveric_slam_tpu_torch.utils import evaluation

    full = evaluation.ate(slam.trajectory(), gt)["ate_rmse"]
    odo = evaluation.ate(slam.odometry_trajectory(), gt)["ate_rmse"]
    inl = [s["inliers"] for s in slam.stats]
    print(f"[slam] {label}: ATE full {full:.4f} m, odometry {odo:.4f} m (ratio {full / odo:.4f}); "
          f"valid {sum(s['valid'] for s in slam.stats)}/{len(slam.stats)} (not valid: frames "
          f"{[k + 1 for k, s in enumerate(slam.stats) if not s['valid']]}), inliers median "
          f"{np.median(inl)}, min {min(inl)}; loop closures (frame, matched, inliers) "
          f"{[(e.frame, e.matched_frame, e.num_inliers) for e in slam.loop_events]}", flush=True)


def _step_gaps(a, b):
    return (max(float(np.abs(x[0] - y[0]).max()) for x, y in zip(a.rel_poses, b.rel_poses)),
            max(float(np.abs(x[1] - y[1]).max()) for x, y in zip(a.rel_poses, b.rel_poses)))


def _jax_with_port_ba(jp, frames, fetch_delay, tcfg):
    """The JAX engine with every window BA solved by the port's."""
    import test_torch_slam as ts
    from maveric_slam_tpu import slam as jslam
    from maveric_slam_tpu_torch import slam as tslam

    solve = jslam._window_ba_packed
    jslam._window_ba_packed = lambda flat, config, iterations, num_anchored: jnp.asarray(
        tslam._window_ba_packed(torch.from_numpy(np.array(flat)), tcfg, iterations,
                                num_anchored).numpy())
    try:
        return ts.run_jax(jp, frames, fetch_delay)
    finally:
        jslam._window_ba_packed = solve


def _run_port_in_jax_order(tp, frames, fetch_delay, views):
    """ts.run_port with each step's top-N list permuted into the order of
    the JAX engine's list for the same frame (`views[k].cells_new`, step k);
    the selected cells must be the same set."""
    import test_torch_slam as ts
    from maveric_slam_tpu_torch.frontend import extractor as text
    from maveric_slam_tpu_torch.ops import softmax_topn as tst

    orders = iter([None] + [np.asarray(v.cells_new) for v in views])  # frame 0: no top-N used
    extract = text.extract_quantized_batched
    moved = []

    def in_jax_order(params, images, config, apply_nms=False):
        f = extract(params, images, config, apply_nms)
        want = next(orders)
        if want is None:
            return f
        cells, n_sel = f.top.cells[0].numpy(), int(f.top.mask[0].sum())
        if sorted(cells[:n_sel].tolist()) != sorted(want[:n_sel].tolist()):
            raise RuntimeError("the port and JAX selected different cells")
        pos = {c: k for k, c in enumerate(cells[:n_sel].tolist())}
        perm = torch.tensor([pos[c] for c in want[:n_sel].tolist()] + list(range(n_sel, len(cells))))
        moved.append(int((perm != torch.arange(len(cells))).sum()))
        return f._replace(top=tst.TopN(*(x[:, perm] for x in f.top[:4]), f.top.num_selected))

    text.extract_quantized_batched = in_jax_order
    try:
        slam = ts.run_port(tp, frames, fetch_delay)
    finally:
        text.extract_quantized_batched = extract
    print(f"[slam] top-N entries moved into JAX's order: {sum(moved)} on "
          f"{sum(m > 0 for m in moved)} of {len(moved)} frames", flush=True)
    return slam


def slam(jp, tp, size, frames_n, fetch_delay, eager, port, port_ba, jax_order):
    import test_torch_slam as ts

    jcfg, tcfg, frames, gt = _slam_scene(size)
    frames, gt = frames[:frames_n], gt[:frames_n]
    ts.JCFG, ts.TCFG = jcfg, tcfg  # the engines' configs for this scene
    j = ts.run_jax(jp, frames, fetch_delay)
    _engine_summary(f"JAX (jit), {len(frames)} frames at {size}, fetch_delay {fetch_delay}", j, gt)
    e = t = None
    if eager:
        with jax.disable_jit():
            e = ts.run_jax(jp, frames, fetch_delay)
        _engine_summary("JAX (jit disabled)", e, gt)
    if port_ba:
        _engine_summary("JAX (jit) with the port's window BA",
                        _jax_with_port_ba(jp, frames, fetch_delay, tcfg), gt)
    if size == "96x320" or port:
        t = ts.run_port(tp, frames, fetch_delay)
        _engine_summary("port (CPU, JAX's noise)", t, gt)
    if jax_order:
        _engine_summary("port (CPU, JAX's noise, JAX's top-N order)",
                        _run_port_in_jax_order(tp, frames, fetch_delay, j.views), gt)
    if e is not None:
        for k in range(len(j.rel_poses)):
            gaps = [(n, a.rel_poses[k], b.rel_poses[k]) for n, a, b in
                    (("eager-jit", e, j), ("port-jit", t, j), ("port-eager", t, e)) if a and b]
            print(f"[slam] step {k}: " + "; ".join(
                f"{n} max |dR| {np.abs(x[0] - y[0]).max():.3g} |dt| {np.abs(x[1] - y[1]).max():.3g}"
                for n, x, y in gaps), flush=True)
        print(f"[slam] largest over the steps: eager-jit |dR| %.3g |dt| %.3g" % _step_gaps(e, j)
              + ("" if t is None else "; port-jit |dR| %.3g |dt| %.3g" % _step_gaps(t, j)))
    if t is not None:
        for k, (a, b) in enumerate(zip(j.views, t.views)):
            diff = [n for n in ("num_matches", "num_inliers", "valid")
                    if int(getattr(a, n)) != int(getattr(b, n))]
            if ts._word_pairs(a) != ts._word_pairs(b):
                diff.append("words")
            if not np.array_equal(a.sightings, b.sightings):
                diff.append("sightings")
            order = "" if np.array_equal(a.word_ids, b.word_ids) else " (top-N order differs)"
            if diff or order:
                print(f"[slam] frame {k + 1}: differs in {diff}{order}; inliers jax "
                      f"{int(a.num_inliers)} port {int(b.num_inliers)}")


def tracker(jp, tp, seeds):
    """The free-running trackers, each with its own noise, on the 125-frame
    orbit: ATE of each odometry chain, seed by seed."""
    import test_torch_slam as ts
    from maveric_slam_tpu_torch.utils import evaluation

    frames, gt = ts.orbit(ts.N_ORBIT)
    ates = {"JAX": [], "port": []}
    for seed in range(seeds):
        j = jtracker.Tracker(jp, ts.JCFG, seed=seed)
        t = ttracker.Tracker(tp, ts.TCFG, seed=seed, device="cpu")
        for f in frames:
            j.process(f)
            t.process(f)
        for name, trk in (("JAX", j), ("port", t)):
            a = evaluation.ate(trk.trajectory(), gt)["ate_rmse"]
            ates[name].append(a)
            print(f"[tracker] {name} Tracker, seed {seed}: ATE {a:.4f} m over {len(frames)} frames, "
                  f"valid {sum(s['valid'] for s in trk.stats)}/{len(trk.stats)}, inliers median "
                  f"{np.median([s['inliers'] for s in trk.stats])}", flush=True)
    for name, a in ates.items():
        print(f"[tracker] {name} over {seeds} seeds: ATE median {np.median(a):.4f} m, mean "
              f"{np.mean(a):.4f}, min {min(a):.4f}, max {max(a):.4f}", flush=True)


def _port_tail_step(tp, tstate, f, noise, jnext):
    """The port's step on frame f with the new frame's features taken from
    JAX's next state `jnext` (numpy fields) and the top-N selected from
    them by the port's `top_n_select`."""
    import test_torch_slam as ts
    from maveric_slam_tpu_torch.frontend import extractor as text
    from maveric_slam_tpu_torch.ops import softmax_topn as tst

    fc = ts.TCFG.frontend
    feats = text.extract_quantized_batched(tp, torch.from_numpy(f)[None], ts.TCFG)
    grid = {n: torch.from_numpy(jnext[n]).reshape(1, fc.grid_h, fc.grid_w, *jnext[n].shape[1:])
            for n in ("desc", "probs", "indices", "xy")}
    top = tst.top_n_select(tst.SoftmaxGrid(probs=grid["probs"], indices=grid["indices"]),
                           n=fc.top_n, valid_thresh=fc.valid_prob_thresh, mode=fc.top_n_mode)
    feats = feats._replace(desc_q=grid["desc"], probs=grid["probs"], indices=grid["indices"],
                           xy=grid["xy"], top=top)
    _, res = ttracker._step_from_feats(ttracker._batched(tstate), feats, ts.TCFG,
                                       *(torch.from_numpy(g)[None] for g in noise))
    return ttracker.StepResult(*(x[0] for x in res))


def _step_gap_row(label, k, jout, tout):
    """(max |dR|, max |dt|, scale ratio - 1, |t| ratio - 1, counts) of one
    step against JAX's jitted step, printed."""
    jR, jt, tR, tt = (np.asarray(x) for x in (jout.R, jout.t, tout.R, tout.t))
    counts = [(int(getattr(jout, n)), int(getattr(tout, n)))
              for n in ("num_matches", "num_inliers", "num_scale_pairs")]
    row = (float(np.abs(tR - jR).max()), float(np.abs(tt - jt).max()),
           float(tout.scale) / float(jout.scale) - 1.0,
           float(np.linalg.norm(tt)) / float(np.linalg.norm(jt)) - 1.0, counts)
    print(f"[steps] {label} step {k}: max |dR| {row[0]:.3g} |dt| {row[1]:.3g}, scale ratio - 1 "
          f"{row[2]:+.3g}, |t| ratio - 1 {row[3]:+.3g}, (matches, inliers, scale pairs) JAX jit/"
          f"{label} {counts}", flush=True)
    return row


def _step_gap_summary(label, rows):
    r = np.array([x[:4] for x in rows])
    same = sum(all(a == b for a, b in x[4]) for x in rows)
    print(f"[steps] {label} against JAX jit, {len(rows)} steps: counts equal on {same}; max |dR| "
          f"{r[:, 0].max():.3g}, median {np.median(r[:, 0]):.3g}; max |dt| {r[:, 1].max():.3g}, "
          f"median {np.median(r[:, 1]):.3g}; scale ratio - 1 mean {r[:, 2].mean():+.3g} (std "
          f"{r[:, 2].std():.3g}, median {np.median(r[:, 2]):+.3g}); |t| ratio - 1 mean "
          f"{r[:, 3].mean():+.3g} (std {r[:, 3].std():.3g}, median {np.median(r[:, 3]):+.3g})",
          flush=True)


def steps(jp, tp, frames_n, jax_features, eager):
    """One port step (and with `eager` one JAX step with jit disabled) from
    each state of the JAX Tracker's jitted chain."""
    import test_torch_slam as ts

    frames, _ = ts.orbit(frames_n or ts.N_ORBIT)
    state = jtracker.init_state(jp, jnp.asarray(frames[0]), ts.JCFG, 0)
    rows, eager_rows = [], []
    for k, f in enumerate(frames[1:]):
        snap = {n: np.array(v) for n, v in state._asdict().items()}
        noise = ts.ransac_noise(jax.random.split(state.key)[0])
        state, jout = jtracker.track_step(jp, state, jnp.asarray(f), ts.JCFG)
        if eager:
            with jax.disable_jit():
                _, eout = jtracker.track_step(
                    jp, jtracker.TrackerState(**{n: jnp.asarray(v) for n, v in snap.items()}),
                    jnp.asarray(f), ts.JCFG)
            eager_rows.append(_step_gap_row("JAX eager", k, jout, eout))
        tstate = ttracker.TrackerState(
            **{n: torch.from_numpy(v) for n, v in snap.items() if n != "key"},
            generator=torch.Generator())
        if jax_features:
            tout = _port_tail_step(tp, tstate, f, noise, {n: np.array(v) for n, v in
                                                          state._asdict().items()})
        else:
            _, tout = ttracker.track_step(tp, tstate, torch.from_numpy(f), ts.TCFG,
                                          *(torch.from_numpy(g) for g in noise))
        rows.append(_step_gap_row("port", k, jout, tout))
    _step_gap_summary("port" + (" (JAX's features)" if jax_features else ""), rows)
    if eager:
        _step_gap_summary("JAX eager", eager_rows)


def _track_scene():
    """chip_smoke.py's [track] scene: orbit frames 0 .. N_FRAMES - 1 at
    192x640 and each step's RANSAC noise as chip_smoke.py draws it (a host
    generator seeded 0, the minimal then the LO table a step)."""
    tcfg = smoke._config()
    poses = synthetic.orbit_poses(smoke.ORBIT_N)[:smoke.N_FRAMES]
    frames = [synthetic.render_box_room(tcfg.working_camera.K, p, smoke.H, smoke.W) for p in poses]
    m, k = tcfg.frontend.top_n, tcfg.ransac.num_hypotheses
    gen = torch.Generator().manual_seed(0)
    noises = [(transac.gumbel((k, m), gen, "cpu").numpy(),
               transac.gumbel((transac.lo_hypotheses(k), m), gen, "cpu").numpy())
              for _ in range(smoke.N_FRAMES - 1)]
    return frames, noises


def track_steps(jp, eager):
    """JAX's jitted `track_step` chain over chip_smoke.py's [track] scene
    with its noise (`_KeyedRandom`: one compile for every step), and with
    `eager` one step with jit disabled from each state of the chain: per
    step the gaps between the two, the bar of chip_smoke.py's
    [cpu-vs-card] tail (ROADMAP Faults (g))."""
    jcfg = _jax_config()
    frames, noises = _track_scene()
    keyed = _inject_keyed()
    state = jtracker.init_state(jp, jnp.asarray(frames[0]), jcfg, 0)
    rows = []
    for k, (f, (gmin, glo)) in enumerate(zip(frames[1:], noises)):
        keyed.register(jax.random.split(state.key)[0], gmin, glo)
        snap = {n: np.array(v) for n, v in state._asdict().items()}
        state, jout = jtracker.track_step(jp, state, jnp.asarray(f), jcfg)
        if not eager:
            print(f"[steps] JAX jit step {k}: (matches, inliers, scale pairs) "
                  f"{[int(getattr(jout, n)) for n in ('num_matches', 'num_inliers', 'num_scale_pairs')]}",
                  flush=True)
            continue
        with jax.disable_jit():
            _, eout = jtracker.track_step(
                jp, jtracker.TrackerState(**{n: jnp.asarray(v) for n, v in snap.items()}),
                jnp.asarray(f), jcfg)
        rows.append(_step_gap_row("JAX eager", k, jout, eout))
    print(f"[steps] noise rows served: {keyed.served}", flush=True)
    if rows:
        _step_gap_summary("JAX eager", rows)


def mesh(jp, ranks, verbose):
    """JAX's mesh-mode SlamSystem (`parallel/mesh.make_mesh(n)` on the CPU's
    virtual devices) over chip_smoke.py's [slam] scene with its tracking
    noise, against JAX's single engine on the same frames and noise."""
    import time

    from maveric_slam_tpu.parallel import mesh as jmesh
    from maveric_slam_tpu_torch.utils import evaluation

    frames, gt, noises = smoke.slam_scene(smoke._config(), {})
    keyed = _inject_keyed()
    key = jax.random.PRNGKey(0)  # the engine's tracker: split once a step
    for gmin, glo in noises:
        sub, key = jax.random.split(key)
        keyed.register(sub, gmin.numpy(), glo.numpy())

    def run(n):
        slam = _jax_engine(jp, _jax_config(), ba_every=smoke.SLAM_BA_EVERY, enable_loop_closure=True,
                           fetch_delay=0, mesh=None if n is None else jmesh.make_mesh(n))
        windows, dispatch = [], slam._dispatch_window_ba

        def solve(fidx):
            dispatch(fidx)
            if slam._pending_ba is not None:
                windows.append(fidx)

        slam._dispatch_window_ba = solve
        t0 = time.perf_counter()
        for f in frames:
            slam.process(f)
        poses = slam.trajectory()
        slam.close()
        return {"poses": poses, "windows": windows, "seconds": time.perf_counter() - t0,
                "loops": [(e.frame, e.matched_frame, e.num_inliers) for e in slam.loop_events],
                "valid": sum(s["valid"] for s in slam.stats)}

    def report(label, r, ref):
        d = np.abs(r["poses"][:, :3, 3] - ref["poses"][:, :3, 3]).max(-1)
        aligned = evaluation.ate(r["poses"], ref["poses"])["ate_rmse"]
        print(f"[mesh] {label}: max |dt| {d.max():.6g} m (frame {int(d.argmax())}), aligned RMSE "
              f"{aligned:.6g} m; ATE {evaluation.ate(r['poses'], gt)['ate_rmse']:.4f} m; valid "
              f"{r['valid']}/{len(frames) - 1}; {len(r['windows'])} BA windows"
              f"{'' if r['windows'] == ref['windows'] else ' (NOT the single engine’s)'}; loop pairs "
              f"{[x[:2] for x in r['loops']]}, inliers {[x[2] for x in r['loops']]}; "
              f"{r['seconds']:.1f} s", flush=True)
        if verbose:
            print("[mesh]   per frame: " + " ".join(f"{x:.3g}" for x in d), flush=True)
        return float(d.max()), float(aligned)

    ref = run(None)
    report(f"JAX single engine, {len(frames)} frames at {smoke.H}x{smoke.W}", ref, ref)
    gaps = {n: report(f"JAX mesh of {n} (make_mesh({n}), CPU virtual devices)", run(n), ref)
            for n in ranks}
    d, a = np.array(list(gaps.values())).T
    print(f"[mesh] JAX over meshes of {list(gaps)}: max |dt| largest {d.max():.6g} m, aligned RMSE "
          f"largest {a.max():.6g} m; noise rows served {keyed.served}", flush=True)


def checkpoint(jp, tp, fetch_delay, save_at=6, frames_n=13):
    """The JAX engine saved mid-run at `fetch_delay` and resumed, against its
    unbroken run; then the port's save at the same point."""
    import tempfile

    import test_torch_slam as ts
    from maveric_slam_tpu import slam as jslam
    from maveric_slam_tpu.loopclosure import vocab as jvocab
    from maveric_slam_tpu.utils import checkpoint as jcheckpoint
    from maveric_slam_tpu_torch import slam as tslam
    from maveric_slam_tpu_torch.utils import checkpoint as tcheckpoint
    from test_torch_loopclosure import jax_vocabulary

    frames, _ = ts.orbit(frames_n)
    path = tempfile.mkdtemp()
    jvocab.load_reference_vocabulary = jax_vocabulary

    def engine():
        return jslam.SlamSystem(jp, ts.JCFG, ba_every=4, enable_loop_closure=True,
                                fetch_delay=fetch_delay)

    a = engine()
    for k, f in enumerate(frames):
        a.process(f)
        if k == save_at:
            pending = len(a._pending)
            jcheckpoint.save(a, path)
    b = engine()
    jcheckpoint.restore(b, path)
    print(f"[checkpoint] JAX engine, fetch_delay {fetch_delay}: saved after frame {save_at} with "
          f"{pending} frames in flight; the checkpoint holds {len(b.poses)} poses, "
          f"{len(b.stats)} step stats, frame_idx {b.frame_idx}", flush=True)
    ta = a.trajectory()
    print(f"[checkpoint] unbroken: {len(ta)} poses, {len(a.stats)} stats, keyframes {a.kf_frames}",
          flush=True)
    try:
        for k in range(save_at + 1, len(frames)):
            b.process(frames[k])
        tb = b.trajectory()
    except Exception as e:  # noqa: BLE001 (the finding: reported, not raised)
        print(f"[checkpoint] the resumed engine fails at frame {k}: {e!r}", flush=True)
    else:
        n = min(len(ta), len(tb))
        gap = np.abs(ta[:n, :3, 3] - tb[:n, :3, 3]).max(axis=-1)
        print(f"[checkpoint] resumed: {len(tb)} poses, {len(b.stats)} stats, keyframes {b.kf_frames}; "
              f"position gap to the unbroken run over the first {n} poses (m): "
              + " ".join(f"{g:.4g}" for g in gap), flush=True)
    t = tslam.SlamSystem(tp, ts.TCFG, ba_every=4, enable_loop_closure=True,
                         fetch_delay=fetch_delay, device="cpu")
    for f in frames[:save_at + 1]:
        t.process(f)
    try:
        tcheckpoint.save(t, tempfile.mkdtemp())
        print("[checkpoint] port: saved", flush=True)
    except ValueError as e:
        print(f"[checkpoint] port: save refused ({e})", flush=True)


def _jax_engine(jp, cfg, **kw):
    """A JAX SlamSystem with its vocabulary loaded from the cache."""
    from maveric_slam_tpu import slam as jslam
    from maveric_slam_tpu.loopclosure import vocab as jvocab
    from test_torch_loopclosure import jax_vocabulary

    load = jvocab.load_reference_vocabulary
    jvocab.load_reference_vocabulary = jax_vocabulary
    try:
        return jslam.SlamSystem(jp, cfg, **kw)
    finally:
        jvocab.load_reference_vocabulary = load


def degenerate(jp):
    jcfg, tcfg = _jax_config(), smoke._config()
    orbit = synthetic.orbit_poses(smoke.ORBIT_N)
    frames = [synthetic.render_box_room(tcfg.working_camera.K, orbit[k], smoke.H, smoke.W) for k in range(3)]
    m, k = tcfg.frontend.top_n, tcfg.ransac.num_hypotheses
    gen = torch.Generator().manual_seed(smoke.DEGENERATE_SEED)
    noise = [(transac.gumbel((k, m), gen, "cpu"), transac.gumbel((transac.lo_hypotheses(k), m), gen, "cpu"))
             for _ in range(4)]
    for name, seq in smoke.degenerate_sequences(frames).items():
        state = jtracker.init_state(jp, jnp.asarray(seq[0]), jcfg, 0)
        prev = None
        for j, (f, (gmin, glo)) in enumerate(zip(seq[1:], noise)):
            _inject(gmin, glo)
            state, out = jtracker.track_step(jp, state, jnp.asarray(f), jcfg)
            R, t = np.asarray(out.R), np.asarray(out.t)
            held = "" if prev is None else (f", R/t the step before's: max |dR| "
                                            f"{np.abs(R - prev[0]).max():.3g} |dt| {np.abs(t - prev[1]).max():.3g}")
            print(f"[degenerate] JAX {name} step {j}: valid {bool(out.valid)}, matches "
                  f"{int(out.num_matches)}, inliers {int(out.num_inliers)}, matched "
                  f"{bool(np.asarray(out.match_mask).any())}, finite "
                  f"{bool(np.isfinite(R).all() and np.isfinite(t).all() and np.isfinite(np.asarray(state.scale)))}"
                  f"{held}", flush=True)
            prev = (R, t)


def long(jp, frames_n):
    jcfg = _jax_config()
    tcfg = smoke._config()
    orbit = synthetic.orbit_poses(smoke.ORBIT_N)
    images = [synthetic.render_box_room(tcfg.working_camera.K, orbit[k], smoke.H, smoke.W)
              for k in range(smoke.LONG_IMAGES)]
    n = frames_n or smoke.LONG_FRAMES
    lcfg = smoke.long_config(jcfg, smoke.LONG_RING)
    slam = smoke.record_skeletons(_jax_engine(jp, lcfg, ba_every=0, enable_loop_closure=True))
    for f in range(n):
        slam.process(images[smoke.img_of(f)])
    slam.close()
    pairs = [(e.frame, e.matched_frame, e.num_inliers) for e in slam.loop_events]
    wrap = smoke.LONG_RING * lcfg.keyframe.max_interval
    gaps = [abs(smoke.img_of(f) - smoke.img_of(m)) for f, m, _ in pairs]
    print(f"[long] JAX, {n} frames, ring {smoke.LONG_RING}: {len(slam.kf_frames)} keyframes, valid "
          f"{sum(s['valid'] for s in slam.stats)}/{len(slam.stats)}; {len(pairs)} loop closures, "
          f"{sum(f > wrap for f, _, _ in pairs)} after frame {wrap}, {sum(f > 3 * wrap for f, _, _ in pairs)} "
          f"after frame {3 * wrap}; image gaps of the pairs: largest {max(gaps, default=None)}, counts "
          f"{dict(sorted((g, gaps.count(g)) for g in set(gaps)))}; pose graph {len(slam.skeletons)} solves, "
          f"{sum(s for *_, s in slam.skeletons)} subsampled", flush=True)
    print(f"[long] JAX loop closures (frame, matched, inliers): {pairs}", flush=True)
    for ok, what in smoke.long_checks(slam, n, lcfg, image_gap=max(gaps, default=1)):
        print(f"[long] JAX check {'holds' if ok else 'FAILS'}: {what}", flush=True)
    stream = smoke.repair_stream(images)
    rcfg = smoke.long_config(jcfg, smoke.LONG_REPAIR_RING)
    P = {}
    for lc in (True, False):
        s = _jax_engine(jp, rcfg, ba_every=0, enable_loop_closure=lc)
        for f in stream:
            s.process(f)
        P[lc] = s.trajectory()[:, :3, 3]
        s.close()
    d_on, d_off = smoke.epoch_drift(P[True]), smoke.epoch_drift(P[False])
    print(f"[long] JAX repair: drift mean {d_on.mean():.4f} m with loop closure, {d_off.mean():.4f} m "
          f"without (ratio {d_on.mean() / d_off.mean():.4f}); max {d_on.max():.4f} / {d_off.max():.4f} m "
          f"(difference {d_on.max() - d_off.max():.4f})", flush=True)


def synthetic_seeds(jp, seeds):
    import test_torch_slam as ts
    from maveric_slam_tpu_torch.utils import evaluation

    frames, gt = ts.orbit(ts.N_ORBIT)
    rows = []
    for seed in range(seeds):
        slam = _jax_engine(jp, ts.JCFG, seed=seed, ba_every=4, enable_loop_closure=True)
        slam.process(frames[0])
        slam.state = slam.state._replace(key=jax.random.PRNGKey(seed))
        for f in frames[1:]:
            slam.process(f)
        full = evaluation.ate(slam.trajectory(), gt)["ate_rmse"]
        odo = evaluation.ate(slam.odometry_trajectory(), gt)["ate_rmse"]
        slam.close()
        rows.append((full, odo))
        print(f"[synthetic] JAX seed {seed}: ATE full {full:.4f} m, odometry {odo:.4f} m; loop closures "
              f"{[(e.frame, e.matched_frame, e.num_inliers) for e in slam.loop_events]}", flush=True)
    full = np.array([r[0] for r in rows])
    odo = np.array([r[1] for r in rows])
    for name, a in (("full", full), ("odometry", odo)):
        print(f"[synthetic] JAX over {seeds} seeds, ATE {name}: median {np.median(a):.4f} m, quartiles "
              f"{np.percentile(a, 25):.4f} / {np.percentile(a, 75):.4f}, min {a.min():.4f}, max "
              f"{a.max():.4f}; all {' '.join(f'{v:.4f}' for v in a)}", flush=True)
    print(f"[synthetic] JAX: full below 0.85 x odometry on {int((full < 0.85 * odo).sum())} of {seeds} "
          f"seeds", flush=True)


def loop_edges(jp, tp, seeds):
    import test_torch_slam as ts
    from maveric_slam_tpu import slam as jslam
    from maveric_slam_tpu_torch import slam as tslam

    frames, _ = ts.orbit(ts.N_ORBIT)
    n = ts.TCFG.frontend.top_n
    verify = jslam._verify_loop_device
    last = {}

    def keep_jax(*a, **k):
        last["out"] = np.asarray(verify(*a, **k))
        return last["out"]

    jslam._verify_loop_device = keep_jax
    try:
        for seed in range(seeds):
            for name in ("JAX", "port"):
                if name == "JAX":
                    s = _jax_engine(jp, ts.JCFG, seed=seed, ba_every=0, enable_loop_closure=True)
                else:
                    s = tslam.SlamSystem(tp, ts.TCFG, seed=seed, ba_every=0, enable_loop_closure=True,
                                         device="cpu")

                    def keep_port(flat, verify_port=s._verify_loop):
                        last["out"] = verify_port(flat)
                        return last["out"]

                    s._verify_loop = keep_port
                close = s._verify_and_close_loop

                def closed(entry, cur_entry, cur, score, s=s, close=close, name=name):
                    ev = close(entry, cur_entry, cur, score)
                    if ev is not None:
                        out = last["out"]
                        inl, z = out[14:14 + n] > 0.5, out[14 + n:14 + 2 * n]
                        good = inl & entry["depth_ok"] & (z > 1e-3) & (z < 1e3) & (entry["depth"] > 0.1)
                        print(f"[loop-edges] {name} seed {seed} ({entry['frame']}, {cur}): inliers "
                              f"{int(inl.sum())}, unit depth <= 1e-3 {int((inl & (z <= 1e-3)).sum())}, "
                              f">= 1e3 {int((inl & (z >= 1e3)).sum())}, scaling points {int(good.sum())}, "
                              f"edge {np.linalg.norm(s.loop_edges[-1][3]):.3f} m", flush=True)
                    return ev

                s._verify_and_close_loop = closed
                s.process(frames[0])
                if name == "JAX":
                    s.state = s.state._replace(key=jax.random.PRNGKey(seed))
                for f in frames[1:]:
                    s.process(f)
    finally:
        jslam._verify_loop_device = verify


def main():
    import argparse

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("what", nargs="*", default=["stream0", "pairwise", "ba", "pose-graph"])
    ap.add_argument("--size", default="96x320", choices=["96x320", "192x640"])
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--fetch-delay", type=int, default=0)
    ap.add_argument("--eager", action="store_true")
    ap.add_argument("--port", action="store_true")
    ap.add_argument("--port-ba", action="store_true")
    ap.add_argument("--jax-order", action="store_true")
    ap.add_argument("--jax-features", action="store_true")
    ap.add_argument("--seeds", type=int, default=1)
    ap.add_argument("--ranks", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--verbose", action="store_true")
    args = ap.parse_args()
    jp, tp = (_params() if {"stream0", "pairwise", "slam", "tracker", "steps", "checkpoint", "degenerate",
                            "long", "synthetic", "loop-edges", "mesh"}
              & set(args.what)
              else (None, None))
    for w in args.what:
        {"stream0": lambda: stream0(jp, tp), "pairwise": lambda: pairwise(jp, tp), "ba": ba,
         "pose-graph": pose_graph,
         "slam": lambda: slam(jp, tp, args.size, args.frames, args.fetch_delay, args.eager,
                              args.port, args.port_ba, args.jax_order),
         "tracker": lambda: tracker(jp, tp, args.seeds),
         "steps": lambda: (track_steps(jp, args.eager) if args.size == "192x640" else
                           steps(jp, tp, args.frames, args.jax_features, args.eager)),
         "mesh": lambda: mesh(jp, args.ranks, args.verbose),
         "checkpoint": lambda: checkpoint(jp, tp, args.fetch_delay or 3),
         "degenerate": lambda: degenerate(jp), "long": lambda: long(jp, args.frames),
         "synthetic": lambda: synthetic_seeds(jp, args.seeds),
         "loop-edges": lambda: loop_edges(jp, tp, args.seeds)}[w]()


if __name__ == "__main__":
    main()

"""The JAX package's own results on chip_smoke.py's scenes, beside the
port's, on the CPU: where chip_smoke.py's bars against ground truth come
from.

    JAX_PLATFORMS=cpu python tools/torch_smoke_vs_jax.py [stream0] [pairwise] [ba] [pose-graph]

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

JAX's RANSAC draws its noise from a PRNG key; here a stand-in for
`jax.random` inside its RANSAC module hands it the port's noise instead, so
that both packages draw the same samples. The noise is a constant of the
trace, so each call recompiles (about a minute a step at 192x640 on 8 cores).
"""

from __future__ import annotations

import dataclasses
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, ROOT)

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
    split(key, K) -> rows 0..K-1 of the minimal noise, fold_in then
    split(., K2) -> rows of the LO noise, gumbel(row) -> that row."""

    def __init__(self, gmin, glo):
        self.table = jnp.asarray(np.concatenate([gmin, glo]))
        self.k = gmin.shape[0]

    def split(self, key, num=2):
        if key.ndim == 0:  # the marker fold_in returned
            return key + jnp.arange(num, dtype=jnp.int32)
        return jnp.arange(num, dtype=jnp.int32)

    def fold_in(self, key, data):
        return jnp.asarray(self.k, jnp.int32)

    def gumbel(self, k, shape):
        return self.table[k]


class _Jax:
    def __init__(self, random):
        self.random = random

    def __getattr__(self, name):
        return getattr(jax, name)


def _inject(gmin, glo):
    """JAX's RANSAC draws (gmin, glo) from its next trace on."""
    jransac.jax = _Jax(_Random(np.asarray(gmin), np.asarray(glo)))
    jax.clear_caches()


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


def main():
    what = sys.argv[1:] or ["stream0", "pairwise", "ba", "pose-graph"]
    jp, tp = _params() if {"stream0", "pairwise"} & set(what) else (None, None)
    for w in what:
        {"stream0": lambda: stream0(jp, tp), "pairwise": lambda: pairwise(jp, tp), "ba": ba,
         "pose-graph": pose_graph}[w]()


if __name__ == "__main__":
    main()

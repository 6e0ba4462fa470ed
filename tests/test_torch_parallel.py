"""The port's sharded layer on torch.distributed against the JAX package's
sharded functions (tests/test_parallel.py's cases).

The port's side runs in 1, 2 and 4 ranks on the CPU (gloo), started by
`parallel.mesh.spawn` with one thread each; the ranks import neither JAX
nor the JAX package (tests/torch_mesh_worker.py). The JAX side runs here on
conftest's virtual CPU devices, on meshes of the same shapes (1, 2 and 4
devices, and 2 x 2 over ("host", "chip")), with the same numpy inputs.

Bars: tests/test_parallel.py's. Sharded BA: R atol 1e-4, t atol 1e-3,
per-iteration cost rtol 1e-3 (the same math, another reduction order);
on one rank it is the port's single-device `bundle_adjust` bit for bit.
The LCD ring, the query and the word-sharded pool are exact. The stream-
sharded step (`make_stream_mesh`, `track_step_sharded`; 4 streams over 1,
2 and 4 ranks, JAX's noise injected): rotation < 0.05 deg, cos t > 0.99999,
inliers within 3, and bitwise the unsharded step. The sharded pool evicts
through the port's `sharded_pool.remove_old`. All ranks return the same
bytes.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from maveric_slam_tpu import config as jconfig
from maveric_slam_tpu.backend import ba as jba
from maveric_slam_tpu.frontend import tracker as jtracker
from maveric_slam_tpu.loopclosure import lcd as jlcd
from maveric_slam_tpu.loopclosure import sharded_lcd as jsharded_lcd
from maveric_slam_tpu.mapping import feature_pool as jpool
from maveric_slam_tpu.mapping import sharded_pool as jsharded_pool
from maveric_slam_tpu.models import superpoint as jsp
from maveric_slam_tpu.parallel import mesh as jmesh
from maveric_slam_tpu.parallel import sharded_ba as jsharded_ba
from maveric_slam_tpu.parallel import sharded_tracker as jsharded_tracker
from maveric_slam_tpu_torch import config as tconfig
from maveric_slam_tpu_torch.frontend import tracker as ttracker
from maveric_slam_tpu_torch.models import superpoint as tsp
from maveric_slam_tpu_torch.loopclosure.sharded_lcd import FRAME_AXIS
from maveric_slam_tpu_torch.mapping.sharded_pool import WORD_AXIS
from maveric_slam_tpu_torch.parallel import mesh as tmesh
from maveric_slam_tpu_torch.parallel.sharded_tracker import STREAM_AXIS
import torch_mesh_worker as worker
from test_ba import make_ba_problem, reproj_rmse
from test_torch_batched import _frames, _noise
from test_torch_tracker import _config
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

SPAWN_TIMEOUT_S = 240  # the ranks of one world size, all cases
# name: (seed, landmarks, iterations, pixel noise, mesh shape, axes), as in tests/test_parallel.py
BA_CASES = {
    "matches": (17, 64, 6, 0.5, 4, "ldmk"),
    "converges": (18, 128, 8, 0.3, 4, "ldmk"),
    "sizes_1": (19, 32, 3, 0.5, 1, "ldmk"),
    "sizes_2": (19, 32, 3, 0.5, 2, "ldmk"),
    "sizes_4": (19, 32, 3, 0.5, 4, "ldmk"),
    "host_chip": (20, 64, 4, 0.5, (2, 2), ("host", "chip")),
}
WORLDS = (1, 2, 4)
STREAM_PHASES = (0, 24, 48, 72)  # the sharded step's 4 streams: orbit frames k -> k + 1


def _world(shape):
    return int(np.prod(shape))


def _ba_problem(case):
    seed, landmarks, _, noise, _, _ = BA_CASES[case]
    problem, _ = make_ba_problem(np.random.default_rng(seed), num_landmarks=landmarks,
                                 pixel_noise=noise)
    return tuple(np.asarray(a) for a in problem)


def _lcd_sets(seed, frames, vocab, size):
    rng = np.random.default_rng(seed)
    return [rng.choice(vocab, size, replace=False).astype(np.int32) for _ in range(frames)]


RING = dict(frame_sets=_lcd_sets(29, 32 + 5, 1024, 48), cap=32, vocab=1024)
QUERY_SETS = _lcd_sets(23, 64 + 9, 2048, 64)
QUERY_SETS[40] = QUERY_SETS[10]  # a tie across shards: the lower slot (10) must win
QUERY = dict(frame_sets=QUERY_SETS, cap=64, vocab=2048,
             probes=[QUERY_SETS[63], QUERY_SETS[67], QUERY_SETS[20], QUERY_SETS[10]],
             current=64 + 9, gap=4, min_score=0.2)


def _pool_inputs():
    rng = np.random.default_rng(31)
    frames, queries = [], []
    for _ in range(12):
        frames.append(rng.integers(-1, 2048, (96,)).astype(np.int32))
        queries.append(rng.integers(-1, 2048, (64,)).astype(np.int32))
    return dict(frames=frames, queries=queries, vocab=2048, window=4)


POOL = _pool_inputs()


@pytest.fixture(scope="module")
def stream_inputs():
    """(images0, images1, gumbel_min, gumbel_lo, JAX's sharded step): four
    streams' first two frames and the noise JAX's step draws for them."""
    jcfg, tcfg = _config(jconfig), _config(tconfig)
    imgs0 = np.stack([_frames([k])[0] for k in STREAM_PHASES])
    imgs1 = np.stack([_frames([k + 1])[0] for k in STREAM_PHASES])
    jp = jsp.load_params()
    states = jtracker.init_states_batched(jp, jnp.asarray(imgs0), jcfg)
    noise = [_noise(jnp.asarray(k), tcfg)[:2] for k in np.asarray(states.key)]
    smesh = jsharded_tracker.make_stream_mesh(len(STREAM_PHASES))
    states, imgs1_sh = jsharded_tracker.shard_streams(states, jnp.asarray(imgs1), smesh)
    _, step = jsharded_tracker.track_step_sharded(
        jsharded_tracker.replicate_params(jp, smesh), states, imgs1_sh, jcfg)
    return (imgs0, imgs1, np.stack([n[0] for n in noise]), np.stack([n[1] for n in noise]),
            jax.tree_util.tree_map(np.asarray, step))


def _spec(world, stream_inputs):
    spec = {f"ba_{c}": ("solve_ba", BA_CASES[c][4], BA_CASES[c][5],
                        dict(problem=_ba_problem(c), iterations=BA_CASES[c][2]))
            for c in BA_CASES if _world(BA_CASES[c][4]) == world}
    spec["ring"] = ("lcd_ring", world, FRAME_AXIS, RING)
    spec["query"] = ("lcd_queries", world, FRAME_AXIS, QUERY)
    spec["pool"] = ("pool_run", world, WORD_AXIS, POOL)
    if world == 1:
        spec["single_sizes_1"] = ("single_ba", 1, "ldmk",
                                  dict(problem=_ba_problem("sizes_1"), iterations=3))
    imgs0, imgs1, gmin, glo, _ = stream_inputs
    spec["tracker"] = ("tracker_step", world, STREAM_AXIS,
                       dict(config=_config(tconfig), images0=imgs0, images1=imgs1,
                            gumbel_min=gmin, gumbel_lo=glo))
    return spec


@pytest.fixture(scope="module")
def ranks(stream_inputs):
    """{world size: every rank's results}, each world spawned once."""
    cache = {}

    def get(world):
        if world not in cache:
            cache[world] = tmesh.spawn(worker.components, world, args=(_spec(world, stream_inputs),),
                                       device="cpu", threads=1, timeout_s=SPAWN_TIMEOUT_S)
        return cache[world]
    return get


def _jax_mesh(shape, axes):
    devices = np.array(jax.devices()[:_world(shape)])
    if isinstance(shape, tuple):
        return JaxMesh(devices.reshape(shape), axes)
    return jmesh.make_mesh(shape, axis=axes)


@pytest.mark.parametrize("case", list(BA_CASES))
def test_sharded_ba_matches_jax(ranks, case):
    seed, _, iters, _, shape, axes = BA_CASES[case]
    problem = _ba_problem(case)
    mesh = _jax_mesh(shape, axes)
    want, costs = jsharded_ba.sharded_bundle_adjust(
        jsharded_ba.shard_problem(jba.BAProblem(*problem), mesh), mesh, iterations=iters)
    got = ranks(_world(shape))[0][f"ba_{case}"]
    np.testing.assert_allclose(got["R"], np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(got["t"], np.asarray(want.t), atol=1e-3)
    np.testing.assert_allclose(got["cost"], np.asarray(costs), rtol=1e-3)
    assert np.isfinite(got["X"]).all() and got["cost"][-1] < got["cost"][0]
    if case == "converges":
        before = reproj_rmse(jba.BAProblem(*problem))
        after = reproj_rmse(jba.BAProblem(problem[0], got["R"], got["t"], got["X"], *problem[4:]))
        assert after < before / 5 and after < 0.8, (before, after)


def test_sharded_ba_on_one_rank_is_single_device(ranks):
    """On a mesh of one rank the sharded iteration is bundle_adjust's,
    operation for operation: equal bit for bit."""
    r = ranks(1)[0]
    for k in ("R", "t", "X", "cost"):
        np.testing.assert_array_equal(r["ba_sizes_1"][k], r["single_sizes_1"][k], k)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_ring_matches_jax(ranks, world):
    """The database built only through sharded_add_frame (the ring wraps)
    equals JAX's sharded build, row for row."""
    mesh = jmesh.make_mesh(world, axis=jsharded_lcd.FRAME_AXIS)
    db = jsharded_lcd.shard_database(jlcd.create_database(RING["cap"], RING["vocab"]), mesh)
    for f, ids in enumerate(RING["frame_sets"]):
        db = jsharded_lcd.sharded_add_frame(db, jnp.asarray(ids), jnp.int32(f), mesh)
    got = ranks(world)[0]["ring"]
    for name in ("multihot", "counts", "frames", "valid"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(db, name)), name)
    assert got["next_slot"] == int(db.next_slot)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_query_matches_jax(ranks, world):
    """Slot, frame and score equal to JAX's sharded query, the tie across
    shards included (the lower global slot)."""
    db = jlcd.create_database(QUERY["cap"], QUERY["vocab"])
    for f, ids in enumerate(QUERY["frame_sets"]):
        db = jlcd.add_frame(db, jnp.asarray(ids), jnp.int32(f))
    mesh = jmesh.make_mesh(world, axis=jsharded_lcd.FRAME_AXIS)
    sdb = jsharded_lcd.shard_database(db, mesh)
    want = []
    for ids in QUERY["probes"]:
        r = jsharded_lcd.sharded_query(sdb, jnp.asarray(ids), mesh, jnp.int32(QUERY["current"]),
                                       min_frame_gap=QUERY["gap"], min_score=QUERY["min_score"])
        want.append((int(r.best), int(r.best_frame), float(r.best_score)))
    assert ranks(world)[0]["query"] == want
    assert want[-1][:2] == (10, 10)


@pytest.mark.parametrize("world", WORLDS)
def test_sharded_pool_matches_jax(ranks, world):
    """observe_batch / remove_old / covisibility_weights on the word-sharded
    pool: every frame's weights and the final tables equal JAX's."""
    mesh = jmesh.make_mesh(world, axis=jsharded_pool.WORD_AXIS)
    pool = jsharded_pool.shard_pool(jpool.create(POOL["vocab"], window=POOL["window"]), mesh)
    got = ranks(world)[0]["pool"]
    for f, (ids, q) in enumerate(zip(POOL["frames"], POOL["queries"])):
        pool = jsharded_pool.observe_batch(pool, jnp.asarray(ids), f, mesh)
        pool = jsharded_pool.remove_old(pool, f, mesh)
        want = jsharded_pool.covisibility_weights(pool, jnp.asarray(q), mesh)
        np.testing.assert_array_equal(got["weights"][f], np.asarray(want), str(f))
    for name in ("first_seen", "last_seen", "num_sightings"):
        np.testing.assert_array_equal(got[name], np.asarray(getattr(pool, name)), name)
    assert got["invariant"] == 0


def _rot_deg(R, R_ref):
    """The angle of R R_ref^T, from its skew and symmetric parts in f64. The
    arccos of (trace - 1) / 2 alone reads an f32 rotation's own departure
    from orthonormality (~1e-7) as 0.03-0.06 deg, even against itself."""
    dR = np.asarray(R, np.float64) @ np.asarray(R_ref, np.float64).T
    w = np.array([dR[2, 1] - dR[1, 2], dR[0, 2] - dR[2, 0], dR[1, 0] - dR[0, 1]]) / 2.0
    return float(np.degrees(np.arctan2(np.linalg.norm(w), (np.trace(dR) - 1.0) / 2.0)))


def _assert_streams_close(got, want):
    for k in range(len(want["R"])):
        assert _rot_deg(got["R"][k], want["R"][k]) < 0.05, (k, _rot_deg(got["R"][k], want["R"][k]))
        t, tr = got["t"][k].astype(np.float64), np.asarray(want["t"][k], np.float64)
        cos_t = np.dot(t, tr) / (np.linalg.norm(t) * np.linalg.norm(tr) + 1e-12)
        assert cos_t > 0.99999, (k, cos_t)
    d_inl = np.abs(got["num_inliers"].astype(np.int64) - np.asarray(want["num_inliers"], np.int64))
    assert d_inl.max() <= 3, d_inl


@pytest.fixture(scope="module")
def unsharded_step(stream_inputs):
    """The port's `track_step_batched` over the four streams in one process
    (one thread, as the ranks), the same noise injected."""
    imgs0, imgs1, gmin, glo, _ = stream_inputs
    tcfg = _config(tconfig)
    params = tsp.load_params(device="cpu")
    states = ttracker.init_states_batched(params, torch.from_numpy(imgs0), tcfg)
    _, step = ttracker.track_step_batched(params, states, torch.from_numpy(imgs1), tcfg,
                                          torch.from_numpy(gmin), torch.from_numpy(glo))
    return step


def _check_sharded_step(got, want, unsharded):
    assert got["axes"] == [STREAM_AXIS]
    assert got["valid"].all()
    _assert_streams_close(got, want._asdict())
    for f in ("R", "t", "valid", "num_matches", "num_inliers"):
        np.testing.assert_array_equal(got[f], getattr(unsharded, f).numpy(), f)


def test_sharded_tracker_matches_jax(ranks, stream_inputs, unsharded_step):
    """The stream-sharded step (`make_stream_mesh`, `track_step_sharded`;
    one stream a rank) against JAX's stream-sharded step on a 4-device mesh
    at the bars, and equal to the port's unsharded `track_step_batched` on
    the same noise (a stream alone is its row of the batch, bit for bit, on
    the CPU)."""
    _check_sharded_step(ranks(len(STREAM_PHASES))[0]["tracker"], stream_inputs[-1], unsharded_step)


@pytest.mark.parametrize("world", (1, 2))
def test_track_step_sharded_at_fewer_ranks(ranks, stream_inputs, unsharded_step, world):
    """The same step with 4 and 2 streams a rank: the stream mesh over 1
    and 2 ranks, against JAX's at the bars and bitwise equal to the
    unsharded step."""
    _check_sharded_step(ranks(world)[0]["tracker"], stream_inputs[-1], unsharded_step)


def test_host_chip_mesh_flattens_in_rank_order(ranks):
    """A (2, 2) ("host", "chip") mesh: rank r sits at (r // 2, r % 2)."""
    got = [r["axis_index"]["ba_host_chip"] for r in ranks(4)]
    assert got == [[r // 2, r % 2] for r in range(4)]


@pytest.mark.parametrize("world", WORLDS)
def test_ranks_return_the_same_bytes(ranks, world):
    """Every rank holds the same replicated results (poses, costs, gathered
    blocks, query answers)."""
    first, *rest = ranks(world)
    assert [r["rank"] for r in ranks(world)] == list(range(world))
    assert all(r["jax_modules"] == [] for r in ranks(world))  # the ranks import no JAX
    for other in rest:
        for name, value in first.items():
            if name in ("rank", "axis_index", "jax_modules"):
                continue
            a, b = (jax.tree_util.tree_leaves(v) for v in (value, other[name]))
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b)), name

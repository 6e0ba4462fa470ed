"""The multi-stream tracking path (`init_states_batched`,
`track_step_batched`) against the JAX package, on synthetic 96x320 orbit
frames.

The JAX package gives stream s of `init_states_batched` PRNGKey(s) and the
tracker splits each stream's key once per step; the tests rebuild that noise
with `jax_ransac_noise` (tests/test_torch_tracker.py) and pass it to the
port, so both packages draw the same RANSAC samples. The pose bar is PR 1's:
twice JAX's own jit-vs-eager spread on the same step, or 1e-4 where that
spread is smaller.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maveric_slam_tpu import config as jconfig
from maveric_slam_tpu.frontend import tracker as jtracker
from maveric_slam_tpu.models import superpoint as jsp
from maveric_slam_tpu_torch import config as tconfig
from maveric_slam_tpu_torch.data import synthetic
from maveric_slam_tpu_torch.frontend import tracker as ttracker
from maveric_slam_tpu_torch.geometry import ransac
from maveric_slam_tpu_torch.models import superpoint as tsp
from jax_spread import eagerly, relative, within_jax_spread
from test_torch_tracker import H, W, _config, jax_ransac_noise
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

STREAM_FRAMES = ([0, 1, 2], [48, 49, 50])  # two streams at two phases of the orbit


def _frames(ids):
    K = _config(tconfig).working_camera.K
    poses = synthetic.orbit_poses(96)
    return np.stack([synthetic.render_box_room(K, poses[k], H, W) for k in ids])


def _noise(key, cfg):
    m, n_hyp = cfg.frontend.top_n, cfg.ransac.num_hypotheses
    return jax_ransac_noise(key, n_hyp, ransac.lo_hypotheses(n_hyp), m)


def _port_states(jstate, batched):
    """The port's TrackerState holding a JAX (batched) TrackerState's values."""
    fields = {f: torch.from_numpy(np.array(getattr(jstate, f)))
              for f in ttracker.TrackerState._fields if f != "generator"}
    gens = tuple(torch.Generator() for _ in range(len(jstate.desc))) if batched else torch.Generator()
    return ttracker.TrackerState(**fields, generator=gens)


@pytest.fixture(scope="module")
def params():
    jp = jsp.load_params()
    return jp, tsp.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


@pytest.fixture(scope="module")
def batched(params):
    """Per step, from JAX's batched state before it: JAX's batched step
    jitted, and eagerly as a callable run on first need (the spread), the
    port's batched step and each stream's single port step, all on JAX's
    noise; plus the port's own chain of batched states."""
    jp, tp = params
    jcfg, tcfg = _config(jconfig), _config(tconfig)
    seq = np.stack([_frames(ids) for ids in STREAM_FRAMES], axis=1)  # (T, S, H, W)
    jstates = jtracker.init_states_batched(jp, jnp.asarray(seq[0]), jcfg)
    init_j = jax.tree_util.tree_map(np.array, jstates)
    chain = ttracker.init_states_batched(tp, torch.from_numpy(seq[0]), tcfg)
    init_t = chain
    steps = []
    for imgs in seq[1:]:
        snap = jax.tree_util.tree_map(np.array, jstates)
        noise = [_noise(jnp.asarray(k), tcfg)[:2] for k in snap.key]
        gmin = torch.from_numpy(np.stack([n[0] for n in noise]))
        glo = torch.from_numpy(np.stack([n[1] for n in noise]))
        jstates, jit = jtracker.track_step_batched(jp, jstates, jnp.asarray(imgs), jcfg)
        eager = eagerly(jtracker.track_step_batched, jp, jax.tree_util.tree_map(jnp.asarray, snap),
                        jnp.asarray(imgs), jcfg)
        _, port = ttracker.track_step_batched(
            tp, _port_states(snap, True), torch.from_numpy(imgs), tcfg, gmin, glo)
        single = [ttracker.track_step(tp, ttracker._stream(_port_states(snap, True), s),
                                      torch.from_numpy(imgs[s]), tcfg, gmin[s], glo[s])[1]
                  for s in range(len(imgs))]
        chain, chained = ttracker.track_step_batched(tp, chain, torch.from_numpy(imgs), tcfg,
                                                     gmin, glo)
        steps.append((jit, eager, port, single, chained))
    return init_j, init_t, steps


def test_init_states_batched_equal(batched):
    init_j, init_t, _ = batched
    np.testing.assert_array_equal(init_t.desc.numpy(), init_j.desc)
    np.testing.assert_array_equal(init_t.indices.numpy(), init_j.indices)
    np.testing.assert_allclose(init_t.probs.numpy(), init_j.probs, rtol=1e-6)
    v = init_j.indices != 64
    np.testing.assert_allclose(init_t.xy.numpy()[v], init_j.xy[v], atol=1e-3)
    assert [g.initial_seed() for g in init_t.generator] == [0, 1]
    np.testing.assert_array_equal(
        init_j.key, np.stack([np.asarray(jax.random.PRNGKey(s)) for s in range(2)]))


def test_batched_step_counts_exact(batched):
    """From the same states (and matches and inliers along the port's own
    chain of states, whose depths differ from JAX's within the pose bar)."""
    for jit, _, port, _, chained in batched[2]:
        for f in ("valid", "num_matches", "num_inliers", "num_scale_pairs"):
            np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(jit, f)), f)
            if f != "num_scale_pairs":
                np.testing.assert_array_equal(getattr(chained, f).numpy(),
                                              np.asarray(getattr(jit, f)), f)
        assert np.all(np.asarray(jit.valid)) and np.all(np.asarray(jit.num_matches) >= 8)


def test_batched_step_poses_within_reference_spread(batched):
    """PR 1's bar over the batched step's whole output, as PR 1 took it
    over the step's: on frames 49 -> 50 the port's weighted refit picks
    another of three candidates whose MSAC scores lie within 3e-4 of each
    other, so R moves by 1.6e-4 on that stream while JAX's jit and eager
    steps agree there and differ by 4.9e-4 on the other stream."""
    for jit, eager, port, _, _ in batched[2]:
        within_jax_spread(port, jit, lambda: eager()[1], relative(1e-4), ("R", "t"))


def test_batched_equals_single_streams(batched):
    for _, _, port, single, _ in batched[2]:
        for s, one in enumerate(single):
            for f in ("valid", "num_matches", "num_inliers", "num_scale_pairs"):
                assert int(getattr(port, f)[s]) == int(getattr(one, f)), f
            for f in ("R", "t"):
                torch.testing.assert_close(getattr(port, f)[s], getattr(one, f), rtol=0, atol=1e-5)


def test_batched_generators_match_single_seeds(params):
    """Without injected noise, stream s of a batch draws what a single
    stream seeded s draws."""
    _, tp = params
    tcfg = _config(tconfig)
    seq = np.stack([_frames(ids[:2]) for ids in STREAM_FRAMES], axis=1)
    states = ttracker.init_states_batched(tp, torch.from_numpy(seq[0]), tcfg)
    _, res = ttracker.track_step_batched(tp, states, torch.from_numpy(seq[1]), tcfg)
    for s in range(2):
        tr = ttracker.Tracker(tp, tcfg, seed=s, device="cpu")
        tr.process(seq[0, s])
        one = tr.process(seq[1, s])
        torch.testing.assert_close(res.R[s], one.R, rtol=0, atol=1e-5)
        assert int(res.num_inliers[s]) == int(one.num_inliers)

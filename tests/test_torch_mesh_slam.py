"""The port's mesh-mode SlamSystem (4 ranks, gloo, on the CPU) against the
port's single-device engine and against the JAX package's mesh-mode
engine on a 4-device mesh, over tests/test_torch_slam.py's 96x320 orbit,
frames 0-12 (BA windows at frames 4, 8 and 12), the JAX engine's noise fed
to the port.

Bars:
- against the single-device port: every frame's word ids and sighting
  table exact, the same keyframes and BA windows, every position within
  1e-3 (ROADMAP item 13's bar). The mesh sums the window BA's reduced
  system in 4 blocks: on this scene it lands 2.9e-4 from the single
  engine, whose own trajectory moves by 2.2e-4 to 1.0e-3 when only the
  order of the landmarks in each BA problem changes (6 orders; `python
  tools/torch_mesh_spread.py --scene test`; ROADMAP Faults (o));
- against JAX's mesh engine: tests/test_torch_slam.py's frames-0-12 bars
  (counts, (cell, word) pairs and sightings exact, odometry within twice
  JAX's own jit/eager spread);
- every rank returns the same bytes; on a mesh of one rank the engine is
  the single-device engine bit for bit.
The ranks import neither JAX nor the JAX package (tests/torch_mesh_worker.py).
"""

import numpy as np
import pytest

from maveric_slam_tpu import slam as jslam
from maveric_slam_tpu.loopclosure import vocab as jvocab
from maveric_slam_tpu.models import superpoint as jsp
from maveric_slam_tpu.parallel import mesh as jmesh
from maveric_slam_tpu_torch.parallel import mesh as tmesh
import torch_mesh_worker as worker
from test_torch_loopclosure import jax_vocabulary
from test_torch_slam import (JCFG, N_PARITY, SPREAD_R, SPREAD_T, TCFG, _recorded, _word_pairs,
                             jax_engine_noise, orbit)
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

RANKS = 4
SPAWN_TIMEOUT_S = 300


def scene():
    """(frames, each step's tracking noise, each verification's noise)."""
    frames, _ = orbit(N_PARITY)
    steps, verifications = jax_engine_noise(N_PARITY - 1, 64)
    return frames, steps, verifications


@pytest.fixture(scope="module")
def runs():
    """The port alone (one thread, as the ranks), the port's mesh engine on
    4 ranks and on 1, and the JAX mesh engine on 4 devices."""
    frames, steps, verifications = scene()
    single = worker.engine(TCFG, frames, steps, verifications)
    mesh = {n: tmesh.spawn(worker.mesh_engine, n, args=(TCFG, frames, steps, verifications),
                           device="cpu", threads=1, timeout_s=SPAWN_TIMEOUT_S)
            for n in (RANKS, 1)}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvocab, "load_reference_vocabulary", jax_vocabulary)
        jax_mesh = _recorded(jslam.SlamSystem(jsp.load_params(), JCFG, ba_every=4,
                                              enable_loop_closure=True, mesh=jmesh.make_mesh(RANKS)))
        for f in frames:
            jax_mesh.process(f)
        jax_mesh.close()
    return single, mesh, jax_mesh


def test_mesh_engine_matches_single_device(runs):
    single, mesh, _ = runs
    m = mesh[RANKS][0]
    assert len(m["views"]) == len(single["views"]) == N_PARITY - 1
    for k, (a, b) in enumerate(zip(m["views"], single["views"])):
        for name in ("word_ids", "sightings", "cells_new", "num_matches", "num_inliers", "valid"):
            np.testing.assert_array_equal(a[name], b[name], f"frame {k + 1} {name}")
    assert m["windows"] == single["windows"] == [4, 8, 12]
    assert m["kf_frames"] == single["kf_frames"] and m["loops"] == single["loops"]
    gap = np.abs(m["poses"][:, :3, 3] - single["poses"][:, :3, 3]).max()
    assert gap <= 1e-3, gap
    assert m["next_slot"] == len(single["kf_frames"]) - 1  # keyframes entered the sharded ring


def test_mesh_engine_matches_jax_mesh_engine(runs):
    """tests/test_torch_slam.py's frames-0-12 bars, against JAX's engine
    with mesh=make_mesh(4)."""
    _, mesh, j = runs
    m = mesh[RANKS][0]
    assert len(j.views) == len(m["views"])
    for k, (a, b) in enumerate(zip(j.views, m["views"])):
        for name in ("num_matches", "num_inliers", "valid"):
            assert int(getattr(a, name)) == int(b[name]), (k, name)
        assert _word_pairs(a) == _word_pairs(_View(b)), k
        np.testing.assert_array_equal(a.sightings, b["sightings"], str(k))
    assert j.kf_frames == m["kf_frames"]
    assert [s["inliers"] for s in j.stats] == [s["inliers"] for s in m["stats"]]
    for k, ((jR, jt), (tR, tt)) in enumerate(zip(j.rel_poses, m["rel"])):
        assert np.abs(tR - jR).max() <= 2 * SPREAD_R, (k, np.abs(tR - jR).max())
        assert np.abs(tt - jt).max() <= 2 * SPREAD_T, (k, np.abs(tt - jt).max())


class _View:
    def __init__(self, d):
        self.__dict__.update(d)


def test_mesh_ranks_bitwise_equal(runs):
    _, mesh, _ = runs
    first, *rest = mesh[RANKS]
    for other in rest:
        for name in ("poses", "windows", "kf_frames", "loops", "next_slot", "stats"):
            assert np.array_equal(np.asarray(other[name]), np.asarray(first[name])), name
        for a, b in zip(other["views"], first["views"]):
            assert all(np.array_equal(a[n], b[n]) for n in a)
        assert all(np.array_equal(x, y) for p, q in zip(other["rel"], first["rel"])
                   for x, y in zip(p, q))


def test_mesh_engine_on_one_rank_is_single_device(runs):
    """On a mesh of one rank nothing is split: the same sums in the same
    order, so the trajectory is the single-device engine's bit for bit."""
    single, mesh, _ = runs
    one = mesh[1][0]
    np.testing.assert_array_equal(one["poses"], single["poses"])
    assert one["windows"] == single["windows"] and one["loops"] == single["loops"]


"""`ransac_essential(..., lo_rounds=R)` of the port against the JAX
package's on the CPU, with JAX's own noise.

The inputs are tests/test_torch_pairwise.py's: the golden features of orbit
frames 0 and 1 (and 0 and 4) at 96x320, matched one way by best dot; every
correspondence (M = 1000, the pairwise path's) and the first 100 of them
(M = 100, the tracker's). JAX draws LO round r's resamples from
split(fold_in(key, 1 + r), lo_k) (geometry/ransac.py:110-127); the port is
given those rows as its (lo_rounds, lo_k, M) `gumbel_lo`.

Bars (tests/test_torch_pairwise.py's, ROADMAP.md Faults (c)): inlier counts
equal; R and t within twice JAX's own jitted-vs-eager spread, or 1e-4 where
the spread is smaller. `lo_rounds=1` is bitwise the call without it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maveric_slam_tpu.frontend import extractor as jextractor
from maveric_slam_tpu.geometry import epipolar as jepipolar
from maveric_slam_tpu.geometry import ransac as jransac
from maveric_slam_tpu.models import superpoint as jsp
from maveric_slam_tpu.ops import matching as jmatching
from maveric_slam_tpu_torch.data import synthetic
from maveric_slam_tpu_torch.geometry import ransac as transac
from jax_spread import eagerly, within_jax_spread
from test_torch_pairwise import H, JCFG, TCFG, W
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

N_HYP = TCFG.ransac.num_hypotheses
LO_K = transac.lo_hypotheses(N_HYP)
THRESH = TCFG.ransac.inlier_thresh
PAIRS = ((0, 1), (0, 4))
SIZES = (1000, 100)  # the pairwise path's M, the tracker's


@pytest.fixture(scope="module")
def inputs():
    """{(pair, M): (p1, p2, mask)} in normalized coordinates, numpy."""
    poses = synthetic.orbit_poses(96)
    jp = jsp.load_params()
    K = jnp.asarray(JCFG.working_camera.K)
    feats = {k: jextractor.extract_golden(
        jp, jnp.asarray(synthetic.render_box_room(TCFG.working_camera.K, poses[k], H, W)), JCFG)
        for k in (0, 1, 4)}
    out = {}
    for a, b in PAIRS:
        m = jmatching.nn_match_dot(feats[a].desc, feats[b].desc, feats[a].mask, feats[b].mask,
                                   dot_thresh=JCFG.matcher.dot_thresh)
        p1 = np.asarray(jepipolar.normalize_points(feats[a].xy, K))
        p2 = np.asarray(jepipolar.normalize_points(feats[b].xy[m.index], K))
        mask = np.asarray(m.mask)
        for size in SIZES:
            out[(a, b), size] = (p1[:size], p2[:size], mask[:size])
    return out


def jax_lo_noise(key, rounds, m):
    """(gumbel_min (N_HYP, m), gumbel_lo (rounds, LO_K, m)) as JAX's
    `ransac_essential(key, ..., lo_rounds=rounds)` draws them."""
    g = jax.vmap(lambda kk: jax.random.gumbel(kk, (m,)))
    return (np.array(g(jax.random.split(key, N_HYP))),
            np.stack([np.array(g(jax.random.split(jax.random.fold_in(key, 1 + r), LO_K)))
                      for r in range(rounds)]))


def _port(p1, p2, mask, **kw):
    return transac.ransac_essential(torch.from_numpy(p1), torch.from_numpy(p2),
                                    torch.from_numpy(mask), THRESH, num_hypotheses=N_HYP, **kw)


@pytest.mark.parametrize("rounds", (2, 3))
@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("pair", PAIRS)
def test_lo_rounds_match_jax(inputs, pair, size, rounds):
    p1, p2, mask = inputs[pair, size]
    assert mask.sum() > 30
    key = jax.random.PRNGKey(11 + rounds)
    args = (key, jnp.asarray(p1), jnp.asarray(p2), jnp.asarray(mask), THRESH)
    want = jransac.ransac_essential(*args, num_hypotheses=N_HYP, lo_rounds=rounds)
    gmin, glo = jax_lo_noise(key, rounds, size)
    got = _port(p1, p2, mask, lo_rounds=rounds, gumbel_min=torch.from_numpy(gmin),
                gumbel_lo=torch.from_numpy(glo))
    assert int(got.num_inliers) == int(want.num_inliers) > 20
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    within_jax_spread(got, want, eagerly(jransac.ransac_essential, *args, num_hypotheses=N_HYP,
                                         lo_rounds=rounds), 1e-4, ("R", "t"))


@pytest.mark.parametrize("size", SIZES)
def test_one_lo_round_is_the_default(inputs, size):
    """lo_rounds=1 with (LO_K, M) noise is the call without the argument,
    bit for bit; the same rows given as (1, LO_K, M) raise, as any other
    shape does."""
    p1, p2, mask = inputs[(0, 1), size]
    gmin, glo = jax_lo_noise(jax.random.PRNGKey(5), 1, size)
    noise = dict(gumbel_min=torch.from_numpy(gmin), gumbel_lo=torch.from_numpy(glo[0]))
    a, b = _port(p1, p2, mask, **noise), _port(p1, p2, mask, lo_rounds=1, **noise)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="Gumbel noise must be"):
        _port(p1, p2, mask, lo_rounds=1, gumbel_min=noise["gumbel_min"],
              gumbel_lo=torch.from_numpy(glo))
    with pytest.raises(ValueError, match="Gumbel noise must be"):
        _port(p1, p2, mask, lo_rounds=2, **noise)


def test_each_lo_round_draws_its_own_rows(inputs):
    """Round r takes row block r of `gumbel_lo`: with the first block given
    twice the result differs from the run with two blocks of its own on
    some input here."""
    moved = 0
    for p1, p2, mask in inputs.values():
        gmin, glo = jax_lo_noise(jax.random.PRNGKey(13), 2, p1.shape[0])
        again = _port(p1, p2, mask, lo_rounds=2, gumbel_min=torch.from_numpy(gmin),
                      gumbel_lo=torch.from_numpy(np.stack([glo[0], glo[0]])))
        own = _port(p1, p2, mask, lo_rounds=2, gumbel_min=torch.from_numpy(gmin),
                    gumbel_lo=torch.from_numpy(glo))
        moved += not torch.equal(again.E, own.E)
    assert moved > 0

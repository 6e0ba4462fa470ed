"""The chunked tracking path (`track_chunk`, `PipelinedTracker`) against
the JAX package and against the port's own `track_step`, on synthetic
96x320 orbit frames, with JAX's RANSAC noise (see tests/test_torch_batched.py).
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
from maveric_slam_tpu_torch.frontend import tracker as ttracker
from maveric_slam_tpu_torch.geometry import ransac
from maveric_slam_tpu_torch.models import superpoint as tsp
from jax_spread import eagerly, relative, within_jax_chain_spread
from test_torch_batched import _frames, _noise, _port_states
from test_torch_tracker import _config
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

CHUNK_FRAMES = [0, 1, 2, 3]  # an initial frame and one chunk of K = 3


@pytest.fixture(scope="module")
def params():
    jp = jsp.load_params()
    return jp, tsp.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")


def _jax_chain(jp, state, frames, jcfg):
    """JAX's track_step over the frames, each from the last's state."""
    out = []
    for f in frames:
        state, step = jtracker.track_step(jp, state, f, jcfg)
        out.append(step)
    return out


@pytest.fixture(scope="module")
def chunked(params):
    """JAX's track_chunk at K = 3 and its eager per-step chain (a callable
    run on first need); the port's track_chunk and K chained port
    track_step calls; all from JAX's initial state, on JAX's noise."""
    jp, tp = params
    jcfg, tcfg = _config(jconfig), _config(tconfig)
    frames = _frames(CHUNK_FRAMES)
    state = jtracker.init_state(jp, jnp.asarray(frames[0]), jcfg, 0)
    snap = jax.tree_util.tree_map(np.array, state)
    key, noise = jnp.asarray(snap.key), []
    for _ in frames[1:]:
        gmin, glo, key = _noise(key, tcfg)
        noise.append((torch.from_numpy(gmin), torch.from_numpy(glo)))
    _, jit = jtracker.track_chunk(jp, state, jnp.asarray(frames[1:]), jcfg)
    eager = eagerly(_jax_chain, jp, jax.tree_util.tree_map(jnp.asarray, snap),
                    [jnp.asarray(f) for f in frames[1:]], jcfg)
    _, port = ttracker.track_chunk(
        tp, _port_states(snap, False), torch.from_numpy(frames[1:]), tcfg,
        torch.stack([n[0] for n in noise]), torch.stack([n[1] for n in noise]))
    st, steps = _port_states(snap, False), []
    for f, (gmin, glo) in zip(frames[1:], noise):
        st, out = ttracker.track_step(tp, st, torch.from_numpy(f), tcfg, gmin, glo)
        steps.append(out)
    return jit, eager, port, steps


def test_chunk_vs_jax(chunked):
    """Counts exact along the chunk. Poses: step 0 starts from JAX's state,
    at PR 1's bar; a later step starts from each package's own chain, so its
    spread is the sum of JAX's eager-vs-jit spreads up to it (each step's
    deviation enters the next step's depths and scale)."""
    jit, eager, port, _ = chunked
    for f in ("valid", "num_matches", "num_inliers", "num_scale_pairs"):
        np.testing.assert_array_equal(getattr(port, f).numpy(), np.asarray(getattr(jit, f)), f)
    p, j = ([jax.tree_util.tree_map(lambda a: a[k], o) for k in range(len(CHUNK_FRAMES) - 1)]
            for o in (port, jit))
    within_jax_chain_spread(p, j, eager, relative(1e-4), ("R", "t"))


def test_chunk_equals_track_steps(chunked):
    _, _, port, steps = chunked
    for k, one in enumerate(steps):
        for f in ("R", "t", "valid", "num_matches", "num_inliers", "scale", "cells_new", "match_mask"):
            assert torch.equal(getattr(port, f)[k], getattr(one, f)), (k, f)


def test_pipelined_tracker_flushes_partial_tail(params):
    """Chunks of 3 over 5 steps: one full chunk through track_chunk, and a
    2-frame tail that `trajectory()` sends through track_step; the same
    poses and statistics as `Tracker` on the same frames and noise."""
    _, tp = params
    tcfg = _config(tconfig)
    frames = _frames(range(6))
    gen = torch.Generator().manual_seed(7)
    m, k = tcfg.frontend.top_n, tcfg.ransac.num_hypotheses
    noise = [(ransac.gumbel((k, m), gen, "cpu"), ransac.gumbel((ransac.lo_hypotheses(k), m), gen, "cpu"))
             for _ in frames[1:]]
    pipe = ttracker.PipelinedTracker(tp, tcfg, chunk=3, device="cpu")
    ref = ttracker.Tracker(tp, tcfg, device="cpu")
    pipe.process(frames[0])
    ref.process(frames[0])
    for f, (gmin, glo) in zip(frames[1:], noise):
        pipe.process(f, gmin, glo)
        ref.process(f, gmin, glo)
    assert len(pipe.rel_poses) == 3 and len(pipe._buf) == 2
    traj = pipe.trajectory()
    assert len(pipe.rel_poses) == 5 and not pipe._buf
    assert pipe.stats == ref.stats
    np.testing.assert_array_equal(traj, ref.trajectory())
    with pytest.raises(ValueError, match="noise"):
        pipe.process(frames[1], *noise[0])
        pipe.process(frames[2])
        pipe.process(frames[3])


if __name__ == "__main__":
    # Per-step differences behind the bars above:
    #   python tests/test_torch_chunk.py   (JAX_PLATFORMS=cpu)
    jp = jsp.load_params()
    tp = tsp.params_from_numpy({k: np.asarray(v) for k, v in jp.items()}, device="cpu")
    jit, eager, port, _ = chunked.__wrapped__((jp, tp))
    for k, e in enumerate(eager()):
        d = {n: (np.abs(getattr(port, n)[k].numpy() - np.asarray(getattr(jit, n))[k]).max(),
                 np.abs(np.asarray(getattr(e, n)) - np.asarray(getattr(jit, n))[k]).max())
             for n in ("R", "t")}
        print(f"step {k}: scale pairs port {int(port.num_scale_pairs[k])} jit "
              f"{int(np.asarray(jit.num_scale_pairs)[k])}; max |dR| port-jit {d['R'][0]:.3g} "
              f"eager-jit {d['R'][1]:.3g}; max |dt| port-jit {d['t'][0]:.3g} eager-jit {d['t'][1]:.3g}")

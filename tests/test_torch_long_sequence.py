"""The engine over a long ping-pong sequence, the port against the JAX
package on the CPU: tests/test_long_sequence.py:38's structural test at a
size the CPU can run.

That test ping-pongs KITTI frames 160-169, which the repository does not
hold, over 520 frames with a 24-slot LCD ring. Here frames 0-9 of the 96x320
orbit of tests/test_torch_slam.py are ping-ponged (period 18) for N_FRAMES
frames with a RING-slot ring and an 8-node pose-graph cap, so that the ring
wraps more than three times, loop closures fire after three wraps and the
skeleton's stride subsampling runs. Both engines get the same frames; the
port takes the JAX engine's noise (tests/test_torch_slam.py's
`jax_engine_noise`). chip_smoke.py's [long] phase runs the full-size test
on the card with the same checks (`chip_smoke.long_checks`).
"""

import dataclasses

import numpy as np
import pytest

import chip_smoke as smoke
from maveric_slam_tpu import slam as jslam
from maveric_slam_tpu.loopclosure import vocab as jvocab
from maveric_slam_tpu_torch import slam as tslam
from test_torch_loopclosure import jax_vocabulary
from test_torch_slam import JCFG, TCFG, jax_engine_noise, orbit, params  # noqa: F401 (fixture)
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

RING, NODES = 6, 8
# Keyframes come every max_interval = 4 frames, so the ring first wraps at
# frame 24; 80 frames wrap it 3.3 times and leave frames 73-79 past 3 wraps.
N_FRAMES = 80


def _config(cfg):
    return dataclasses.replace(cfg, loop=dataclasses.replace(
        cfg.loop, max_db_frames=RING, min_frame_gap=smoke.LONG_GAP, min_score=smoke.LONG_MIN_SCORE,
        max_graph_nodes=NODES))


@pytest.fixture(scope="module")
def engines(params):  # noqa: F811
    jp, tp = params
    images, _ = orbit(smoke.LONG_IMAGES)
    frames = [images[smoke.img_of(f)] for f in range(N_FRAMES)]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jvocab, "load_reference_vocabulary", jax_vocabulary)
        j = smoke.record_skeletons(jslam.SlamSystem(jp, _config(JCFG), ba_every=0,
                                                    enable_loop_closure=True))
        for f in frames:
            j.process(f)
        j.close()
    steps, verifications = jax_engine_noise(N_FRAMES - 1, 64)
    t = smoke.record_skeletons(tslam.SlamSystem(
        tp, _config(TCFG), ba_every=0, enable_loop_closure=True, device="cpu",
        verify_noise=lambda k: verifications[k]))
    t.process(frames[0])
    for f, noise in zip(frames[1:], steps):
        t.process(f, *noise)
    t.close()
    return j, t


def _pairs(slam):
    return [(e.frame, e.matched_frame) for e in slam.loop_events]


def test_bounded_state_and_wrapped_loop_closures(engines):
    """Every check of tests/test_long_sequence.py:60-96 on the port, scaled
    to the ring. Loop pairs may show images as far apart as the JAX
    engine's own pairs on these frames do: 2 (the orbit moves 3.75 deg a
    frame, so frames 2 apart share most of the view; ROADMAP Faults (r))."""
    j, t = engines
    gap = max(1, max(abs(smoke.img_of(f) - smoke.img_of(m)) for f, m in _pairs(j)))
    checks = smoke.long_checks(t, N_FRAMES, _config(TCFG), image_gap=gap)
    assert all(ok for ok, _ in checks), [w for ok, w in checks if not ok]
    assert all(s["valid"] for s in t.stats)


def test_skeleton_stride_path(engines):
    """The pose graph's node set was subsampled by the stride at least once
    in both engines. Where both engines solve the graph for the same loop
    (matched frame, current frame), the node sets are equal. Whether a loop
    solves at all depends on its edge's residual against the trajectory
    (`correction_gate_m`), which the engines' rounding moves: on these
    frames the port solves at 9 loops and JAX at 7 of the same 12."""
    j, t = engines
    assert any(strided for *_, strided in t.skeletons)
    assert any(strided for *_, strided in j.skeletons)
    jn = {(m, c): nodes for m, c, nodes, _ in j.skeletons}
    common = [(m, c, nodes) for m, c, nodes, _ in t.skeletons if (m, c) in jn]
    assert common and all(nodes == jn[m, c] for m, c, nodes in common)


def test_keyframes_and_loop_pairs_equal_jax(engines):
    j, t = engines
    assert t.kf_frames == j.kf_frames
    assert _pairs(t) == _pairs(j)
    assert [e.num_inliers for e in t.loop_events] == [e.num_inliers for e in j.loop_events]

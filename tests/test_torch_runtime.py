"""The port's native host runtime (maveric_slam_tpu_torch/runtime) against the
JAX package's (maveric_slam_tpu/runtime), on the CPU:

- both `FeaturePool`s on tests/test_feature_pool.py's stress sequence (seed
  41, 100 frames of 200 ids with 75 carried over, capacity 3000, window 8),
  equal on every frame in everything the pool reports, and
  tests/test_feature_pool.py's pool cases run on both;
- `lcd_intersect` on 50 seeded pairs of sorted lists;
- the port's ASan/UBSan stress driver, built from its own sources;
- the port builds only under `build/`, nothing next to the JAX package.
"""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from maveric_slam_tpu import runtime as jruntime
from maveric_slam_tpu_torch import runtime as truntime
from maveric_slam_tpu_torch.runtime import pool as tpool
from test_feature_pool import synthetic_frames
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

JAX_TREE = Path(__file__).resolve().parents[1] / "maveric_slam_tpu"
# What the JAX package's own build (its runtime/native/Makefile) may leave in
# its tree while these tests run; the port adds nothing there.
JAX_BUILD_OUTPUTS = {"libmaveric_runtime.so", "pool_stress_asan"}


def _jax_tree():
    return {p for p in JAX_TREE.rglob("*")
            if "__pycache__" not in p.parts and p.name not in JAX_BUILD_OUTPUTS}


@pytest.fixture(scope="module", autouse=True)
def nothing_built_in_the_jax_tree():
    before = _jax_tree()
    yield
    assert _jax_tree() - before == set()
    built = list(tpool.BUILD_DIR.iterdir())
    assert any(p.name.startswith("libmaveric_runtime_") for p in built), built


def _pool_report(pool):
    keys = np.sort(pool.valid_keys())
    return (len(pool), keys.tolist(), [pool.last_seen(int(k)) for k in keys],
            [pool.num_sightings(int(k)) for k in keys], pool.load_factor)


def test_stress_sequence_matches_jax_pool():
    frames = synthetic_frames(np.random.default_rng(41))
    pools = [mod.FeaturePool(capacity=3000, max_frames=8) for mod in (jruntime, truntime)]
    for f, ids in enumerate(frames):
        created = [p.observe_batch(ids, f) for p in pools]
        assert created[0] == created[1], f
        for p in pools:
            p.remove_old(f)
        assert pools[0].check_invariant(f) == pools[1].check_invariant(f) == 0, f
        assert _pool_report(pools[0]) == _pool_report(pools[1]), f
    want = set().union(*(set(ids.tolist()) for ids in frames[-8:]))
    assert set(pools[1].valid_keys().tolist()) == want
    # Filling both to capacity: the same ids fit, then both overflow.
    for p in pools:
        k = 10_000
        while len(p) < p.capacity:
            p.observe(k, 200)
            k += 1
        with pytest.raises(OverflowError):
            p.observe(1 << 30, 200)
        with pytest.raises(OverflowError):
            p.observe_batch(np.array([-1, (1 << 30) + 1], np.int32), 200)
    assert _pool_report(pools[0]) == _pool_report(pools[1])


def _observe_semantics(mod):
    pool = mod.FeaturePool(capacity=64, max_frames=4)
    out = [pool.observe(7, 0), pool.observe(7, 1), pool.observe(7, 1)]  # new, update, same frame
    return out + [pool.last_seen(7), pool.num_sightings(7), pool.last_seen(99)]


def _age_out(mod):
    pool = mod.FeaturePool(capacity=64, max_frames=4)
    for f in range(10):
        pool.observe(5, f)
    out = [pool.num_sightings(5)]  # the ring is capped
    pool.observe(6, 9)
    pool.remove_old(9)
    out.append(len(pool))
    pool.remove_old(20)  # both now stale
    return out + [len(pool), pool.check_invariant(20)]


def _collision_chains(mod):
    # Keys colliding mod capacity exercise probe-chain repair on deletion.
    pool = mod.FeaturePool(capacity=8, max_frames=2)
    for k in (1, 9, 17, 25):
        pool.observe(k, 0)
    for k in (1, 9, 17, 25):
        pool.observe(k, 1)
    for k in (9, 17, 25):
        pool.observe(k, 2)
    pool.remove_old(3)  # window 2: drops key 1 (last seen 1)
    return [pool.last_seen(k) for k in (1, 9, 17, 25)] + [pool.check_invariant(3)]


@pytest.mark.parametrize("case,want", [
    (_observe_semantics, [True, False, False, 1, 2, -1]),
    (_age_out, [4, 2, 0, 0]),
    (_collision_chains, [-1, 2, 2, 2, 0]),
])
def test_pool_cases_match_jax(case, want):
    """tests/test_feature_pool.py's TestNativePool cases, on both pools."""
    assert case(jruntime) == case(truntime) == want


def test_lcd_intersect_matches_jax():
    rng = np.random.default_rng(43)
    for _ in range(50):
        a = np.unique(rng.choice(1000, rng.integers(0, 200)))
        b = np.unique(rng.choice(1000, rng.integers(0, 200)))
        want = len(set(a.tolist()) & set(b.tolist()))
        assert truntime.lcd_intersect(a, b) == jruntime.lcd_intersect(a, b) == want


def test_pool_stress_under_asan_ubsan():
    """The port's stress driver (5000 adversarial frames, then a full pool
    and its overflow and age-out) under ASan + UBSan; any heap error, UB
    or leak fails the binary."""
    try:
        binary = tpool.stress_binary()
    except tpool.SanitizersUnavailable as e:
        pytest.skip(f"toolchain lacks sanitizers: {str(e)[-300:]}")
    assert binary.parent == tpool.BUILD_DIR
    run = subprocess.run([str(binary)], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, run.stdout + run.stderr
    assert "pool_stress: OK" in run.stdout

"""The port's midpoint triangulation (geometry/epipolar.py, the tracker's
and the loop verification's depths) against the JAX package's, and its
accuracy in float32 (ROADMAP Faults (g)).

The JAX package solves the rays' 2x2 normal equations with determinant
|a|^2 |b|^2 - (a.b)^2, which cancels between near-parallel rays; the port
computes the same determinant and numerators as products of cross
products. The scene: 2000 points 2-202 m deep seen from two cameras 0.3 m
apart, so the rays' parallax runs from ~8 deg down to ~0.08 deg, as the
tracker's far points do.

- In float64 both are the same function: within 1e-9 relative.
- In float32 the port's points lie within 1e-5 relative of the exact ones
  (float64), and a one-ulp change of the input moves them by no more
  (two devices that round differently then agree); JAX's float32 points
  err by more than 100 times that on this scene.
- Batched as the cheirality vote calls it (4 candidates x S streams), each
  candidate's points equal its own call's bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from maveric_slam_tpu.geometry import epipolar as jepi
from maveric_slam_tpu_torch.geometry import epipolar as tepi
import torch_threads  # noqa: F401  (the tests' one torch thread policy)


@pytest.fixture(scope="module")
def scene():
    """(R, t, p1, p2, X) in float64: X in camera 1, p2 ~ R X + t."""
    rng = np.random.default_rng(21)
    X = rng.normal(size=(2000, 3))
    X[:, 2] = rng.uniform(2.0, 202.0, 2000)
    R = Rotation.from_rotvec([0.01, 0.02, 0.005]).as_matrix()
    t = np.array([0.3, 0.0, 0.05])
    x2 = X @ R.T + t
    return R, t, X[:, :2] / X[:, 2:], x2[:, :2] / x2[:, 2:], X


def _rel(got, X):
    return np.linalg.norm(np.asarray(got, np.float64) - X, axis=-1) / np.linalg.norm(X, axis=-1)


def _port(R, t, p1, p2):
    return tepi.triangulate(*(torch.from_numpy(np.ascontiguousarray(a)) for a in (R, t, p1, p2))).numpy()


def test_midpoint_is_jax_function_in_float64(scene):
    R, t, p1, p2, X = scene
    with jax.enable_x64(True):
        want = np.asarray(jepi.triangulate(*(jnp.asarray(a) for a in (R, t, p1, p2))))
    got = _port(R, t, p1, p2)
    assert got.dtype == np.float64
    assert _rel(got, want).max() < 1e-9
    assert _rel(want, X).max() < 1e-6  # JAX's in float64 is exact here


def test_midpoint_float32_accuracy(scene):
    R, t, p1, p2, X = scene
    f32 = [a.astype(np.float32) for a in (R, t, p1, p2)]
    port = _rel(_port(*f32), X).max()
    jax_f32 = _rel(np.asarray(jepi.triangulate(*(jnp.asarray(a) for a in f32))), X).max()
    assert port < 1e-5, port
    assert jax_f32 > 100 * port, (jax_f32, port)  # the scene exercises the cancellation


def test_midpoint_stable_under_one_ulp(scene):
    """A one-ulp change of every p2 coordinate (what another device's
    rounding of the same step amounts to) moves no point by more than
    1e-5 of its distance."""
    R, t, p1, p2, X = scene
    f32 = [a.astype(np.float32) for a in (R, t, p1, p2)]
    a = _port(*f32)
    b = _port(*f32[:3], np.nextafter(f32[3], np.float32(np.inf)))
    assert _rel(b, a.astype(np.float64)).max() < 1e-5


def test_midpoint_batched_as_the_cheirality_vote(scene):
    """R (4, S, 3, 3), t (4, S, 3) against p (S, M, 2): candidate k of
    stream s equals the call with that pose and stream alone, bitwise."""
    R, t, p1, p2, _ = scene
    Rs = np.stack([np.stack([R, R.T]), np.stack([R.T, R]), np.stack([R, R]), np.stack([R.T, R.T])])
    ts = np.stack([np.stack([t, -t]), np.stack([-t, t]), np.stack([t, t]), np.stack([-t, -t])])
    P1, P2 = (np.stack([p[:500], p[500:1000]]).astype(np.float32) for p in (p1, p2))
    Rs, ts = Rs.astype(np.float32), ts.astype(np.float32)
    X = _port(Rs, ts, P1, P2)
    assert X.shape == (4, 2, 500, 3)
    for k in range(4):
        for s in range(2):
            np.testing.assert_array_equal(X[k, s], _port(Rs[k, s], ts[k, s], P1[s], P2[s]))

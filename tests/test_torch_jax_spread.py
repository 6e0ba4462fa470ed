"""tests/jax_spread.py on numpy stand-ins for the port's and JAX's outputs:
the eager run is made only when a gap passes its floor, and at most once."""

from collections import namedtuple

import numpy as np
import pytest

from jax_spread import within_jax_spread
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

Pose = namedtuple("Pose", "R t")
JIT = Pose(R=np.eye(3, dtype=np.float32), t=np.array([0.0, 0.0, 1.0], np.float32))


def _shifted(dR, dt):
    return Pose(R=JIT.R + np.float32(dR), t=JIT.t + np.float32(dt))


class Eager:
    """A stand-in for JAX's eager run that counts its calls."""

    def __init__(self, out):
        self.out, self.calls = out, 0

    def __call__(self):
        self.calls += 1
        return self.out


def test_under_the_floor_never_runs_eager():
    eager = Eager(_shifted(0.0, 0.0))
    within_jax_spread(_shifted(5e-5, -5e-5), JIT, eager, 1e-4, ("R", "t"))
    assert eager.calls == 0


def test_within_twice_the_spread_runs_eager_once():
    eager = Eager(_shifted(2e-4, 0.0))  # R's spread 2e-4, t's 0
    within_jax_spread(_shifted(3e-4, 5e-5), JIT, eager, 1e-4, ("R", "t"))
    assert eager.calls == 1


def test_past_both_fails_naming_the_output():
    eager = Eager(_shifted(0.0, 2e-4))  # t's spread 2e-4, R's 0
    with pytest.raises(AssertionError, match=r"R: gap 0\.0005, floor 0\.0001, spread 0;"):
        within_jax_spread(_shifted(5e-4, 3e-4), JIT, eager, 1e-4, ("R", "t"))
    assert eager.calls == 1

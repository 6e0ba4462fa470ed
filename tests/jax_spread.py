"""The one judge of "within twice JAX's own jit-vs-eager spread, or the
floor" (ROADMAP.md Faults (c)): the port's output held against the JAX
package's jitted output, with the gap JAX's own eager run (jit disabled,
one primitive at a time) leaves to its jitted one as the allowance.

An output passes when its gap to the jitted result is at most
max(FACTOR * spread, floor). That holds whenever the gap is at most the
floor, so the eager run, the slow part, can change the verdict only where
some gap exceeds its floor. Each form here takes JAX's eager run (or the
spread itself) as a zero-argument callable and calls it at most once, and
only then.
"""

import functools

import jax
import numpy as np

FACTOR = 2.0


def eagerly(fn, *args, **kw):
    """A zero-argument callable that runs fn(*args, **kw) with jit disabled
    on its first call and returns that result on every call."""
    @functools.cache
    def run():
        with jax.disable_jit():
            return fn(*args, **kw)
    return run


def relative(floor):
    """The floor `floor * max(1, max|ref|)`, a function of the jitted value."""
    return lambda ref: floor * max(1.0, np.abs(ref).max())


def outputs(x, names) -> dict:
    """{name: numpy array}: the attributes `names` of `x` (a namedtuple of JAX
    arrays or torch CPU tensors), or with `names` a {name: index} mapping,
    `x[index]` of the array `x`."""
    if isinstance(names, dict):
        return {n: np.asarray(x)[i] for n, i in names.items()}
    return {n: np.asarray(getattr(x, n)) for n in names}


def _gap(a, b):
    return np.abs(a - b).max()


def _floor(floor, ref):
    return floor(ref) if callable(floor) else floor


def _verdict(rows):
    """rows: (label, gap, floor, spread or None). Raise naming every row
    when one is past max(FACTOR * spread, floor)."""
    bad = [r for r in rows if not r[1] <= (r[2] if r[3] is None else max(FACTOR * r[3], r[2]))]
    if bad:
        raise AssertionError("outside twice JAX's jit-vs-eager spread and the floor: " + "; ".join(
            f"{label}: gap {gap:.3g}, floor {floor:.3g}, spread "
            + ("not run" if spread is None else f"{spread:.3g}") for label, gap, floor, spread in rows))


def within_jax_spread(got, jit, eager, floor, names):
    """Each output of the port's `got` within max(FACTOR * spread, floor) of
    JAX's jitted `jit`, spread being max|eager() - jit| of that output.
    `names` picks the outputs (`outputs`); `floor` is a number or a function
    of the jitted value (`relative`)."""
    got, jit = outputs(got, names), outputs(jit, names)
    gaps = {n: _gap(got[n], jit[n]) for n in jit}
    floors = {n: _floor(floor, jit[n]) for n in jit}
    spreads = dict.fromkeys(jit)
    if not all(gaps[n] <= floors[n] for n in jit):
        ran = outputs(eager(), names)
        spreads = {n: _gap(ran[n], jit[n]) for n in jit}
    _verdict([(n, gaps[n], floors[n], spreads[n]) for n in jit])


def within_jax_chain_spread(got, jit, eager, floor, names):
    """`within_jax_spread` along a chain of steps, each step k starting
    from its own package's step k - 1: `got` and `jit` are sequences of step
    outputs and `eager()` JAX's eager chain from the same start. Step k's
    spread is the sum of the eager chain's spreads over steps 0..k (each
    step's deviation enters the next step's input)."""
    got = [outputs(g, names) for g in got]
    jit = [outputs(j, names) for j in jit]
    gaps = [{n: _gap(g[n], j[n]) for n in j} for g, j in zip(got, jit)]
    floors = [{n: _floor(floor, j[n]) for n in j} for j in jit]
    spreads = [dict.fromkeys(j) for j in jit]
    if not all(g[n] <= f[n] for g, f in zip(gaps, floors) for n in g):
        ran = [outputs(e, names) for e in eager()]
        for n in jit[0]:
            chain = 0.0
            for k, (e, j) in enumerate(zip(ran, jit)):
                chain += _gap(e[n], j[n])
                spreads[k][n] = chain
    _verdict([(f"step {k} {n}", gaps[k][n], floors[k][n], spreads[k][n])
              for k in range(len(jit)) for n in jit[k]])


def within_column_spread(gap, spread, floor):
    """Per column: `gap` (an array, or a scalar for one column) at most
    max(floor, FACTOR * spread()), spread() being JAX's own per-column
    spread (an array of the same length)."""
    gap = np.atleast_1d(gap)
    if (gap <= floor).all():
        return
    ran = np.atleast_1d(spread())
    assert (gap <= np.maximum(floor, FACTOR * ran)).all(), (
        f"per-column gap {gap}, floor {floor}, spread {ran}")


def assert_allclose_within_spread(got, want, spread, rtol, floor):
    """np.testing.assert_allclose(got, want, rtol, atol=max(FACTOR *
    spread(), floor)), tried with atol=floor first (it passes with any
    larger atol once it passes with that)."""
    try:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=floor)
    except AssertionError:
        np.testing.assert_allclose(got, want, rtol=rtol, atol=max(FACTOR * spread(), floor))

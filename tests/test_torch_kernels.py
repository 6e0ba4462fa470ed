"""The port's detector, matcher, nullspace and svd3 kernels, held against the JAX package on the CPU.

On the CPU each kernel wrapper runs its plain PyTorch version; these tests
hold that version against the JAX function it replaces (the jnp path, and
the Pallas kernel in interpret mode where it has one), on the same numpy
inputs. The CUDA kernels themselves are held against the plain versions on
the card by tests/test_torch_cuda.py and by chip_smoke.py.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maveric_slam_tpu.ops import linalg as jlinalg
from maveric_slam_tpu.ops import matching as jmatching
from maveric_slam_tpu.ops import pallas_kernels
from maveric_slam_tpu.ops import softmax_topn as jst
from maveric_slam_tpu.ops import svd3 as jsvd3
from maveric_slam_tpu_torch.ops import matching as tmatching
from maveric_slam_tpu_torch.ops import softmax_topn as tst
from maveric_slam_tpu_torch.ops.kernels import detector, match, nullspace, svd3
from test_torch_cuda import (detector_edge_cases, detector_kernel_emulation, match_edge_cases,
                             svd3_edge_cases)
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

REFCACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "maveric_slam_tpu", "data", "_refcache",
    "include_data_quantized_quantized_image0.h.npz",
)


@pytest.fixture(scope="module")
def image0():
    """The golden int8 grid of image0, (24, 80, 65) / (24, 80, 256): the
    header's patch order is column-major, hence the (wc, hc) transpose."""
    with np.load(REFCACHE) as d:
        hc, wc = int(d["image0_feature_rows"]), int(d["image0_feature_cols"])
        semi = d["image0_semi"].reshape(wc, hc, 65).transpose(1, 0, 2).copy()
        desc = d["image0_desc"].reshape(wc, hc, 256).transpose(1, 0, 2).copy()
        scale = np.float32(d["image0_semi_scale"])
    return semi, desc, scale


def _port_detector(semi, scale):
    probs, idx, xy = detector.detector_postproc(
        torch.from_numpy(semi.reshape(-1, 65)), torch.tensor(scale)
    )
    return probs.numpy(), idx.numpy(), xy.numpy()


class TestDetector:
    def test_matches_jnp_path(self, image0):
        semi, _, scale = image0
        probs, idx, xy = _port_detector(semi, scale)
        grid = jst.approx_softmax_grid(semi, scale)
        xy_ref = np.asarray(jst.subpixel_xy(semi, scale, grid)).reshape(-1, 2)
        idx_ref = np.asarray(grid.indices).reshape(-1)
        np.testing.assert_array_equal(idx, idx_ref)
        np.testing.assert_allclose(probs, np.asarray(grid.probs).reshape(-1), rtol=1e-6)
        valid = idx_ref != 64
        assert valid.sum() > 100
        np.testing.assert_allclose(xy[valid], xy_ref[valid], atol=1e-3)

    def test_matches_pallas_interpret(self, image0):
        semi, _, scale = image0
        probs, idx, xy = _port_detector(semi, scale)
        p_ref, i_ref, xy_ref = (
            np.asarray(a)
            for a in pallas_kernels.fused_detector_postproc(
                semi.reshape(-1, 65), scale, interpret=True
            )
        )
        np.testing.assert_array_equal(idx, i_ref)
        np.testing.assert_allclose(probs, p_ref, rtol=1e-6)
        valid = i_ref != 64
        np.testing.assert_allclose(xy[valid], xy_ref[valid], atol=1e-3)


def _jax_detector(semi, scale, degree, grid_w):
    """JAX's jnp path on (C, 65) cells: probs, indices, xy as (C,), (C,), (C, 2)."""
    semi3 = semi.reshape(-1, grid_w, 65)
    grid = jst.approx_softmax_grid(semi3, scale, degree)
    xy = jst.subpixel_xy(semi3, scale, grid, degree)
    return (np.asarray(grid.probs).reshape(-1), np.asarray(grid.indices).reshape(-1),
            np.asarray(xy).reshape(-1, 2))


def _assert_detector_bars(got, ref):
    """The detector's bars: argmax exact, probs rtol 1e-6, xy atol 1e-3 where
    a cell has a keypoint."""
    probs, idx, xy = got
    np.testing.assert_array_equal(idx, ref[1])
    np.testing.assert_allclose(probs, ref[0], rtol=1e-6)
    valid = ref[1] != 64
    np.testing.assert_allclose(xy[valid], ref[2][valid], atol=1e-3)


@pytest.mark.parametrize("label", [case[0] for case in detector_edge_cases()])
class TestDetectorEdgeCases:
    """tests/test_torch_cuda.py::detector_edge_cases (ties across the
    kernel's lane boundaries, negatives and dustbin-only cells, zeros and
    extremes, winners on the 8x8 border, Taylor degrees 1-12 at small and
    large scales, a ragged 6x10 grid, an unaligned view) through the port
    and the JAX package, at the detector's bars."""

    @staticmethod
    def _case(label):
        _, semi, offset, scale, degree, grid_w, expect = next(
            case for case in detector_edge_cases() if case[0] == label)
        t = torch.from_numpy(semi)[offset:]
        got = detector.detector_postproc(t, torch.tensor(scale), degree=degree, grid_w=grid_w)
        return semi[offset:], scale, degree, grid_w, expect, tuple(g.numpy() for g in got)

    def test_matches_jnp_path(self, label):
        semi, scale, degree, grid_w, expect, got = self._case(label)
        _assert_detector_bars(got, _jax_detector(semi, scale, degree, grid_w))
        if expect is not None:
            np.testing.assert_array_equal(got[1], expect)

    def test_matches_pallas_interpret(self, label):
        semi, scale, degree, grid_w, _, got = self._case(label)
        ref = tuple(np.asarray(a) for a in pallas_kernels.fused_detector_postproc(
            semi, scale, degree=degree, grid_w=grid_w, interpret=True))
        _assert_detector_bars(got, ref)

    def test_emulated_kernel_order_matches_jax(self, label):
        """The CUDA kernel's fixed order of sums (row sums, a tree over the
        rows, the 3x3 window row-major), emulated in numpy, holds the bars
        against JAX."""
        semi, scale, degree, grid_w, _, _ = self._case(label)
        _assert_detector_bars(detector_kernel_emulation(semi, scale, degree, grid_w),
                              _jax_detector(semi, scale, degree, grid_w))


def test_emulated_kernel_order_matches_jax_on_image0(image0):
    semi, _, scale = image0
    flat = semi.reshape(-1, 65)
    got = detector_kernel_emulation(flat, scale)
    _assert_detector_bars(got, _jax_detector(flat, scale, 5, 80))
    assert (got[1] != 64).sum() > 100


@pytest.mark.parametrize("degree", [0, -1])
def test_detector_degree_below_one_raises(degree):
    with pytest.raises(ValueError):
        detector.detector_postproc(torch.zeros(80, 65, dtype=torch.int8), torch.tensor(0.5),
                                   degree=degree)


@pytest.mark.parametrize("mode", ["prob", "reference"])
def test_top_n_cells_exact(image0, mode):
    semi, _, scale = image0
    jgrid = jst.approx_softmax_grid(semi, scale)
    tgrid = tst.approx_softmax_grid(torch.from_numpy(semi), torch.tensor(scale))
    ref = jst.top_n_select(jgrid, n=100, mode=mode)
    got = tst.top_n_select(tgrid, n=100, mode=mode)
    np.testing.assert_array_equal(got.cells.numpy(), np.asarray(ref.cells))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    assert int(got.num_selected) == int(ref.num_selected)


class TestMatcher:
    @pytest.fixture(scope="class")
    def inputs(self, image0):
        """Self-match of image0 and a match of image0 against a copy with
        int8 noise, both with the top-100 cells as queries."""
        semi, desc, scale = image0
        grid = jst.approx_softmax_grid(semi, scale)
        top = jst.top_n_select(grid, n=100, mode="prob")
        rng = np.random.default_rng(5)
        noisy = np.clip(
            desc.astype(np.int32) + rng.integers(-40, 41, desc.shape), -128, 127
        ).astype(np.int8)
        return (
            desc.reshape(-1, 256), noisy.reshape(-1, 256),
            np.array(grid.probs).reshape(-1), np.array(grid.indices).reshape(-1),
            np.array(top.cells), np.array(top.indices), np.array(top.mask),
        )

    @pytest.mark.parametrize("other", ["self", "noisy"])
    def test_matches_jnp_path(self, inputs, other):
        desc0, noisy, probs0, idx0, cells1, idx1, mask1 = inputs
        desc1 = desc0 if other == "self" else noisy
        kw = dict(grid_h=24, grid_w=80, shift=(0, 0), radius=4,
                  match_threshold=0.8, min_prob=0.1)
        ref = jmatching.windowed_match(desc0, probs0, idx0, desc1, cells1, idx1, mask1, **kw)
        t = torch.from_numpy
        got = tmatching.windowed_match(
            t(desc0), t(probs0), t(idx0), t(desc1), t(cells1), t(idx1), t(mask1), **kw
        )
        mask = np.asarray(ref.mask)
        assert mask.sum() > 20
        np.testing.assert_array_equal(got.mask.numpy(), mask)
        np.testing.assert_array_equal(got.cell0.numpy(), np.asarray(ref.cell0))
        np.testing.assert_allclose(got.score.numpy()[mask], np.asarray(ref.score)[mask], rtol=1e-5)
        assert int(got.num_matches) == int(ref.num_matches)

    def test_matches_pallas_interpret(self, inputs):
        desc0, noisy, probs0, idx0, cells1, _, mask1 = inputs
        q = noisy[cells1]
        kw = dict(grid_h=24, grid_w=80, shift=(0, 0), radius=4, min_prob=0.1)
        s_ref, c_ref = (
            np.asarray(a)
            for a in pallas_kernels.fused_windowed_match(
                q, desc0, probs0, idx0, cells1, interpret=True, **kw
            )
        )
        t = torch.from_numpy
        s, c = match.windowed_match(t(q), t(desc0), t(probs0), t(idx0), t(cells1), **kw)
        rows = mask1 & (s_ref > 0.64)
        assert rows.sum() > 20
        np.testing.assert_array_equal(c.numpy()[rows], c_ref[rows])
        np.testing.assert_allclose(s.numpy()[rows], s_ref[rows], rtol=1e-5)

    def test_empty_window_gives_minus_one_at_cell_zero(self):
        """No usable cell in the window: the full-row first maximum is
        (-1, cell 0), whatever the window's position."""
        desc = torch.ones(4 * 6, 256, dtype=torch.int8)
        probs = torch.zeros(24)  # all below min_prob
        s, c = match.windowed_match(
            desc[:2], desc, probs, torch.zeros(24, dtype=torch.int32),
            torch.tensor([7, 23], dtype=torch.int32), grid_h=4, grid_w=6, radius=1,
        )
        assert s.tolist() == [-1.0, -1.0] and c.tolist() == [0, 0]


@pytest.mark.parametrize("label", [lab for lab, _, _ in match_edge_cases()])
class TestMatcherEdgeCases:
    """The contract's corners (tests/test_torch_cuda.py::match_edge_cases:
    ties, windows clipped or emptied at the four grid edges by a shift,
    signed=False) against the JAX package. Bars as TestWindowedMatch: cells
    exact, scores rtol 1e-5."""

    @staticmethod
    def _case(label):
        _, args, kw = next(case for case in match_edge_cases() if case[0] == label)
        s, c = match.windowed_match(*(torch.from_numpy(a) for a in args), **kw)
        return args, kw, s.numpy(), c.numpy()

    def test_matches_jnp_path(self, label):
        (q, desc0, probs0, idx0, cells1), kw, s, c = self._case(label)
        desc1 = np.zeros_like(desc0)
        desc1[cells1] = q
        n = len(cells1)
        ref = jmatching.windowed_match(desc0, probs0, idx0, desc1, cells1, np.zeros(n, np.int32),
                                       np.ones(n, bool), match_threshold=0.0, **kw)
        np.testing.assert_allclose(s, np.asarray(ref.score), rtol=1e-5)
        found = np.asarray(ref.mask)  # score > 0: the jnp path reports the cell
        assert found.sum() >= n // 2
        np.testing.assert_array_equal(c[found], np.asarray(ref.cell0)[found])

    def test_matches_pallas_interpret(self, label):
        (q, desc0, probs0, idx0, cells1), kw, s, c = self._case(label)
        s_ref, c_ref = (np.asarray(a) for a in pallas_kernels.fused_windowed_match(
            q, desc0, probs0, idx0, cells1, interpret=True, **kw))
        np.testing.assert_array_equal(c, c_ref)
        np.testing.assert_allclose(s, s_ref, rtol=1e-5)
        if label == "tie":  # the lower of the two cells holding the query's descriptor
            assert c.tolist() == [10 * 80 + 30, 4 * 80 + 62, 16 * 80 + 5]


def _psd(shape, seed):
    A = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return np.einsum("...ij,...kj->...ik", A, A)


class TestNullspace:
    @pytest.mark.parametrize("shape", [(256, 9, 9), (3, 9, 9), (150, 4, 4), (16, 32, 9, 9)])
    def test_matches_jnp_path(self, shape):
        A = _psd(shape, 0)
        ref = np.asarray(jlinalg.smallest_eigvec_inverse_iteration(A))
        got = nullspace.nullspace_inverse_iteration(torch.from_numpy(A)).numpy()
        s = np.sign(np.sum(ref * got, axis=-1, keepdims=True))
        np.testing.assert_allclose(got * s, ref, atol=1e-4)

    def test_matches_pallas_interpret(self):
        A = _psd((64, 9, 9), 1)
        ref = np.asarray(pallas_kernels.nullspace_inverse_iteration(A, interpret=True))
        got = nullspace.nullspace_inverse_iteration(torch.from_numpy(A)).numpy()
        s = np.sign(np.sum(ref * got, axis=-1, keepdims=True))
        np.testing.assert_allclose(got * s, ref, atol=1e-4)

    def test_matches_pallas_interpret_stream_batched(self):
        """The batched step's stream axis: (S, B, 9, 9) with S = 2."""
        A = _psd((2, 256, 9, 9), 3)
        ref = np.asarray(pallas_kernels.nullspace_inverse_iteration(A, interpret=True))
        got = nullspace.nullspace_inverse_iteration(torch.from_numpy(A)).numpy()
        assert got.shape == (2, 256, 9)
        s = np.sign(np.sum(ref * got, axis=-1, keepdims=True))
        np.testing.assert_allclose(got * s, ref, atol=1e-4)


def _svd3_cases():
    rng = np.random.default_rng(2)
    E = np.zeros((3, 3), np.float32)
    E[0, 1], E[1, 0] = 1.0, -1.0
    neg = np.diag([1.0, 2.0, -3.0]).astype(np.float32)
    r1 = np.outer([1.0, 2.0, 3.0], [0.5, -1.0, 2.0]).astype(np.float32)
    return [
        rng.normal(size=(64, 3, 3)).astype(np.float32),
        rng.normal(size=(3, 3)).astype(np.float32),
        rng.normal(size=(4, 16, 3, 3)).astype(np.float32),
        np.stack([E, neg, r1, np.zeros((3, 3), np.float32)]),
    ]


def _check_svd3(A, U, s, V, sr, s_tol):
    """The bars of tests/test_pallas_kernels.py::TestSvd3Kernel._check."""
    m = max(1.0, float(np.abs(A).max()))
    np.testing.assert_allclose(s, sr, atol=s_tol * m)
    recon = np.einsum("...ik,...k,...jk->...ij", U, s, V)
    np.testing.assert_allclose(recon, A, atol=1e-4 * m)
    np.testing.assert_allclose(np.linalg.det(U), 1.0, atol=1e-4)
    np.testing.assert_allclose(np.linalg.det(V), 1.0, atol=1e-4)
    eye = np.broadcast_to(np.eye(3, dtype=np.float32), U.shape)
    np.testing.assert_allclose(np.einsum("...ij,...ik->...jk", U, U), eye, atol=1e-4)
    np.testing.assert_allclose(np.einsum("...ij,...ik->...jk", V, V), eye, atol=1e-4)


class TestSvd3:
    @pytest.mark.parametrize("case", range(4))
    def test_matches_jnp_path(self, case):
        A = _svd3_cases()[case]
        _, sr, _ = (np.asarray(x) for x in jsvd3.svd3_ref(jnp.asarray(A)))
        U, s, V = (x.numpy() for x in svd3.svd3(torch.from_numpy(A)))
        _check_svd3(A, U, s, V, sr, 2e-5)

    def test_matches_pallas_interpret(self):
        A = _svd3_cases()[3]
        _, sr, _ = (np.asarray(x) for x in pallas_kernels.svd3_pallas(A, interpret=True))
        U, s, V = (x.numpy() for x in svd3.svd3(torch.from_numpy(A)))
        _check_svd3(A, U, s, V, sr, 2e-5)

    @pytest.mark.parametrize("label", list(svd3_edge_cases()))
    def test_edge_cases_match_jnp_path(self, label):
        """Repeated singular values, scales 1e-4 and 1e4, a (16, 256) batch
        (tests/test_torch_cuda.py::svd3_edge_cases)."""
        A = svd3_edge_cases()[label]
        _, sr, _ = (np.asarray(x) for x in jsvd3.svd3_ref(jnp.asarray(A)))
        U, s, V = (x.numpy() for x in svd3.svd3(torch.from_numpy(A)))
        _check_svd3(A, U, s, V, sr, 2e-5)

    @pytest.mark.parametrize("label", list(svd3_edge_cases()))
    def test_edge_cases_match_pallas_interpret(self, label):
        A = svd3_edge_cases()[label]
        _, sr, _ = (np.asarray(x) for x in pallas_kernels.svd3_pallas(A, interpret=True))
        U, s, V = (x.numpy() for x in svd3.svd3(torch.from_numpy(A)))
        _check_svd3(A, U, s, V, sr, 2e-5)


class TestStreams:
    """A leading stream axis: every stream is computed on its own grid. With
    stream 1 equal to stream 0, both must give the single-stream result
    (a cell list stacked across streams gets its rows, and a top-N over all
    streams its cells, from the wrong stream)."""

    def test_detector_rows_per_stream(self, image0):
        semi, _, scale = image0
        one = _port_detector(semi, scale)
        two = detector.detector_postproc(
            torch.from_numpy(np.stack([semi, semi]).reshape(2, -1, 65)), torch.tensor(scale),
            grid_h=24)
        for s in range(2):
            for got, ref in zip(two, one):
                np.testing.assert_array_equal(got[s].numpy(), ref)

    @pytest.mark.parametrize("second", ["same", "noisy"])
    @pytest.mark.parametrize("mode", ["prob", "reference"])
    def test_top_n_per_stream(self, image0, mode, second):
        import jax

        semi, _, scale = image0
        other = semi
        if second == "noisy":
            rng = np.random.default_rng(6)
            other = np.clip(semi + rng.integers(-8, 9, semi.shape), -128, 127).astype(np.int8)
        semi2 = np.stack([semi, other])
        jgrid = jst.approx_softmax_grid(semi2, scale)
        ref = jax.vmap(lambda g: jst.top_n_select(g, n=100, mode=mode))(jgrid)
        # The same probabilities in both (they agree only to rtol 1e-6, and
        # near-ties in "prob" mode would order by the last bit).
        tgrid = tst.SoftmaxGrid(torch.from_numpy(np.array(jgrid.probs)),
                                torch.from_numpy(np.array(jgrid.indices)))
        got = tst.top_n_select(tgrid, n=100, mode=mode)
        for f in ("cells", "mask", "indices", "num_selected"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)), f)
        if second == "same":
            np.testing.assert_array_equal(got.cells[0].numpy(), got.cells[1].numpy())

    def test_match_per_stream(self, image0):
        semi, desc, scale = image0
        grid = jst.approx_softmax_grid(semi, scale)
        top = jst.top_n_select(grid, n=100, mode="prob")
        args = [desc.reshape(-1, 256), np.array(grid.probs).reshape(-1),
                np.array(grid.indices).reshape(-1), desc.reshape(-1, 256),
                np.array(top.cells), np.array(top.indices), np.array(top.mask)]
        kw = dict(grid_h=24, grid_w=80, shift=(0, 0), radius=4, match_threshold=0.8, min_prob=0.1)
        one = tmatching.windowed_match(*(torch.from_numpy(a) for a in args), **kw)
        two = tmatching.windowed_match(*(torch.from_numpy(np.stack([a, a])) for a in args), **kw)
        for got, ref in zip(two, one):
            for s in range(2):
                np.testing.assert_array_equal(got[s].numpy(), ref.numpy())

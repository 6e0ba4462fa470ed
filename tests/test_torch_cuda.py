"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked `cuda` and skips without an NVIDIA GPU. The file
imports neither JAX nor the JAX package, so it runs on a machine that has
only PyTorch and the CUDA toolkit:

    python -m pytest --noconftest -q -m cuda tests/test_torch_cuda.py

(`--noconftest`: tests/conftest.py pins JAX to the CPU and imports it.)
The bars are those of ROADMAP.md "How parity is held".
"""

import os

import numpy as np
import pytest
import torch
from pnp_problems import pnp_problem

from maveric_slam_tpu_torch.data import synthetic
from maveric_slam_tpu_torch.models import superpoint as sp
from maveric_slam_tpu_torch.ops import softmax_topn as st
from maveric_slam_tpu_torch.ops.kernels import (_build, detector, match, nullspace, qconv, refine_pose, stem,
                                                svd3)

pytestmark = pytest.mark.cuda

REFCACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "maveric_slam_tpu", "data", "_refcache",
    "include_data_quantized_quantized_image0.h.npz",
)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (torch.cuda.is_available() is False)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def image0():
    """The golden int8 grids of image0 as (1920, 65) / (1920, 256) row-major
    cells (the header's patch order is column-major: (wc, hc) transposed)."""
    with np.load(REFCACHE) as d:
        hc, wc = int(d["image0_feature_rows"]), int(d["image0_feature_cols"])
        semi = d["image0_semi"].reshape(wc, hc, 65).transpose(1, 0, 2)
        desc = d["image0_desc"].reshape(wc, hc, 256).transpose(1, 0, 2)
        scale = np.float32(d["image0_semi_scale"])
    return np.ascontiguousarray(semi.reshape(-1, 65)), np.ascontiguousarray(
        desc.reshape(-1, 256)), scale


def _check_detector(semi, scale, **kw):
    """Kernel against plain at the bars: argmax equal, probs rtol 1e-6, xy
    atol 1e-3 where a cell has a keypoint. Returns the kernel's outputs."""
    p, i, xy = detector.detector_postproc(semi, scale, **kw)
    pp, ip, xyp = detector.detector_postproc_plain(semi, scale, **kw)
    torch.cuda.synchronize()
    assert torch.equal(i, ip)
    torch.testing.assert_close(p, pp, rtol=1e-6, atol=0)
    v = ip != 64
    torch.testing.assert_close(xy[v], xyp[v], rtol=0, atol=1e-3)
    return p, i, xy


def test_detector(image0, cuda):
    semi, _, scale = image0
    _check_detector(torch.from_numpy(semi).to(cuda), torch.tensor(scale, device=cuda))


def detector_edge_cases():
    """[(label, semi, offset, scale, degree, grid_w, expect)] of the
    detector's edge cases, seeded: the cells are rows `offset`.. of the
    int8 array `semi` (offset 1: a view whose base is not 16-byte aligned),
    `expect` the winning channel of every cell where the case fixes it.
    - "lane-boundary ties": two channels share the maximum across the
      kernel's lane boundaries (7/8, 55/56, 0/63, ...): the lower wins;
    - "negative / dustbin only": every logit negative, or only the dustbin
      >= 0 (no keypoint, 64), or one 0 among negatives (e = 1 wins);
    - "zero and extremes": all 0 (every exp 1, channel 0), all 127, all
      -128, one 127 among -128s, alternating 127/-128;
    - "8x8 corners and edges": the winner at the corners, edges and middle
      of the 8x8 layout, its clipped 3x3 window positive;
    - "degree d scale s": Taylor degrees 1, 2, 5, 8 at scales 1e-7 (the
      exps of neighbouring logits round to the same value) and 4, and
      degrees 9 and 12 at image0's scale;
    - "6x10 grid" (C = 60: a ragged last tile) and "unaligned view"
      (semi[1:] of a (1921, 65) array, C = 1920).
    The first four are one row of 80 cells at degree 5 and image0's scale.
    Also the inputs of tests/test_torch_kernels.py's cases against the JAX
    package."""
    rng = np.random.default_rng(13)
    scale = np.float32(0.3562202453613281)  # image0's semi scale

    def negative(n):
        return rng.integers(-128, 0, (n, 65)).astype(np.int8)

    cases = []
    semi, expect = negative(80), np.zeros(80, np.int32)
    pairs = [(7, 8), (55, 56), (0, 63), (15, 16), (31, 32), (47, 48), (8, 15), (62, 63)]
    for k in range(80):
        a, b = pairs[k % len(pairs)]
        v = int(rng.integers(1, 128))
        semi[k, rng.choice(64, 6, replace=False)] = rng.integers(0, v, 6)
        semi[k, [a, b]] = v
        if k % 2:
            semi[k, 64] = 127  # the dustbin above the maximum does not compete
        expect[k] = min(a, b)
    cases.append(("lane-boundary ties", semi, 0, scale, 5, 80, expect))

    semi, expect = negative(80), np.full(80, 64, np.int32)
    semi[20:40, 64] = rng.integers(0, 128, 20)
    for k in range(40, 80):
        semi[k, (7 * k) % 64] = 0
        expect[k] = (7 * k) % 64
    cases.append(("negative / dustbin only", semi, 0, scale, 5, 80, expect))

    semi, expect = np.zeros((80, 65), np.int8), np.zeros(80, np.int32)
    semi[10:20] = 127
    semi[20:30], expect[20:30] = -128, 64
    for k in range(30, 60):
        semi[k] = -128
        semi[k, (11 * k) % 64] = 127
        expect[k] = (11 * k) % 64
    semi[60:70, 0::2], semi[60:70, 1::2] = 127, -128
    semi[70:80, 0::2], semi[70:80, 1::2] = -128, 127
    expect[70:80] = 1
    cases.append(("zero and extremes", semi, 0, scale, 5, 80, expect))

    winners = [0, 7, 56, 63, 3, 24, 31, 59, 27, 36]
    semi = rng.integers(-128, 60, (80, 65)).astype(np.int8)
    expect = np.array([winners[k % len(winners)] for k in range(80)], np.int32)
    for k, w in enumerate(expect):
        wy, wx = divmod(int(w), 8)
        for y in range(max(wy - 1, 0), min(wy + 2, 8)):
            for x in range(max(wx - 1, 0), min(wx + 2, 8)):
                semi[k, 8 * y + x] = rng.integers(60, 110)
        semi[k, w] = 120
    cases.append(("8x8 corners and edges", semi, 0, scale, 5, 80, expect))

    def random(n):
        return rng.integers(-128, 128, (n, 65)).astype(np.int8)

    for degree in (1, 2, 5, 8):
        for s in (1e-7, 4.0):
            cases.append((f"degree {degree} scale {s:g}", random(160), 0, np.float32(s), degree, 80, None))
    for degree in (9, 12):
        cases.append((f"degree {degree} scale {scale:.4g}", random(160), 0, scale, degree, 80, None))
    cases.append(("6x10 grid", random(60), 0, scale, 5, 10, None))
    cases.append(("unaligned view", random(1921), 1, scale, 5, 80, None))
    return cases


def detector_kernel_emulation(semi, scale, degree=5, grid_w=80):
    """The CUDA kernel's arithmetic in numpy f32 on (C, 65) int8 cells, in
    its fixed order, whatever lanes it runs on: each exp in the reference's
    order; each row of the 8x8 layout summed left to right, the dustbin
    added to row 0, the rows as ((r0+r1)+(r2+r3))+((r4+r5)+(r6+r7)); the
    first maximum over channels 0..63; the winner's 3x3 window summed
    row-major. Returns (probs, idx, xy) as the kernel should give them, bit
    for bit."""
    f32 = np.float32
    x = semi.astype(f32)
    acc, xp, p = np.ones_like(x), x.copy(), f32(1.0)
    for i in range(1, degree):
        p = f32(f32(p * f32(scale)) / f32(i))
        acc = acc + p * xp
        xp = xp * x
    e = np.where(x >= 0, acc, f32(0.0))
    rows = e[:, 0:64:8].copy()
    for j in range(1, 8):
        rows = rows + e[:, j:64:8]
    rows[:, 0] = rows[:, 0] + e[:, 64]
    for _ in range(3):  # the tree: neighbours, then pairs, then halves
        rows = rows[:, 0::2] + rows[:, 1::2]
    den = rows[:, 0] + f32(1.175494e-38)
    arg = np.argmax(e[:, :64], axis=1)  # the first maximum
    best = e[np.arange(len(e)), arg]
    has = best > 0
    idx = np.where(has, arg, 64).astype(np.int32)
    probs = np.where(has, best / den, f32(-1.0)).astype(f32)

    wx, wy = idx % 8, idx // 8
    d3, sx, sy = (np.zeros(len(e), f32) for _ in range(3))
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            iy, ix = wy + dy, wx + dx
            ok = (iy >= 0) & (iy < 8) & (ix >= 0) & (ix < 8)
            v = np.where(ok, e[np.arange(len(e)), np.clip(8 * iy + ix, 0, 63)], f32(0.0))
            d3, sx, sy = d3 + v, sx + v * ix.astype(f32), sy + v * iy.astype(f32)
    d3 = np.maximum(d3, f32(1e-20))
    cell = np.arange(len(semi))
    col, row = (cell % grid_w).astype(f32), (cell // grid_w).astype(f32)
    xy = np.stack([col * f32(8.0) + sx / d3, row * f32(8.0) + sy / d3], axis=-1)
    return probs, idx, xy


def _detector_case(label, device):
    """(semi, scale, kw, expect) of the named edge case, semi on `device`."""
    _, semi, offset, scale, degree, grid_w, expect = next(
        case for case in detector_edge_cases() if case[0] == label)
    return (torch.from_numpy(semi).to(device)[offset:], torch.tensor(scale, device=device),
            dict(degree=degree, grid_w=grid_w), expect)


@pytest.mark.parametrize("label", [case[0] for case in detector_edge_cases()])
def test_detector_edge_cases(cuda, label):
    semi, scale, kw, expect = _detector_case(label, cuda)
    if label == "unaligned view":
        assert semi.data_ptr() % 16 != 0  # the kernel's byte-staging path
    _, i, _ = _check_detector(semi, scale, **kw)
    if expect is not None:
        assert i.tolist() == expect.tolist()


def test_detector_emulated_order(image0, cuda):
    """The kernel gives what detector_kernel_emulation computes, bit for bit,
    on image0 and on every edge case: its reduction order is the one the
    CPU tests hold against JAX."""
    semi, _, scale = image0
    inputs = [(semi, scale, dict(degree=5, grid_w=80))]
    for _, s, offset, sc, degree, grid_w, _ in detector_edge_cases():
        inputs.append((s[offset:], sc, dict(degree=degree, grid_w=grid_w)))
    for s, sc, kw in inputs:
        got = detector.detector_postproc(torch.from_numpy(s).to(cuda), torch.tensor(sc, device=cuda), **kw)
        for g, ref in zip(got, detector_kernel_emulation(s, sc, **kw)):
            np.testing.assert_array_equal(g.cpu().numpy(), ref)


def _detector16(image0, cuda):
    """S = 16 detector inputs: image0's logits with seeded noise k in
    stream k."""
    semi, _, scale = image0
    rng = np.random.default_rng(17)
    semi16 = np.stack([np.clip(semi.astype(np.int32) + rng.integers(-k, k + 1, semi.shape), -128, 127)
                       for k in range(16)]).astype(np.int8)
    return torch.from_numpy(semi16).to(cuda), torch.tensor(scale, device=cuda)


def test_detector_streams16(image0, cuda):
    """The batched step's call, one launch, against plain per stream; each
    stream alone gives its row of the S = 16 call bit for bit."""
    semi16, scale = _detector16(image0, cuda)
    before = detector.launches
    p16, i16, xy16 = _check_detector(semi16, scale, grid_h=24)
    assert detector.launches == before + 1
    for k in range(16):
        p, i, xy = detector.detector_postproc(semi16[k], scale, grid_h=24)
        assert torch.equal(p, p16[k]) and torch.equal(i, i16[k]) and torch.equal(xy, xy16[k]), k


def test_detector_degree_below_one(cuda):
    semi = torch.zeros(80, 65, dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError):
        detector.detector_postproc(semi, torch.tensor(0.5, device=cuda), degree=0)


@pytest.mark.parametrize("other", ["self", "noisy"])
def test_match(image0, cuda, other):
    semi, desc, scale = image0
    probs, idx, _ = detector.detector_postproc_plain(
        torch.from_numpy(semi), torch.tensor(scale))
    grid = st.SoftmaxGrid(probs.reshape(24, 80), idx.reshape(24, 80))
    top = st.top_n_select(grid, n=100, mode="prob")
    q = desc
    if other == "noisy":
        rng = np.random.default_rng(5)
        q = np.clip(desc.astype(np.int32) + rng.integers(-40, 41, desc.shape),
                    -128, 127).astype(np.int8)
    q = torch.from_numpy(q)[top.cells.long()]
    args = [t.to(cuda) for t in (q, torch.from_numpy(desc), probs, idx, top.cells)]
    kw = dict(grid_h=24, grid_w=80, shift=(0, 0), radius=4, min_prob=0.1)
    s, c = match.windowed_match(*args, **kw)
    sp_, cp = match.windowed_match_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(c, cp)
    torch.testing.assert_close(s, sp_, rtol=1e-5, atol=0)


def test_match_empty_window(cuda):
    """No usable cell in the window: (-1, cell 0), as on the CPU."""
    desc = torch.ones(4 * 6, 256, dtype=torch.int8, device=cuda)
    s, c = match.windowed_match(
        desc[:2], desc, torch.zeros(24, device=cuda),
        torch.zeros(24, dtype=torch.int32, device=cuda),
        torch.tensor([7, 23], dtype=torch.int32, device=cuda),
        grid_h=4, grid_w=6, radius=1)
    assert s.tolist() == [-1.0, -1.0] and c.tolist() == [0, 0]


def match_edge_cases():
    """[(label, (desc1_sel, desc0, probs0, indices0, cells1) as numpy, kw)]
    of the matcher's edge cases on the main path's 24x80 grid, radius 4,
    with seeded descriptors (about 10% of cells below min_prob, 1/65 dustbins):
    - "tie": each query's own descriptor at two cells of its window (same
      row, and two rows apart): the lower cell wins;
    - "edges shift (sx, sy)": queries at the four corners, the middle of
      each edge and the centre, the window shifted: clipped on every side,
      and with shift (-6, 0) empty at the left edge, (-1, cell 0);
    - "unsigned" / "signed": the negated query at a window cell, which is
      the best match only with signed=False.
    Also the inputs of tests/test_torch_kernels.py's cases against the JAX
    package."""
    rng = np.random.default_rng(11)
    gh, gw = 24, 80
    c = gh * gw
    desc0 = rng.integers(-127, 128, (c, 256)).astype(np.int8)
    probs0 = rng.random(c).astype(np.float32)
    indices0 = rng.integers(0, 65, c).astype(np.int32)
    kw = dict(grid_h=gh, grid_w=gw, radius=4, min_prob=0.1)

    def cell(r, col):
        return r * gw + col

    cases = []
    cells = np.array([cell(10, 31), cell(5, 60), cell(18, 8)], np.int32)
    q = rng.integers(-127, 128, (3, 256)).astype(np.int8)
    d0 = desc0.copy()
    p0, i0 = probs0.copy(), indices0.copy()
    for k, (a, b) in enumerate([(cell(10, 30), cell(10, 33)), (cell(4, 62), cell(6, 57)),
                                (cell(16, 5), cell(18, 4))]):
        d0[[a, b]] = q[k]
        p0[[a, b]], i0[[a, b]] = 1.0, 0
    cases.append(("tie", (q, d0, p0, i0, cells), dict(kw, shift=(0, 0))))
    edge = np.array([cell(r, col) for r in (0, 12, 23) for col in (0, 40, 79)], np.int32)
    qe = rng.integers(-127, 128, (len(edge), 256)).astype(np.int8)
    for shift in ((3, -2), (-3, 2), (-6, 0)):
        cases.append((f"edges shift {shift}", (qe, desc0, probs0, indices0, edge),
                      dict(kw, shift=shift)))
    cu = np.array([cell(3, 3), cell(12, 50), cell(20, 77)], np.int32)
    qu = rng.integers(-127, 128, (3, 256)).astype(np.int8)
    du, pu, iu = desc0.copy(), probs0.copy(), indices0.copy()
    for k, at in enumerate((cell(5, 1), cell(12, 52), cell(23, 79))):
        du[at] = -qu[k]
        pu[at], iu[at] = 1.0, 0
    for signed in (False, True):
        cases.append(("signed" if signed else "unsigned", (qu, du, pu, iu, cu),
                      dict(kw, shift=(0, 0), signed=signed)))
    return cases


def _check_match(args, kw):
    """Kernel against plain: equal cells and bitwise-equal scores."""
    s, c = match.windowed_match(*args, **kw)
    sp_, cp = match.windowed_match_plain(*args, **kw)
    torch.cuda.synchronize()
    assert torch.equal(c, cp)
    assert torch.equal(s, sp_), float((s - sp_).abs().max())
    return s, c


@pytest.mark.parametrize("label", [lab for lab, _, _ in match_edge_cases()])
def test_match_edge_cases(cuda, label):
    _, args, kw = next(case for case in match_edge_cases() if case[0] == label)
    s, c = _check_match([torch.from_numpy(a).to(cuda) for a in args], kw)
    if label == "tie":  # the lower of the two cells holding the query's descriptor
        assert c.tolist() == [10 * 80 + 30, 4 * 80 + 62, 16 * 80 + 5] and s.tolist() == [1.0] * 3
    if label == "edges shift (-6, 0)":  # the left edge's windows are off the grid
        assert s[[0, 3, 6]].tolist() == [-1.0] * 3 and c[[0, 3, 6]].tolist() == [0] * 3
    if label == "unsigned":
        assert s.tolist() == [1.0] * 3


def _streams16(image0, cuda):
    """S = 16 matcher inputs from image0: stream k's previous frame is
    image0's descriptors with seeded noise k, its queries the top-100 cells
    of another noisy copy."""
    semi, desc, scale = image0
    probs, idx, _ = detector.detector_postproc_plain(torch.from_numpy(semi), torch.tensor(scale))
    top = st.top_n_select(st.SoftmaxGrid(probs.reshape(24, 80), idx.reshape(24, 80)), n=100, mode="prob")
    rng = np.random.default_rng(16)

    def noisy(amp):
        return np.clip(desc.astype(np.int32) + rng.integers(-amp, amp + 1, desc.shape), -128, 127).astype(np.int8)

    d0 = torch.from_numpy(np.stack([noisy(k) for k in range(16)]))
    q = torch.from_numpy(np.stack([noisy(30) for _ in range(16)]))[:, top.cells.long()]
    return [t.to(cuda) for t in (q, d0, probs.expand(16, -1).contiguous(),
                                 idx.expand(16, -1).contiguous(), top.cells.expand(16, -1).contiguous())]


MATCH_KW = dict(grid_h=24, grid_w=80, shift=(0, 0), radius=4, min_prob=0.1)


def test_match_streams16(image0, cuda):
    """The batched step's call: 16 streams of 100 queries, one launch."""
    before = match.launches
    _check_match(_streams16(image0, cuda), MATCH_KW)
    assert match.launches == before + 1


def test_match_stream_independent(image0, cuda):
    """Each stream alone gives its row of the S = 16 call, bit for bit."""
    args = _streams16(image0, cuda)
    s16, c16 = match.windowed_match(*args, **MATCH_KW)
    for k in range(16):
        s, c = match.windowed_match(*(a[k] for a in args), **MATCH_KW)
        assert torch.equal(s, s16[k]) and torch.equal(c, c16[k]), k


def _check_nullspace(A):
    got = nullspace.nullspace_inverse_iteration(A)
    ref = nullspace.nullspace_plain(A)
    torch.cuda.synchronize()
    assert got.shape == A.shape[:-1]
    s = torch.sign(torch.sum(ref * got, dim=-1, keepdim=True))
    torch.testing.assert_close(got * s, ref, rtol=0, atol=1e-3)


@pytest.mark.parametrize("shape", [(256, 9, 9), (64, 9, 9), (3, 9, 9), (100, 4, 4),
                                   (16, 256, 9, 9), (16, 3, 9, 9), (16, 64, 4, 4)])
def test_nullspace(cuda, shape):
    """The main path's shapes, the batched step's (S = 16) and n = 4."""
    A = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    _check_nullspace(torch.from_numpy(np.einsum("...ij,...kj->...ik", A, A)).to(cuda))


@pytest.mark.parametrize("n", [9, 4])
def test_nullspace_degenerate(cuda, n):
    """A zero matrix (both versions give the zero vector: the first solve's
    norm overflows) and rank-deficient ones of rank n - 1 (the 8-point
    design of 8 points), at two scales. Rank n - 2 and lower is outside the
    contract: its null space is not one direction, and for n = 9 the plain
    version itself returns NaN (the trace shift is below the f32 rounding
    of the Schur complement)."""
    v = np.random.default_rng(n).normal(size=(n, n - 1)).astype(np.float32)
    A = np.stack([np.zeros((n, n), np.float32), v @ v.T, 1e3 * (v @ v.T)])
    _check_nullspace(torch.from_numpy(A).to(cuda))


def _degenerate_3x3():
    """tests/test_pallas_kernels.py's cases: rank-2 essential-like, negative
    determinant, rank-1, and the zero matrix."""
    E = np.zeros((3, 3), np.float32)
    E[0, 1], E[1, 0] = 1.0, -1.0
    neg = np.diag([1.0, 2.0, -3.0]).astype(np.float32)
    r1 = np.outer([1.0, 2.0, 3.0], [0.5, -1.0, 2.0]).astype(np.float32)
    return np.stack([E, neg, r1, np.zeros((3, 3), np.float32)])


def svd3_edge_cases():
    """{label: (..., 3, 3) f32} of the 3x3 SVD's edge cases: repeated
    singular values, matrices scaled far from 1 (with the degenerate set) and
    the batched step's (16, 256) batch. Also the inputs of
    tests/test_torch_kernels.py's cases against the JAX package."""
    rng = np.random.default_rng(12)
    base = np.concatenate([_degenerate_3x3(), rng.normal(size=(28, 3, 3))]).astype(np.float32)
    return {
        "repeated I, diag(2,2,1), diag(3,1,1)": np.stack(
            [np.eye(3), np.diag([2.0, 2.0, 1.0]), np.diag([3.0, 1.0, 1.0])]).astype(np.float32),
        "scaled 1e-4": base * np.float32(1e-4),
        "scaled 1e4": base * np.float32(1e4),
        "(16, 256) batch": rng.normal(size=(16, 256, 3, 3)).astype(np.float32),
    }


def _check_svd3(A):
    """The kernel's bars against the plain version (ROADMAP.md): s within
    2e-4 max|A|, reconstruction within 1e-3 max|A|, det U = det V = 1 within
    1e-3."""
    U, s, V = (x.cpu().numpy() for x in svd3.svd3(torch.from_numpy(A).cuda()))
    _, sp_, _ = svd3.svd3_plain(torch.from_numpy(A).cuda())
    assert U.shape == A.shape and s.shape == A.shape[:-1]
    m = max(1.0, float(np.abs(A).max()))
    np.testing.assert_allclose(s, sp_.cpu().numpy(), rtol=0, atol=2e-4 * m)
    recon = np.einsum("...ik,...k,...jk->...ij", U, s, V)
    np.testing.assert_allclose(recon, A, rtol=0, atol=1e-3 * m)
    np.testing.assert_allclose(np.linalg.det(U), 1.0, atol=1e-3)
    np.testing.assert_allclose(np.linalg.det(V), 1.0, atol=1e-3)


@pytest.mark.parametrize("batch", [256, 64, 1])
def test_svd3(cuda, batch):
    A = np.concatenate(
        [_degenerate_3x3(), np.random.default_rng(batch).normal(size=(batch, 3, 3))]
    ).astype(np.float32)
    _check_svd3(A)


@pytest.mark.parametrize("label", list(svd3_edge_cases()))
def test_svd3_edge_cases(cuda, label):
    _check_svd3(svd3_edge_cases()[label])


@pytest.mark.parametrize("batch", [256, 64, 1])
def test_svd3_streams(cuda, batch):
    """The batched step's calls at S = 16: (16, 256 | 64 | 1, 3, 3)."""
    _check_svd3(np.random.default_rng(batch + 16).normal(size=(16, batch, 3, 3)).astype(np.float32))


def test_svd3_batch_independent(cuda):
    """A matrix's result is the same bit for bit alone, in a batch of 256 and
    at another position of a batch of 4096 (batched and chunked runs rely on
    it)."""
    A = torch.from_numpy(np.concatenate(
        [_degenerate_3x3(), np.random.default_rng(7).normal(size=(252, 3, 3))]).astype(np.float32)).cuda()
    big = torch.from_numpy(np.random.default_rng(8).normal(size=(4096, 3, 3)).astype(np.float32)).cuda()
    big[1000:1256] = A
    full, in_big = svd3.svd3(A), svd3.svd3(big)
    for k in (0, 1, 2, 3, 31, 32, 33, 100, 255):
        alone = svd3.svd3(A[k:k + 1])
        for a, f, b in zip(alone, full, in_big):
            assert torch.equal(a[0], f[k]) and torch.equal(a[0], b[1000 + k]), k


def test_int8_net_card_equals_cpu(cuda):
    """The f32-carried im2col SuperPoint is integer-exact on the card too."""
    K = np.array([[400.0, 0, 160.0], [0, 400.0, 48.0], [0, 0, 1]], np.float32)
    img = torch.from_numpy(synthetic.render_box_room(K, synthetic.orbit_poses(96)[0], 96, 320))
    params = sp.load_params(device="cpu")
    semi_c, desc_c, _ = sp.superpoint_int8(params, img[None])
    semi_g, desc_g, _ = sp.superpoint_int8(
        {k: v.to(cuda) for k, v in params.items()}, img[None].to(cuda))
    assert torch.equal(semi_g.cpu(), semi_c) and torch.equal(desc_g.cpu(), desc_c)


@pytest.fixture(scope="module")
def stem_params():
    return sp.load_params(device="cpu")


def _stem_images(shape):
    """Orbit frames for the 192x640 shapes, seeded noise otherwise."""
    s, h, w = shape
    if (h, w) == (192, 640):
        K = np.array([[800.0, 0, 320.0], [0, 800.0, 96.0], [0, 0, 1]], np.float32)
        poses = synthetic.orbit_poses(192)
        return np.stack([synthetic.render_box_room(K, poses[k], h, w) for k in range(s)])
    return np.random.default_rng(h * w).random(shape, dtype=np.float32)


@pytest.mark.parametrize("shape", [(1, 192, 640), (2, 36, 44), (16, 192, 640), (1, 6, 10)])
def test_stem_bitwise(cuda, stem_params, shape):
    """The stem kernel against the layered stage 1, bit for bit, at the main
    path's shape, the batched step's (16 streams), one that no 8 x 32 tile
    divides, and one smaller than a tile."""
    args = [v.to(cuda) for v in sp.stem_args(stem_params)]
    img = torch.from_numpy(_stem_images(shape)).to(cuda)
    before = stem.launches
    got = stem.fused_stem(img, *args)
    ref = stem.fused_stem_plain(img, *args)
    torch.cuda.synchronize()
    assert stem.launches == before + 1
    assert got.shape == (shape[0], shape[1] // 2, shape[2] // 2, 64) and got.dtype == torch.int8
    assert torch.equal(got, ref)


def test_stem_kernel_on_tensor_cores(cuda):
    """conv1b runs on the int8 tensor cores: the built stem_kernel's SASS
    holds IMMA (mma.sync) instructions."""
    code = _build.sass("stem_kernel")
    assert code, "stem_kernel not found in the built library"
    assert "IMMA" in code


def test_stem_saturating(cuda, stem_params):
    """All-0 and all-1 images, where the quantize and requant clips bind."""
    args = [v.to(cuda) for v in sp.stem_args(stem_params)]
    img = torch.stack([torch.zeros(36, 44), torch.ones(36, 44)]).to(cuda)
    assert torch.equal(stem.fused_stem(img, *args), stem.fused_stem_plain(img, *args))


# The net calls of the main path (one stream and the 16-stream step at
# 192x640 and 376x1240), one no tile divides, and one whose pools round down.
QCONV_SIZES = [(1, 192, 640), (16, 192, 640), (1, 376, 1240), (16, 376, 1240), (2, 24, 40), (1, 14, 18)]


def _qconv_images(size):
    """Orbit frames (stream s at orbit phase 12 s) at the main path's sizes,
    seeded noise otherwise."""
    s, h, w = size
    if h not in (192, 376):
        return np.random.default_rng(h * w).random(size, dtype=np.float32)
    f, n = (800.0, 192) if h == 192 else (1550.0, 372)
    K = np.array([[f, 0, w / 2], [0, f, h / 2], [0, 0, 1]], np.float32)
    poses = synthetic.orbit_poses(n)
    return np.stack([synthetic.render_box_room(K, poses[12 * k], h, w) for k in range(s)])


@pytest.fixture(scope="module")
def card_params(cuda):
    return sp.load_params(device=cuda)


@pytest.mark.parametrize("size", QCONV_SIZES)
def test_qconv_bitwise(cuda, card_params, size):
    """Every layer after the stem, kernel against plain version on the card,
    bit for bit: on the net's own activations of orbit frames (each layer
    fed the kernel's output of the one before) and on seeded int8 inputs of
    the same shapes."""
    relu_pool = {name: (relu, pool) for name, _, relu, pool in sp._AFTER_STEM}
    gen = torch.Generator(device=cuda).manual_seed(size[0] * size[1])

    def run(x, name):
        relu, pool = relu_pool[name]
        args = sp.qconv_args(card_params, name)
        seeded = torch.randint(0, 128, x.shape, dtype=torch.int8, device=cuda, generator=gen)
        outs = [qconv.qconv(inp, *args, relu=relu, pool=pool) for inp in (x, seeded)]
        for inp, got in zip((x, seeded), outs):
            ref = qconv.qconv_plain(inp, *args, relu=relu, pool=pool)
            assert got.shape == ref.shape and torch.equal(got, ref), (name, tuple(inp.shape))
        return outs[0]

    x = stem.fused_stem(torch.from_numpy(_qconv_images(size)).to(cuda), *sp.stem_args(card_params))
    for name in sp._ENCODER[2:]:
        x = run(x, name)
    run(run(x, "convPa"), "convPb")
    run(run(x, "convDa"), "convDb")


@pytest.mark.parametrize("name", ["conv2b", "conv3b", "convPb"])
def test_qconv_negative_multiplier(cuda, card_params, name):
    """A negative requant multiplier (the pool then takes the minimum sum),
    with and without the ReLU."""
    args = list(sp.qconv_args(card_params, name))
    args[2] = -args[2]
    cin = card_params[f"{name}_w"].shape[1]
    x = torch.randint(0, 128, (2, 10, 18, cin), dtype=torch.int8, device=cuda,
                      generator=torch.Generator(device=cuda).manual_seed(7))
    pool = name != "convPb"
    for relu in (True, False):
        got = qconv.qconv(x, *args, relu=relu, pool=pool)
        assert torch.equal(got, qconv.qconv_plain(x, *args, relu=relu, pool=pool)), relu


def test_int8_net_card_equals_cpu_192x640(cuda, card_params):
    """The net through the stem and qconv kernels on the card equals the
    CPU's f32-carried path at (2, 192, 640)."""
    img = torch.from_numpy(_qconv_images((2, 192, 640)))
    semi_c, desc_c, _ = sp.superpoint_int8(sp.load_params(device="cpu"), img)
    semi_g, desc_g, _ = sp.superpoint_int8(card_params, img.to(cuda))
    assert torch.equal(semi_g.cpu(), semi_c) and torch.equal(desc_g.cpu(), desc_c)


def test_qconv_launches_ten_a_net_call(cuda, card_params):
    """A net call launches the stem once and the qconv kernel once a layer."""
    img = torch.from_numpy(_qconv_images((1, 192, 640))).to(cuda)
    before = (stem.launches, qconv.launches)
    sp.superpoint_int8(card_params, img)
    torch.cuda.synchronize()
    assert (stem.launches - before[0], qconv.launches - before[1]) == (1, 10)


def test_qconv_net_runs_no_im2col_or_f32_gemm(cuda, card_params):
    """Under torch.profiler a net call on the card runs the stem and the
    qconv kernels and no im2col or GEMM kernel."""
    from torch.profiler import ProfilerActivity, profile

    img = torch.from_numpy(_qconv_images((16, 192, 640))).to(cuda)
    sp.superpoint_int8(card_params, img)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        sp.superpoint_int8(card_params, img)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("qconv_kernel" in n for n in names) == 10 and any("stem_kernel" in n for n in names)
    assert not [n for n in names if "im2col" in n.lower() or "gemm" in n.lower()], names


def test_qconv_kernel_on_tensor_cores(cuda):
    """The built qconv_kernel's SASS holds IMMA (mma.sync s8) instructions."""
    code = _build.sass("qconv_kernel")
    assert code, "qconv_kernel not found in the built library"
    assert "IMMA" in code


def test_batched_detector_and_match(image0, cuda):
    """(S, C, 65) and (S, N) inputs, one launch each, against the plain
    versions, per stream: stream 1 is stream 0 with noise added."""
    semi, desc, scale = image0
    rng = np.random.default_rng(8)
    semi2 = np.stack([semi, np.clip(semi + rng.integers(-3, 4, semi.shape), -128, 127)]).astype(np.int8)
    desc2 = np.stack([desc, np.clip(desc + rng.integers(-20, 21, desc.shape), -128, 127)]).astype(np.int8)
    s = torch.from_numpy(semi2).to(cuda)
    sc = torch.tensor(scale, device=cuda)
    p, i, xy = detector.detector_postproc(s, sc, grid_h=24)
    pp, ip, xyp = detector.detector_postproc_plain(s, sc, grid_h=24)
    assert torch.equal(i, ip)
    torch.testing.assert_close(p, pp, rtol=1e-6, atol=0)
    v = ip != 64
    torch.testing.assert_close(xy[v], xyp[v], rtol=0, atol=1e-3)
    grid = st.SoftmaxGrid(pp.reshape(2, 24, 80), ip.reshape(2, 24, 80))
    top = st.top_n_select(grid, n=100, mode="prob")
    q = torch.take_along_dim(torch.from_numpy(desc2).to(cuda), top.cells.long()[..., None], dim=1)
    d0 = torch.from_numpy(desc2[::-1].copy()).to(cuda)
    kw = dict(grid_h=24, grid_w=80, shift=(0, 0), radius=4, min_prob=0.1)
    sm, cm = match.windowed_match(q, d0, pp, ip, top.cells, **kw)
    sp_, cp = match.windowed_match_plain(q, d0, pp, ip, top.cells, **kw)
    torch.cuda.synchronize()
    assert torch.equal(cm, cp)
    torch.testing.assert_close(sm, sp_, rtol=1e-5, atol=0)


# The pairwise pipeline and the backend, card against CPU. The scenes are
# chip_smoke.py's (it imports no JAX): orbit frames at 96x320, the BA scene
# of tests/test_ba.py and a drifting pose-graph loop.

def _orbit96(ks):
    K = np.array([[400.0, 0, 160.0], [0, 400.0, 48.0], [0, 0, 1]], np.float32)
    poses = synthetic.orbit_poses(96)
    return {k: synthetic.render_box_room(K, poses[k], 96, 320) for k in ks}


def _config96():
    import dataclasses

    from maveric_slam_tpu_torch.config import DEFAULT_CONFIG, CameraConfig

    d = DEFAULT_CONFIG
    return dataclasses.replace(
        d, camera=CameraConfig(fx=400.0, fy=400.0, cx=160.0, cy=48.0, width=320, height=96),
        frontend=dataclasses.replace(d.frontend, height=96, width=320),
        ransac=dataclasses.replace(d.ransac, inlier_thresh=3.0 / 400.0))


def test_pairwise_pose_card_vs_cpu(cuda):
    """Two stem launches, four nullspace and three svd3 launches a call; the
    same counts and rotation within 0.01 deg of the CPU with the same noise."""
    from maveric_slam_tpu_torch.frontend import pairwise
    from maveric_slam_tpu_torch.geometry import ransac
    from maveric_slam_tpu_torch.ops import kernels

    cfg, fr = _config96(), _orbit96((0, 4))
    gen = torch.Generator().manual_seed(5)
    gmin = ransac.gumbel((256, 1000), gen, "cpu")
    glo = ransac.gumbel((64, 1000), gen, "cpu")
    out = {}
    for dev in ("cpu", "cuda"):
        params = sp.load_params(device=dev)
        kernels.reset_launch_counts()
        r = pairwise.pairwise_pose(params, torch.from_numpy(fr[0]).to(dev), torch.from_numpy(fr[4]).to(dev),
                                   cfg, gmin.to(dev), glo.to(dev))
        out[dev] = (r, kernels.launch_counts())
    (c, _), (g, launches) = out["cpu"], out["cuda"]
    assert launches == {"detector_postproc": 0, "windowed_match": 0,
                        "nullspace_inverse_iteration": 4, "svd3": 3, "fused_stem": 2,
                        "refine_pose": 0, "qconv": 20}
    assert int(g.num_matches) == int(c.num_matches) and int(g.num_inliers) == int(c.num_inliers)
    cos = (torch.trace(g.R.cpu().T @ c.R) - 1) / 2
    assert float(torch.rad2deg(torch.arccos(cos.clamp(-1, 1)))) < 0.01


def test_quadrant_nms_card_vs_cpu(cuda):
    """extract_quantized(apply_nms=True) on the card: the same cells
    suppressed as on the CPU, except beside a neighbour within the
    detector's bar (rtol 1e-6) of the cell's prob."""
    from maveric_slam_tpu_torch.frontend import extractor

    cfg, fr = _config96(), _orbit96((0, 1, 2, 3))
    imgs = torch.from_numpy(np.stack(list(fr.values())))
    g = extractor.extract_quantized_batched(sp.load_params(device="cuda"), imgs.to(cuda), cfg, apply_nms=True)
    c = extractor.extract_quantized_batched(sp.load_params(device="cpu"), imgs, cfg, apply_nms=True)
    for s, r, col in (g.indices.cpu() != c.indices).nonzero().tolist():
        p = c.probs[s]
        near = [abs(float(p[r + dr, col + dc]) - float(p[r, col])) <= 1e-6 * abs(float(p[r, col]))
                for dr in (-1, 0, 1) for dc in (-1, 0, 1) if (dr or dc)
                and 0 <= r + dr < p.shape[0] and 0 <= col + dc < p.shape[1]]
        assert any(near), (s, r, col)


def test_bundle_adjust_card_vs_cpu(cuda):
    """Dense and factor-list BA at P = 8, L = 256 (tests/test_ba.py's scene,
    35% density): the card's poses within R 1e-4 and t 1e-3 of the CPU's,
    the cost never rising, sparse equal to dense at tests/test_ba.py's bars."""
    import chip_smoke
    from maveric_slam_tpu_torch.backend import ba, sparse_ba

    scene, _ = chip_smoke.ba_scene(num_landmarks=256)
    out = {}
    for dev in ("cpu", "cuda"):
        prob = ba.BAProblem(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in scene))
        out[dev] = (ba.bundle_adjust(prob), sparse_ba.bundle_adjust(sparse_ba.from_dense(prob)))
    ((dc, _), (sc, _)), ((dg, stats), (sg, costs)) = out["cpu"], out["cuda"]
    for a, b in ((dg, dc), (sg, sc)):
        assert float((a.R.cpu() - b.R).abs().max()) <= 1e-4
        assert float((a.t.cpu() - b.t).abs().max()) <= 1e-3
    c = stats.cost.cpu().numpy()
    assert np.all(np.diff(c) <= 0) and np.all(np.diff(costs.cpu().numpy()) <= 0)
    assert float((sg.t - dg.t).abs().max()) <= 2e-3 and float((sg.R - dg.R).abs().max()) <= 2e-4


def test_pose_graph_card_vs_cpu(cuda):
    """A 21-pose drifting loop padded as slam.py pads (32 nodes, 64 edges),
    8 iterations: the card within 1e-4 of the CPU, drift reduced."""
    import chip_smoke
    from maveric_slam_tpu_torch.backend import pose_graph

    fields, (_, t_gt) = chip_smoke.loop_graph(n=21, pad_nodes=32, pad_edges=64)
    out = {}
    for dev in ("cpu", "cuda"):
        graph = pose_graph.PoseGraph(*(torch.from_numpy(a).to(dev) for a in fields))
        out[dev] = pose_graph.optimize(graph, iterations=8)
    (oc, cc), (og, cg) = out["cpu"], out["cuda"]
    assert float((og.R.cpu() - oc.R).abs().max()) <= 1e-4
    assert float((og.t.cpu() - oc.t).abs().max()) <= 1e-4
    after = np.linalg.norm(og.t.cpu().numpy()[:21] - t_gt, axis=-1)
    before = np.linalg.norm(fields[1][:21] - t_gt, axis=-1)
    assert float(cg[-1]) < float(cg[0]) / 100 and after.mean() < before.mean()


def test_mesh_nccl_world_size_one(cuda):
    """The sharded layer through the NCCL path: one rank on the card
    (`parallel.mesh.spawn`, NCCL chosen because the rank has a card of its
    own). Landmark-sharded BA at P = 8, L = 1024 is the single-device
    `bundle_adjust` bit for bit on a mesh of one; the LCD ring, a query and
    the word-sharded pool equal the single-device functions on the CPU."""
    import chip_smoke
    import torch_mesh_worker as worker
    from maveric_slam_tpu_torch.loopclosure import lcd
    from maveric_slam_tpu_torch.mapping import feature_pool
    from maveric_slam_tpu_torch.parallel import mesh as tmesh

    scene, _ = chip_smoke.ba_scene()
    rng = np.random.default_rng(7)
    sets = [rng.choice(2048, 64, replace=False).astype(np.int32) for _ in range(40)]
    frames = [rng.integers(-1, 2048, (96,)).astype(np.int32) for _ in range(6)]
    queries = [rng.integers(-1, 2048, (64,)).astype(np.int32) for _ in range(6)]
    spec = {
        "ba": ("solve_ba", 1, "ldmk", dict(problem=scene, iterations=10)),
        "single": ("single_ba", 1, "ldmk", dict(problem=scene, iterations=10)),
        "ring": ("lcd_ring", 1, "lcdf", dict(frame_sets=sets, cap=32, vocab=2048)),
        "query": ("lcd_queries", 1, "lcdf", dict(frame_sets=sets, cap=32, vocab=2048,
                                                  probes=[sets[3], sets[39]], current=40, gap=4,
                                                  min_score=0.05)),
        "pool": ("pool_run", 1, "word", dict(frames=frames, queries=queries, vocab=2048, window=4)),
    }
    (r,) = tmesh.spawn(worker.components, 1, args=(spec, None), timeout_s=300)
    assert r["backend"] == "nccl"
    for k in ("R", "t", "X", "cost"):
        np.testing.assert_array_equal(r["ba"][k], r["single"][k], k)
    db = lcd.create_database(32, 2048)
    for f, ids in enumerate(sets):
        db = lcd.add_frame(db, torch.from_numpy(ids), f)
    for name in ("multihot", "counts", "frames", "valid"):
        np.testing.assert_array_equal(r["ring"][name], getattr(db, name).numpy(), name)
    want = [lcd.query(db, torch.from_numpy(ids), 40, min_frame_gap=4, min_score=0.05)
            for ids in (sets[3], sets[39])]
    assert r["query"] == [(int(w.best), int(w.best_frame), float(w.best_score)) for w in want]
    pool = feature_pool.create(2048, window=4)
    for f, (ids, q) in enumerate(zip(frames, queries)):
        pool = feature_pool.remove_old(feature_pool.observe_batch(pool, torch.from_numpy(ids), f), f)
        np.testing.assert_array_equal(
            r["pool"]["weights"][f], feature_pool.covisibility_weights(pool, torch.from_numpy(q)).numpy())
    np.testing.assert_array_equal(r["pool"]["num_sightings"], pool.num_sightings.numpy())


def _two_view(rng, n=1000):
    """Random points 4-12 m ahead, a small motion: normalized projections
    p1, p2 and the true (R, t), as numpy."""
    X = np.stack([rng.uniform(-4, 4, n), rng.uniform(-2, 2, n), rng.uniform(4, 12, n)], -1)
    w = rng.normal(size=3) * 0.05
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]]) / th
    R = np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * K @ K
    t = rng.normal(size=3)
    t *= 0.5 / np.linalg.norm(t)
    X2 = X @ R.T + t
    return ((X[:, :2] / X[:, 2:]).astype(np.float32), (X2[:, :2] / X2[:, 2:]).astype(np.float32),
            R.astype(np.float32), t.astype(np.float32))


def test_surface_svd3_functions_launch_the_kernel(cuda):
    """polar_decomposition, decompose_essential and recover_pose launch the
    svd3 kernel once each (as the JAX functions reach svd3_pallas) and agree
    with the CPU: R P reconstructs A within 1e-3 max|A|, the rotation pair
    and t (up to sign) within 1e-3, recover_pose's pose within 1e-3 and
    its counts equal on points with depth well away from 0."""
    from maveric_slam_tpu_torch.geometry import epipolar
    from maveric_slam_tpu_torch.ops import kernels, svd3 as svd3_ops

    rng = np.random.default_rng(21)
    p1, p2, R, t = _two_view(rng)
    E = epipolar.essential_from_pose(torch.from_numpy(R), torch.from_numpy(t))
    E = torch.stack([E * s for s in np.linspace(0.5, 2.0, 64, dtype=np.float32)])
    A = torch.from_numpy(rng.normal(size=(64, 3, 3)).astype(np.float32))
    args = {"polar": (A,), "decompose": (E,), "recover": (E, torch.from_numpy(p1), torch.from_numpy(p2))}
    fns = {"polar": svd3_ops.polar_decomposition, "decompose": epipolar.decompose_essential,
           "recover": epipolar.recover_pose}
    out = {}
    for dev in ("cuda", "cpu"):
        kernels.reset_launch_counts()
        out[dev] = {k: [x.cpu() for x in fns[k](*(a.to(dev) for a in args[k]))] for k in fns}
        out[dev]["launches"] = kernels.launch_counts()
    assert out["cuda"]["launches"]["svd3"] == 3 and sum(out["cuda"]["launches"].values()) == 3
    (Rg, Pg), (Rc, Pc) = out["cuda"]["polar"], out["cpu"]["polar"]
    m = float(A.abs().max())
    assert float((Rg @ Pg - A).abs().max()) <= 1e-3 * m and float((Pg - Pc).abs().max()) <= 1e-3 * m
    (R1, R2, tt), (R1c, R2c, tc) = out["cuda"]["decompose"], out["cpu"]["decompose"]
    same = torch.maximum((R1 - R1c).abs().amax((-1, -2)), (R2 - R2c).abs().amax((-1, -2)))
    swapped = torch.maximum((R1 - R2c).abs().amax((-1, -2)), (R2 - R1c).abs().amax((-1, -2)))
    assert float(torch.minimum(same, swapped).max()) <= 1e-3
    assert float(torch.minimum((tt - tc).abs().amax(-1), (tt + tc).abs().amax(-1)).max()) <= 1e-3
    (Rr, tr, nr), (Rrc, trc, nrc) = out["cuda"]["recover"], out["cpu"]["recover"]
    assert torch.equal(nr, nrc) and (nr == 1000).all()
    assert float((Rr - Rrc).abs().max()) <= 1e-3 and float((tr - trc).abs().max()) <= 1e-3


def test_superpoint_float_card_vs_cpu(cuda):
    """The float net with TF32 off at (1, 96, 320): launches no kernel of
    the port, and the card's largest error against the network in float64
    on the CPU is at most twice the CPU's f32 error (ROADMAP Faults (q))."""
    from maveric_slam_tpu_torch.ops import kernels

    assert not torch.backends.cuda.matmul.allow_tf32 and not torch.backends.cudnn.allow_tf32
    img = torch.from_numpy(_orbit96((0,))[0][None])
    out = {}
    for name, dev, dtype in (("card", "cuda", torch.float32), ("cpu", "cpu", torch.float32),
                             ("f64", "cpu", torch.float64)):
        params = sp.load_params(device=dev)
        if dtype == torch.float64:
            params = {k: v.double() if v.is_floating_point() else v for k, v in params.items()}
        kernels.reset_launch_counts()
        out[name] = [x.cpu().double() for x in sp.superpoint_float(params, img.to(dev, dtype), dtype)]
        assert not any(kernels.launch_counts().values())
    for k in range(2):
        g, c, x = out["card"][k], out["cpu"][k], out["f64"][k]
        assert float((g - x).abs().max()) <= 2 * float((c - x).abs().max())


# The pose refinement's kernel against its plain version, on the problems
# of tests/pnp_problems.py. Bars: the kernel in float32 sums in another
# order than the plain version's batched products, so it is held to the
# plain version run in float64 on the same inputs, within four times the
# plain float32 version's own gap to it plus eight float32 ulps of the
# quantity's scale.

def _amax(x):
    return float(x.abs().max()) if x.numel() else 0.0


def _check_refine_pose(args):
    """Kernel against plain: R, t and cost at the bars above, num_used
    exactly, one launch. Returns the kernel's result on the CPU."""
    before = refine_pose.launches
    got = refine_pose.refine_pose(*(a.cuda() for a in args))
    torch.cuda.synchronize()
    assert refine_pose.launches == before + 1
    plain = refine_pose.refine_pose_plain(*(a.cuda() for a in args))
    f64 = refine_pose.refine_pose_plain(*(a.cuda().double() if a.is_floating_point() else a.cuda()
                                          for a in args))
    got, plain, f64 = (type(r)(*(x.cpu() for x in r)) for r in (got, plain, f64))
    for name in ("R", "t", "cost"):
        g, p, x = (getattr(r, name).double() for r in (got, plain, f64))
        finite = torch.isfinite(x)
        assert torch.equal(torch.isfinite(g), finite), name
        ulp = float(torch.finfo(torch.float32).eps)
        bar = 4 * _amax((p - x)[finite]) + 8 * ulp * max(1.0, _amax(x[finite]))
        assert _amax((g - x)[finite]) <= bar, (name, _amax((g - x)[finite]), bar)
    assert got.num_used.dtype == torch.int32 and torch.equal(got.num_used, plain.num_used)
    return got


@pytest.mark.parametrize("s, n", [(16, 100), (1, 100), (3, 37), (2, 300)])
def test_refine_pose(cuda, s, n):
    """The main path's calls (S = 16 and 1 of N = 100), a ragged N and
    N > 128 (the block-stride loop past the registers' first factor)."""
    _check_refine_pose(pnp_problem(s, n, seed=s * 1000 + n))


def test_refine_pose_edge_cases(cuda):
    """A row with every mask false comes back unchanged (cost 0, num_used
    0); points at or behind z = 0 (the 1e-6 clamp) within the bars; a NaN
    in R0 gives NaN in that row's R and t, as the plain version does, and
    leaves the other rows as they are alone; N = 0."""
    K, R0, t0, X, z, mask = pnp_problem(4, 100, seed=5)
    mask[1] = False
    X[2, :10, 2] = -X[2, :10, 2]
    X[2, 10:20, 2] = 0.0
    R0[3, 0, 1] = float("nan")
    got = _check_refine_pose((K, R0, t0, X, z, mask))
    assert torch.equal(got.R[1], R0[1]) and torch.equal(got.t[1], t0[1])
    assert float(got.cost[1]) == 0.0 and int(got.num_used[1]) == 0
    assert torch.isnan(got.R[3]).all() and torch.isnan(got.t[3]).all()
    for k in (0, 1, 2):
        alone = refine_pose.refine_pose(*(a.cuda() for a in (K, R0[k:k + 1], t0[k:k + 1], X[k:k + 1],
                                                           z[k:k + 1], mask[k:k + 1])))
        assert all(torch.equal(a[0].cpu(), b[k]) for a, b in zip(alone, got)), k
    empty = refine_pose.refine_pose(*(a.cuda() for a in (K, R0, t0, X[:, :0], z[:, :0], mask[:, :0])))
    assert torch.equal(empty.R[:3].cpu(), R0[:3]) and torch.equal(empty.t.cpu(), t0)
    assert not empty.cost.any() and not empty.num_used.any()


def test_refine_pose_deterministic_and_batch_invariant(cuda):
    """Two runs are bitwise equal, and stream s of an S = 16 call equals an
    S = 1 call on its inputs bit for bit (the bitwise resume and mesh
    replays rely on both)."""
    args = tuple(a.cuda() for a in pnp_problem(16, 100, seed=6))
    first, second = refine_pose.refine_pose(*args), refine_pose.refine_pose(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))
    for k in range(16):
        alone = refine_pose.refine_pose(args[0], *(a[k:k + 1] for a in args[1:]))
        assert all(torch.equal(a[0], b[k]) for a, b in zip(alone, first)), k


def test_tracker_step_launches_refine_pose_once(cuda):
    """A tracker step on the card makes exactly one refine_pose launch,
    whatever S: `Tracker` at S = 1 and `track_step_batched` at S = 3."""
    from maveric_slam_tpu_torch.frontend import tracker as trk
    from maveric_slam_tpu_torch.ops import kernels

    cfg, fr = _config96(), _orbit96(range(4))
    params = sp.load_params(device=cuda)
    tr = trk.Tracker(params, cfg, seed=0, device=cuda)
    tr.process(fr[0])
    for k in (1, 2, 3):
        kernels.reset_launch_counts()
        tr.process(fr[k])
        torch.cuda.synchronize()
        assert kernels.launch_counts()["refine_pose"] == 1, k
    imgs = torch.from_numpy(np.stack([fr[0], fr[1], fr[2]])).to(cuda)
    state = trk.init_states_batched(params, imgs, cfg)
    kernels.reset_launch_counts()
    nxt = torch.from_numpy(np.stack([fr[1], fr[2], fr[3]])).to(cuda)
    state, res = trk.track_step_batched(params, state, nxt, cfg)
    torch.cuda.synchronize()
    assert kernels.launch_counts()["refine_pose"] == 1 and res.R.shape == (3, 3, 3)

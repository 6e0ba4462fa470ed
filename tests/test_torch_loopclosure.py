"""The port's loop-closure modules against the JAX package on the CPU:
`binarize_descriptors` and `assign_words` on the reference vocabulary and
image0's golden descriptors, and the BoW database (`add_frame`, `query`) on
tests/test_loopclosure.py's cases. Every bar is exact.

The JAX package loads its vocabulary through `refdata`, which first looks
for the reference's header and fails where that is absent; here its
`Vocabulary` is built from the same cached arrays with its own
`_unpack_pm1`, as `refdata.vocabulary` would transform them.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from maveric_slam_tpu.loopclosure import lcd as jlcd
from maveric_slam_tpu.loopclosure import vocab as jvocab
from maveric_slam_tpu.ops import softmax_topn as jst
from maveric_slam_tpu_torch.loopclosure import lcd as tlcd
from maveric_slam_tpu_torch.loopclosure import vocab as tvocab
import torch_threads  # noqa: F401  (the tests' one torch thread policy)

REFCACHE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "maveric_slam_tpu", "data", "_refcache")


def jax_vocabulary():
    """The JAX package's Vocabulary from the cached header arrays, with
    refdata.py:130-141's transforms."""
    with np.load(os.path.join(REFCACHE, "include_data_LCD_vocabulary.h.npz")) as z:
        leaves = z["leaf_descriptors"].astype(np.int64).astype(np.uint32)
        return jvocab.Vocabulary(
            base_descriptors=jnp.asarray(np.ascontiguousarray(z["base_descriptors"].astype(np.int8).T)),
            scale=jnp.asarray(z["scale_arr"].astype(np.float32)),
            bias=jnp.asarray(z["bias_arr"].astype(np.float32)),
            leaf_words=jnp.asarray(leaves),
            leaf_bits=jnp.asarray(jvocab._unpack_pm1(leaves)),
            num_base_nodes=int(z["num_base_nodes"]),
            words_per_base_node=int(z["words_per_base_node"]),
        )


@pytest.fixture(scope="module")
def vocabs():
    return jax_vocabulary(), tvocab.load_reference_vocabulary(device="cpu")


@pytest.fixture(scope="module")
def features():
    """Top-100 features of image0 (bow_main.c:62-77), with refdata.py:88-91's
    layout: the header's patch order is column-major."""
    with np.load(os.path.join(REFCACHE, "include_data_quantized_quantized_image0.h.npz")) as d:
        hc, wc = int(d["image0_feature_rows"]), int(d["image0_feature_cols"])
        semi = d["image0_semi"].reshape(wc, hc, 65).transpose(1, 0, 2).copy()
        desc = d["image0_desc"].reshape(wc, hc, 256).transpose(1, 0, 2).copy()
        semi_scale, desc_scale = np.float32(d["image0_semi_scale"]), np.float32(d["image0_desc_scale"])
    grid = jst.approx_softmax_grid(semi, semi_scale)
    top = jst.top_n_select(grid, n=100, mode="reference")
    return desc.reshape(-1, 256)[np.asarray(top.cells)], desc_scale, np.array(top.mask)


def test_vocabulary_arrays_equal(vocabs):
    jv, tv = vocabs
    assert (tv.num_base_nodes, tv.words_per_base_node) == (jv.num_base_nodes, jv.words_per_base_node)
    for name in ("base_descriptors", "scale", "bias", "leaf_words", "leaf_bits"):
        a, b = np.asarray(getattr(jv, name)), getattr(tv, name).numpy()
        assert a.shape == b.shape, name
        np.testing.assert_array_equal(a.astype(np.int64) if a.dtype == np.uint32 else a, b, name)


def test_binarize_matches_jax(features):
    desc, _, _ = features
    got = tvocab.binarize_descriptors(torch.from_numpy(desc)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jvocab.binarize_descriptors(desc)).astype(np.int64))


def _cases(features):
    """(label, desc, desc_scale, mask): image0's features, the same with the
    first 10 masked, and 64 seeded random descriptors with half masked."""
    desc, scale, mask = features
    m2 = mask.copy()
    m2[:10] = False
    rng = np.random.default_rng(7)
    rdesc = rng.integers(-128, 128, (64, 256)).astype(np.int8)
    return {"image0": (desc, scale, mask), "image0 masked": (desc, scale, m2),
            "random": (rdesc, np.float32(0.0173), rng.random(64) < 0.5)}


@pytest.mark.parametrize("case", ["image0", "image0 masked", "random"])
@pytest.mark.parametrize("positive_gate", [False, True])
def test_assign_words_matches_jax(vocabs, features, case, positive_gate):
    """All four fields exactly equal, in both gate modes."""
    jv, tv = vocabs
    desc, scale, mask = _cases(features)[case]
    want = jvocab.assign_words(desc, scale, mask, jv, positive_gate=positive_gate)
    got = tvocab.assign_words(torch.from_numpy(desc), torch.tensor(scale), torch.from_numpy(mask),
                              tv, positive_gate=positive_gate)
    for field in jvocab.WordAssignment._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      field)
    assert (got.word_id.numpy()[~mask] == -1).all()
    if not positive_gate and case.startswith("image0"):
        assert len(set(got.base_node.numpy()[mask].tolist())) > 1  # more than node 0


def _padded(ids, n=256):
    out = np.full(n, -1, np.int32)
    out[: len(ids)] = ids
    return out


def _both_add(dbs, ids, frame):
    jdb, tdb = dbs
    return (jlcd.add_frame(jdb, np.asarray(ids, np.int32), frame),
            tlcd.add_frame(tdb, torch.from_numpy(np.asarray(ids, np.int32)), frame))


def _assert_db_equal(jdb, tdb):
    for name in ("multihot", "counts", "frames", "valid"):
        np.testing.assert_array_equal(getattr(tdb, name).numpy(), np.asarray(getattr(jdb, name)), name)
    assert tdb.next_slot == int(jdb.next_slot)


def _query_both(dbs, ids, frame, **kw):
    jdb, tdb = dbs
    want = jlcd.query(jdb, np.asarray(ids, np.int32), current_frame=np.int32(frame), **kw)
    got = tlcd.query(tdb, torch.from_numpy(np.asarray(ids, np.int32)), current_frame=frame, **kw)
    for field in jlcd.LoopCandidates._fields:
        np.testing.assert_array_equal(getattr(got, field).numpy(), np.asarray(getattr(want, field)),
                                      field)
    return got


def _merge_join(ids_a, ids_b):
    """lcd_main.c:52-74: sorted-list intersection count."""
    a, b = sorted(set(ids_a)), sorted(set(ids_b))
    i = j = n = 0
    while i < len(a) and j < len(b):
        if a[i] == b[j]:
            n, i, j = n + 1, i + 1, j + 1
        elif a[i] < b[j]:
            i += 1
        else:
            j += 1
    return n


def test_lcd_scores_match_merge_join():
    rng = np.random.default_rng(31)
    dbs = (jlcd.create_database(64, 10000), tlcd.create_database(64, 10000))
    frames = []
    for f in range(20):
        ids = rng.choice(10000, size=rng.integers(50, 200), replace=False)
        frames.append(ids)
        dbs = _both_add(dbs, _padded(ids), f)
    _assert_db_equal(*dbs)
    got = _query_both(dbs, _padded(frames[3]), 20, min_frame_gap=5)
    for f in range(15):  # outside the recency window
        assert int(got.scores[f]) == _merge_join(frames[f], frames[3]), f
    assert int(got.best) == 3 and float(got.best_score) == 1.0


def test_lcd_recency_gating():
    rng = np.random.default_rng(32)
    dbs = (jlcd.create_database(64, 10000), tlcd.create_database(64, 10000))
    ids = _padded(rng.choice(10000, 100, replace=False))
    for f in range(10):
        dbs = _both_add(dbs, ids, f)  # identical recent frames
    got = _query_both(dbs, ids, 10, min_frame_gap=50)
    assert int(got.best) == -1


def test_lcd_ring_buffer_wraps():
    dbs = (jlcd.create_database(4, 100), tlcd.create_database(4, 100))
    for f in range(6):
        ids = np.full(8, -1, np.int32)
        ids[0] = f * 10
        dbs = _both_add(dbs, ids, f)
    _assert_db_equal(*dbs)
    assert dbs[1].next_slot == 2 and dbs[1].frames.tolist() == [4, 5, 2, 3]


def test_lcd_recency_correct_past_wraparound():
    """After the ring wraps, low slots hold the newest frames: gating must
    follow frame numbers, not slots."""
    rng = np.random.default_rng(33)
    cap = 8
    dbs = (jlcd.create_database(cap, 1000), tlcd.create_database(cap, 1000))
    word_sets = []
    n_frames = 3 * cap + 2
    for f in range(n_frames):
        ids = rng.choice(1000, 64, replace=False).astype(np.int32)
        word_sets.append(ids)
        dbs = _both_add(dbs, ids, f)
    _assert_db_equal(*dbs)
    oldest = n_frames - cap
    got = _query_both(dbs, word_sets[oldest], n_frames, min_frame_gap=3, min_score=0.5)
    assert int(got.best_frame) == oldest and float(got.best_score) == 1.0
    got = _query_both(dbs, word_sets[-1], n_frames, min_frame_gap=3, min_score=0.99)
    assert int(got.best) == -1


@pytest.mark.parametrize("ids", [
    [0, 0, -1, 5, -1, 0, 7, 7],  # word 0 hit twice, beside invalid entries
    [-1, -1, 3, 3, -1],  # invalid entries only beside a duplicate: word 0 stays 0
    [-1] * 8,  # no valid word at all
    [9, 0, 9, -1, 0, 9, 2, -1],
])
def test_lcd_duplicates_invalid_and_word_zero(ids):
    """A word list holding duplicates, -1 entries and word 0 together: rows,
    counts and query scores equal JAX's, and word 0 is set only when it is
    in the list."""
    rng = np.random.default_rng(34)
    dbs = (jlcd.create_database(8, 16), tlcd.create_database(8, 16))
    for f in range(3):
        dbs = _both_add(dbs, rng.integers(-1, 16, 12).astype(np.int32), f)
    dbs = _both_add(dbs, ids, 3)
    _assert_db_equal(*dbs)
    row = dbs[1].multihot[3].numpy()
    assert row[0] == (0 in ids) and row.sum() == len({i for i in ids if i >= 0})
    _query_both(dbs, ids, 100, min_frame_gap=0, min_score=0.0)
    _query_both(dbs, [0, -1, -1, 0], 100, min_frame_gap=0, min_score=0.0)

"""The port's batched semi-join (``repro_torch.kernels.ops.semijoin_mask``)
against a numpy oracle (``np.isin``), on CPU tensors (its plain
version).  The file imports neither JAX nor the JAX package, so it also
runs on a machine with a card and no JAX: ``test_cuda_kernel_matches_plain``
holds the CUDA kernel against its plain version there (marked ``cuda``;
it skips without a device).  The JAX package's kernel is held against
the same wrapper in ``tests/test_torch_extvp_build.py``."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import build, ops, ref

PROBE_PAD, BUILD_PAD = 2**31 - 1, 2**31 - 2


def _pair_cases():
    """(name, [(probe, build_sorted), ...]) batches on the host."""
    rng = np.random.default_rng(3)

    def build_of(n, lo, hi):
        return np.unique(rng.integers(lo, hi, n)).astype(np.int32)

    out = [
        ("sentinels", [(np.array([5, PROBE_PAD, 9, BUILD_PAD, -1, 0, 7],
                                 np.int32),
                        np.array([-1, 0, 5, 9, BUILD_PAD], np.int32))]),
        ("pads-never-match", [(np.full(9, PROBE_PAD, np.int32),
                               np.full(4, BUILD_PAD, np.int32))]),
        ("empty-build", [(np.arange(50, dtype=np.int32),
                          np.empty(0, np.int32))]),
        ("empty-probe", [(np.empty(0, np.int32), build_of(40, 0, 60))]),
        ("build-of-one", [(rng.integers(0, 4, 300).astype(np.int32),
                           np.array([2], np.int32))]),
        ("probe-not-in-order", [(rng.permutation(1000).astype(np.int32),
                                 build_of(300, 0, 1200))]),
    ]
    # a ragged batch: block-boundary lengths, empty sides in the middle
    pairs = []
    for n_a, n_b in [(255, 7), (256, 1), (257, 300), (0, 5), (1, 0),
                     (1000, 513), (3001, 2000), (2, 2)]:
        pairs.append((rng.integers(0, 900, n_a).astype(np.int32),
                      build_of(n_b, 0, 900)))
    out.append(("ragged-batch", pairs))
    return out


CASES = _pair_cases()


def _span_build(rng, n, lo, span):
    """``n`` ascending unique keys whose first is ``lo`` and whose last is
    ``lo + span - 1``."""
    if n == 1:
        return np.array([lo], np.int64).astype(np.int32)
    mid = rng.choice(span - 2, n - 2, replace=False) + 1 + lo
    return np.sort(np.concatenate([[lo, lo + span - 1], mid])).astype(np.int32)


def _probe_near(rng, b, n):
    """Probe keys around a build segment: members, keys inside and just
    outside its range, and both pads."""
    lo, hi = int(b[0]), int(b[-1])
    near = rng.integers(max(lo - 64, -2**31), min(hi + 65, 2**31 - 2),
                        n - n // 2 - 4)
    edge = [max(lo - 1, -2**31), min(hi + 1, BUILD_PAD), PROBE_PAD, BUILD_PAD]
    a = np.concatenate([rng.choice(b, n // 2), near, edge])
    return rng.permutation(a).astype(np.int32)


def _plan_cases():
    """A batch that mixes the bitmap and the search path, and a batch at
    the density rule's edges (``ops.SEMIJOIN_BITMAP_*`` at their values:
    1 word a key, 65,536 words at least)."""
    rng = np.random.default_rng(5)
    floor = ops.SEMIJOIN_BITMAP_MIN_WORDS
    mixed = [_span_build(rng, 300, 1000, 1000),      # 32 words, 1,000 ids
             _span_build(rng, 10, -1, 2**31),        # the sentinels' span
             _span_build(rng, 16, 5000, 32 * floor + 1),
             _span_build(rng, 1, 77, 1),
             _span_build(rng, 2000, -300, 40_000),
             np.full(3, BUILD_PAD, np.int32)]
    edge = [_span_build(rng, 70_000, 0, 32 * 70_000),       # at the rule
            _span_build(rng, 70_000, 0, 32 * 70_000 + 1),   # a word past
            _span_build(rng, 16, 123, 32 * floor),          # at the floor
            _span_build(rng, 16, 123, 32 * floor + 1)]      # a word past
    return [("mixed-paths", [(_probe_near(rng, b, 1500 + 7 * i), b)
                             for i, b in enumerate(mixed)]),
            ("threshold-edges", [(_probe_near(rng, b, 3000), b)
                                 for b in edge])]


#: the unit cases and two batches aimed at the presence-bitmap plan
PLAN_CASES = CASES + _plan_cases()
#: which segments of each PLAN_CASES batch take the bitmap, pair by pair
#: (every pair of these batches has its own segment)
EXPECT_BITMAP = {"sentinels": [False], "empty-build": [False],
                 "mixed-paths": [True, False, False, True, True, True],
                 "threshold-edges": [True, False, True, False]}


def _pack(batch):
    """Concatenate a batch's sides; the ``pairs`` rows into them."""
    probe = np.concatenate([a for a, _ in batch] + [np.zeros(0, np.int32)])
    build_ = np.concatenate([b for _, b in batch] + [np.zeros(0, np.int32)])
    la = np.array([len(a) for a, _ in batch], np.int64)
    lb = np.array([len(b) for _, b in batch], np.int64)
    pairs = np.stack([np.cumsum(la) - la, la, np.cumsum(lb) - lb, lb], axis=1)
    return probe.astype(np.int32), build_.astype(np.int32), pairs


def _oracle(batch):
    masks = [np.isin(a, b).astype(np.uint8) for a, b in batch]
    return (np.concatenate(masks + [np.zeros(0, np.uint8)]),
            np.array([int(m.sum()) for m in masks], np.int64))


@pytest.mark.parametrize("name,batch", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_plain_matches_oracle(name, batch):
    probe, build_, pairs = _pack(batch)
    mask, counts = ops.semijoin_mask(torch.from_numpy(probe),
                                     torch.from_numpy(build_), pairs)
    assert mask.dtype == torch.uint8 and counts.dtype == torch.int64
    want_mask, want_counts = _oracle(batch)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(counts.numpy(), want_counts)


def test_batch_of_one_is_the_default():
    a, b = CASES[-2][1][0]
    m1, c1 = ops.semijoin_mask(torch.from_numpy(a), torch.from_numpy(b))
    m2 = ref.semijoin_membership_ref(torch.from_numpy(a), torch.from_numpy(b))
    assert m2.dtype == torch.int32
    np.testing.assert_array_equal(m1.numpy(), m2.numpy())
    assert c1.tolist() == [int(m2.sum())]


def test_wrapper_rejects_out_of_range_pairs_and_mixed_devices():
    a = torch.arange(10, dtype=torch.int32)
    b = torch.arange(5, dtype=torch.int32)
    for bad in ([[0, 11, 0, 5]], [[0, 10, 1, 5]], [[-1, 2, 0, 1]]):
        with pytest.raises(ValueError, match="outside"):
            ops.semijoin_mask(a, b, np.array(bad))
    with pytest.raises(ValueError, match="CUDA"):
        ops.semijoin_mask(torch.empty(3, dtype=torch.int32, device="meta"),
                          b)


def test_cpu_path_launches_no_kernel():
    before = dict(ops.launches)
    ops.semijoin_mask(torch.arange(10, dtype=torch.int32),
                      torch.arange(5, dtype=torch.int32))
    assert ops.launches == before
    assert "semijoin_membership" in ops.launches


def test_build_names_the_semijoin_library():
    path = build.library_path("semijoin_membership")
    assert path.name.startswith("libsemijoin_membership-")
    assert (build.CSRC / build.SOURCES["semijoin_membership"]).exists()


# ---------------------------------------------------------------------------
# The presence-bitmap plan and its plain versions
# ---------------------------------------------------------------------------

FLOOR = ops.SEMIJOIN_BITMAP_MIN_WORDS


@pytest.mark.parametrize("n,span,bitmap", [
    (70_000, 32 * 70_000, True), (70_000, 32 * 70_000 + 1, False),
    (16, 32 * FLOOR, True), (16, 32 * FLOOR + 1, False),
    (1, 1, True), (4, 1, True), (5, 2**31, False), (2**20, 2**32, False),
    (0, 0, False)], ids=lambda v: str(v))
def test_plan_density_rule(n, span, bitmap):
    """``ceil(span / 32)`` words against ``max(n, 65,536)``, in int64."""
    pairs = np.array([[0, 10, 0, n]], np.int64)
    first = np.array([-2**31 if span > 2**31 else -1], np.int64)
    plan = ops._semijoin_plan(pairs, first, first + span - 1)
    assert plan.bitmap.tolist() == [bitmap]
    words = -(-span // 32) if bitmap else 0
    assert plan.words.tolist() == [words] and plan.n_words == words
    assert plan.word_off.tolist() == [0 if bitmap else -1]
    assert plan.lo.tolist() == [int(first[0]) if bitmap else 0]


@pytest.mark.parametrize("name,batch", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_plan_segments_and_word_offsets(name, batch):
    """One plan entry per distinct build segment, each pair mapped to its
    own; bitmaps end to end in segment order; empty segments and sparse
    ones (the sentinels' span) on the search path."""
    probe, build_, pairs = _pack(batch)
    plan = ops.semijoin_plan(torch.from_numpy(build_), pairs)
    distinct = sorted({(int(o), int(n)) for o, n in pairs[:, 2:4]})
    assert [tuple(r) for r in plan.segs.tolist()] == distinct
    np.testing.assert_array_equal(plan.segs[plan.seg_of_pair], pairs[:, 2:4])
    n = plan.segs[:, 1]
    assert not plan.bitmap[n == 0].any()
    words = plan.words[plan.bitmap]
    np.testing.assert_array_equal(plan.word_off[plan.bitmap],
                                  np.cumsum(words) - words)
    assert plan.n_words == int(words.sum())
    assert (plan.word_off[~plan.bitmap] == -1).all()
    assert (plan.words[~plan.bitmap] == 0).all()
    for s in range(len(plan.segs)):
        off, m = (int(v) for v in plan.segs[s])
        if not m:
            continue
        first, last = int(build_[off]), int(build_[off + m - 1])
        want = -(-(last - first + 1) // 32)
        assert plan.bitmap[s] == (want <= max(m, FLOOR)), (name, s)
        if plan.bitmap[s]:
            assert plan.words[s] == want and plan.lo[s] == first
    if name in EXPECT_BITMAP:
        assert plan.bitmap[plan.seg_of_pair].tolist() == EXPECT_BITMAP[name]


def test_plan_shares_one_bitmap_among_pairs_of_one_segment():
    """Pairs that read one build segment get one bitmap; the batch's
    masks are still each pair's own."""
    _, batch = PLAN_CASES[-2]
    probe, build_, pairs = _pack(batch)
    twice = np.concatenate([pairs, pairs[::-1], pairs[:2]])
    b = torch.from_numpy(build_)
    plan = ops.semijoin_plan(b, twice)
    assert len(plan.segs) == len(pairs)
    assert plan.n_words == ops.semijoin_plan(b, pairs).n_words
    words = ref.semijoin_bitmaps_ref(b, plan)
    mask, counts = ref.semijoin_pairs_bitmap_ref(torch.from_numpy(probe), b,
                                                 twice, plan, words)
    rows = list(batch) + list(batch)[::-1] + list(batch)[:2]
    want_mask, want_counts = _oracle(rows)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(counts.numpy(), want_counts)


def test_plan_constants_at_zero_send_every_segment_to_the_search(monkeypatch):
    monkeypatch.setattr(ops, "SEMIJOIN_BITMAP_DENSITY", 0)
    monkeypatch.setattr(ops, "SEMIJOIN_BITMAP_MIN_WORDS", 0)
    probe, build_, pairs = _pack(PLAN_CASES[-2][1])
    plan = ops.semijoin_plan(torch.from_numpy(build_), pairs)
    assert not plan.bitmap.any() and plan.n_words == 0


@pytest.mark.parametrize("name,batch", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_bitmap_path_matches_plain_and_oracle(name, batch):
    """The plain bitmap build sets exactly each bitmap segment's keys;
    probing through it (the search for the other segments) gives the
    plain version's and ``np.isin``'s masks and counts."""
    probe, build_, pairs = _pack(batch)
    a, b = torch.from_numpy(probe), torch.from_numpy(build_)
    plan = ops.semijoin_plan(b, pairs)
    words = ref.semijoin_bitmaps_ref(b, plan)
    assert words.dtype == torch.int32 and words.shape == (plan.n_words,)
    assert torch.equal(ops.semijoin_bitmaps(b, plan), words)
    bits = words.numpy().view(np.uint32)
    for s in np.nonzero(plan.bitmap)[0]:
        off, m = (int(v) for v in plan.segs[s])
        seg = bits[plan.word_off[s]:plan.word_off[s] + plan.words[s]]
        x = np.unique(build_[off:off + m].astype(np.int64)) - plan.lo[s]
        want = np.zeros(len(seg), np.uint64)
        np.bitwise_or.at(want, x >> 5, np.uint64(1) << (x & 31).astype(
            np.uint64))
        np.testing.assert_array_equal(seg.astype(np.uint64), want)
    mask, counts = ref.semijoin_pairs_bitmap_ref(a, b, pairs, plan, words)
    want_mask, want_counts = _oracle(batch)
    np.testing.assert_array_equal(mask.numpy(), want_mask)
    np.testing.assert_array_equal(counts.numpy(), want_counts)
    plain_mask, plain_counts = ref.semijoin_pairs_ref(a, b, pairs)
    assert torch.equal(mask, plain_mask) and torch.equal(counts, plain_counts)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernels against their plain versions on the card, on every
    case above (the mixed-path and threshold-edge batches among them), on
    a batch whose pairs share segments, and on a large ragged batch, with
    the probe also as a view one key past a 16-byte boundary: the bitmap
    words, the masks, the counts and ``ops.semijoin_paths``
    (``-m cuda`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    big = [(rng.integers(0, 1 << 20, int(n)).astype(np.int32),
            np.unique(rng.integers(0, 1 << 20, int(m))).astype(np.int32))
           for n, m in zip(rng.integers(0, 200_000, 64),
                           rng.integers(0, 300_000, 64))]
    runs = [(name, *_pack(batch)) for name, batch in
            PLAN_CASES + [("large-batch", big)]]
    probe, build_, pairs = _pack(PLAN_CASES[-2][1])
    runs.append(("shared-segments", probe, build_,
                 np.concatenate([pairs, pairs[::-1], pairs[:2]])))
    for name, probe, build_, pairs in runs:
        b = torch.from_numpy(build_).cuda()
        plan = ops.semijoin_plan(b, pairs)
        on_bitmap = int(plan.bitmap[plan.seg_of_pair].sum())
        if name in EXPECT_BITMAP:
            assert plan.bitmap[plan.seg_of_pair].tolist() == \
                EXPECT_BITMAP[name]
        for shift in (0, 1):
            a = torch.cat([torch.zeros(shift, dtype=torch.int32),
                           torch.from_numpy(probe)]).cuda()[shift:]
            before = ops.launches["semijoin_membership"]
            mask, counts = ops.semijoin_mask(a, b, pairs)
            torch.cuda.synchronize()
            launched = 1 if pairs[:, 1].sum() else 0
            assert ops.launches["semijoin_membership"] == before + launched
            want_mask, want_counts = ref.semijoin_pairs_ref(a, b, pairs)
            assert torch.equal(mask, want_mask), (name, shift)
            assert torch.equal(counts, want_counts), (name, shift)
            if launched:
                assert ops.semijoin_paths == {
                    "bitmap": on_bitmap, "search": len(pairs) - on_bitmap}
        words = ops.semijoin_bitmaps(b, plan)
        torch.cuda.synchronize()
        assert torch.equal(words, ref.semijoin_bitmaps_ref(b, plan)), name


@pytest.mark.cuda
def test_cuda_search_path_matches_plain(monkeypatch):
    """Every segment on the search path (both plan constants at 0): the
    kernel's lock-step binary search against the plain version, on the
    unit cases and a large ragged batch (``-m cuda`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    monkeypatch.setattr(ops, "SEMIJOIN_BITMAP_DENSITY", 0)
    monkeypatch.setattr(ops, "SEMIJOIN_BITMAP_MIN_WORDS", 0)
    rng = np.random.default_rng(11)
    big = [(rng.integers(0, 1 << 22, int(n)).astype(np.int32),
            np.unique(rng.integers(0, 1 << 22, int(m))).astype(np.int32))
           for n, m in zip(rng.integers(0, 200_000, 32),
                           rng.integers(1, 1_000_000, 32))]
    for name, batch in PLAN_CASES + [("large-batch", big)]:
        probe, build_, pairs = _pack(batch)
        a, b = torch.from_numpy(probe).cuda(), torch.from_numpy(build_).cuda()
        mask, counts = ops.semijoin_mask(a, b, pairs)
        torch.cuda.synchronize()
        want_mask, want_counts = ref.semijoin_pairs_ref(a, b, pairs)
        assert torch.equal(mask, want_mask), name
        assert torch.equal(counts, want_counts), name
        if pairs[:, 1].sum():
            assert ops.semijoin_paths == {"bitmap": 0, "search": len(pairs)}

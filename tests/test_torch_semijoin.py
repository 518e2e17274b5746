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


@pytest.mark.parametrize("name,batch", CASES, ids=[c[0] for c in CASES])
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


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against its plain version on the card, on every
    case above and on a large ragged batch (``-m cuda`` on the card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    rng = np.random.default_rng(9)
    big = [(rng.integers(0, 1 << 20, int(n)).astype(np.int32),
            np.unique(rng.integers(0, 1 << 20, int(m))).astype(np.int32))
           for n, m in zip(rng.integers(0, 200_000, 64),
                           rng.integers(0, 300_000, 64))]
    for name, batch in CASES + [("large-batch", big)]:
        probe, build_, pairs = _pack(batch)
        a, b = torch.from_numpy(probe).cuda(), torch.from_numpy(build_).cuda()
        before = ops.launches["semijoin_membership"]
        mask, counts = ops.semijoin_mask(a, b, pairs)
        torch.cuda.synchronize()
        launched = 1 if pairs[:, 1].sum() else 0
        assert ops.launches["semijoin_membership"] == before + launched
        want_mask, want_counts = ref.semijoin_pairs_ref(a, b, pairs)
        assert torch.equal(mask, want_mask), name
        assert torch.equal(counts, want_counts), name

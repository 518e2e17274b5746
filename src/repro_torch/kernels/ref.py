"""Plain PyTorch versions of the port's kernels.

These define the exact semantics the hand-written kernels must match:
the CPU path of every wrapper in :mod:`repro_torch.kernels.ops`, and the
yardstick each kernel is held against on the card.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

__all__ = ["join_probe_ref", "semijoin_membership_ref", "semijoin_pairs_ref",
           "semijoin_bitmaps_ref", "semijoin_pairs_bitmap_ref",
           "bucket_count_ref"]

#: the probe-side pad key: padded rows never count in a histogram
PROBE_PAD = 2**31 - 1


def join_probe_ref(probe: torch.Tensor, build_sorted: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(lo, cnt): lower-bound index and match count of each probe key in
    the ascending build column — the two arrays the sort-merge join
    expansion needs.  int32 in, int32 out, of the probe's shape.  A
    batch: a probe ``(B, n_a)`` against one build ``(n_b,)`` for every
    row, or against ``(B, n_b)``, each row ranked in its own build row."""
    lo = torch.searchsorted(build_sorted, probe, out_int32=True)
    hi = torch.searchsorted(build_sorted, probe, right=True, out_int32=True)
    return lo, hi - lo


def semijoin_membership_ref(probe: torch.Tensor, build_sorted: torch.Tensor
                            ) -> torch.Tensor:
    """mask[i] = probe[i] ∈ build_sorted (int32 0/1); ``build_sorted``
    ascending.  The pad sentinels (2^31-1 probe side, 2^31-2 build side)
    differ, so padded lanes never match."""
    lo = torch.searchsorted(build_sorted, probe, out_int32=True)
    hi = torch.searchsorted(build_sorted, probe, right=True, out_int32=True)
    return (hi > lo).to(torch.int32)


def semijoin_pairs_ref(probe: torch.Tensor, build_sorted: torch.Tensor,
                       pairs: np.ndarray) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched semi-join of ``ops.semijoin_mask``, one pair at a time:
    for row j = (probe_off, probe_len, build_off, build_len) of the int64
    (P, 4) ``pairs``, the mask of ``probe[probe_off:+probe_len]`` against
    ``build_sorted[build_off:+build_len]``.  Returns (mask uint8, the
    pairs' masks end to end in pair order; counts int64 (P,))."""
    masks, counts = [], []
    for p_off, p_len, b_off, b_len in np.asarray(pairs, dtype=np.int64):
        m = semijoin_membership_ref(probe[p_off:p_off + p_len],
                                    build_sorted[b_off:b_off + b_len])
        masks.append(m.to(torch.uint8))
        counts.append(m.sum(dtype=torch.int64))
    mask = torch.cat(masks) if masks else \
        torch.zeros(0, dtype=torch.uint8, device=probe.device)
    count = torch.stack(counts) if counts else \
        torch.zeros(0, dtype=torch.int64, device=probe.device)
    return mask, count


def semijoin_bitmaps_ref(build_sorted: torch.Tensor, plan) -> torch.Tensor:
    """The presence bitmaps of a semi-join plan (``ops.SemijoinPlan``):
    int32 (``plan.n_words``,); for each segment on the bitmap path, bit
    ``x & 31`` of word ``plan.word_off + (x >> 5)`` is set for each of its
    keys, ``x = key - plan.lo``, and every other bit is clear."""
    acc = torch.zeros(plan.n_words, dtype=torch.int64,
                      device=build_sorted.device)
    for s in np.nonzero(plan.bitmap)[0]:
        off, n = (int(v) for v in plan.segs[s])
        x = torch.unique(build_sorted[off:off + n].to(torch.int64)) - \
            int(plan.lo[s])
        # distinct keys set distinct bits, so a sum is their OR
        acc.index_add_(0, int(plan.word_off[s]) + (x >> 5),
                       torch.ones_like(x) << (x & 31))
    return torch.where(acc >= 2**31, acc - 2**32, acc).to(torch.int32)


def semijoin_pairs_bitmap_ref(probe: torch.Tensor, build_sorted: torch.Tensor,
                              pairs: np.ndarray, plan, words: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The batched semi-join of ``ops.semijoin_mask`` along its plan: a
    pair whose segment is on the bitmap path reads its key's bit in
    ``words`` (a key outside the bitmap's range is no member), any other
    pair searches its build segment.  The same (mask, counts) as
    :func:`semijoin_pairs_ref`."""
    pairs = np.asarray(pairs, dtype=np.int64).reshape(-1, 4)
    bits = words.to(torch.int64) & 0xFFFFFFFF
    masks, counts = [], []
    for j, (p_off, p_len, b_off, b_len) in enumerate(pairs):
        a = probe[p_off:p_off + p_len]
        s = int(plan.seg_of_pair[j])
        if plan.bitmap[s]:
            x = a.to(torch.int64) - int(plan.lo[s])
            inside = (x >= 0) & (x < 32 * int(plan.words[s]))
            xc = torch.where(inside, x, torch.zeros_like(x))
            w = bits[int(plan.word_off[s]) + (xc >> 5)]
            m = (inside & (((w >> (xc & 31)) & 1) == 1)).to(torch.int32)
        else:
            m = semijoin_membership_ref(a, build_sorted[b_off:b_off + b_len])
        masks.append(m.to(torch.uint8))
        counts.append(m.sum(dtype=torch.int64))
    mask = torch.cat(masks) if masks else \
        torch.zeros(0, dtype=torch.uint8, device=probe.device)
    count = torch.stack(counts) if counts else \
        torch.zeros(0, dtype=torch.int64, device=probe.device)
    return mask, count


def bucket_count_ref(keys: torch.Tensor, valid: torch.Tensor,
                     n_buckets: int) -> torch.Tensor:
    """int32 histogram of length ``n_buckets``: row i adds one to bucket
    ``uint32(keys[i]) mod n_buckets`` when ``valid[i]`` holds and its key
    is not the probe pad 2^31-1.  The modulo is taken on the key's 32
    bits read as unsigned, as the distributed shuffle routes rows, so a
    negative key (UNBOUND -1, A_NULL -3) lands where ``repartition``
    sends it.  A batch: ``keys`` and ``valid`` ``(B, n)`` give ``(B,
    n_buckets)``, row b the histogram of row b."""
    live = valid.to(torch.bool) & (keys != PROBE_PAD)
    dest = (keys.to(torch.int64) & 0xFFFFFFFF) % n_buckets
    if keys.dim() == 2:
        # row b's buckets are b * n_buckets + dest
        dest = dest + torch.arange(keys.shape[0], dtype=torch.int64,
                                   device=keys.device)[:, None] * n_buckets
    hist = torch.zeros(keys.shape[:-1].numel() * n_buckets,
                       dtype=torch.int64, device=keys.device)
    hist.index_add_(0, dest[live], torch.ones_like(dest[live]))
    return hist.to(torch.int32).reshape(keys.shape[:-1] + (n_buckets,))

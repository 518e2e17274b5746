"""Fixed-memory streaming latency histograms.

:class:`LogHistogram` backs ``ServerMetrics``' percentiles and the
Prometheus exposition: geometric (log-spaced) buckets with exact counts,
the same bucket edges as the reference package's, so percentiles and
bucket series agree between the two.

* **O(1) memory, O(1) record** — a fixed bucket array (``~110`` int
  slots spanning 1 µs … ~134 s) plus under/overflow slots; recording is
  one ``log2`` and one increment, with no truncation ever.
* **Bounded percentile error** — every sample lands in a bucket whose
  upper edge is at most ``GROWTH`` (2^0.25 ≈ 1.19×) above it, so any
  reported percentile is within +19% of the exact order statistic
  (asserted against exact samples in ``tests/test_torch_obs.py``).
* **Mergeable** — two histograms with the same bucket layout add
  bucket-wise, so per-engine / per-process metrics aggregate exactly.
* **Prometheus-ready** — :meth:`cumulative_buckets` is precisely the
  ``le``-labelled cumulative form the text exposition format wants.

All values are **milliseconds** (the unit every latency in this repo is
measured in).
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Optional, Tuple

__all__ = ["LogHistogram", "GROWTH", "LO_MS", "N_BUCKETS"]

#: geometric growth factor per bucket: 2^0.25 ≈ 1.189 — the relative
#: percentile error bound (a sample's bucket upper edge is < GROWTH× it)
GROWTH = 2.0 ** 0.25
#: lower edge of the first real bucket (1 µs); everything at or below
#: lands in the underflow slot and reports LO_MS
LO_MS = 1e-3
#: real buckets; LO_MS * GROWTH**N_BUCKETS ≈ 134 s, past any latency the
#: serving layer should ever see — beyond that is the overflow slot
N_BUCKETS = 108

_INV_LOG_STEP = 1.0 / (0.25 * math.log(2.0))
_LOG_LO = math.log(LO_MS)


def _bucket_index(ms: float) -> int:
    """Slot for ``ms``: 0 = underflow, 1..N_BUCKETS = real buckets,
    N_BUCKETS + 1 = overflow."""
    if ms <= LO_MS:
        return 0
    i = int(math.floor((math.log(ms) - _LOG_LO) * _INV_LOG_STEP)) + 1
    return min(i, N_BUCKETS + 1)


def _upper_edge(index: int) -> float:
    """Upper edge of slot ``index`` (underflow reports LO_MS; overflow
    has no finite edge and reports +inf)."""
    if index <= 0:
        return LO_MS
    if index > N_BUCKETS:
        return math.inf
    return LO_MS * GROWTH ** index


class LogHistogram:
    """Log-bucketed histogram of millisecond latencies.

    Exact counts in geometric buckets; percentiles are the upper edge of
    the bucket holding the requested order statistic, clamped to the
    exact observed max (so a lone sample reports itself, not its bucket
    ceiling).
    """

    __slots__ = ("_counts", "count", "sum_ms", "min_ms", "max_ms")

    def __init__(self) -> None:
        self._counts: List[int] = [0] * (N_BUCKETS + 2)
        self.count = 0
        self.sum_ms = 0.0
        self.min_ms: Optional[float] = None
        self.max_ms: Optional[float] = None

    def record(self, ms: float, count: int = 1) -> None:
        """Add ``count`` observations of ``ms`` — O(1) regardless of
        ``count`` (one bucket increment), unlike the sample lists this
        replaces which materialized ``[ms] * count``."""
        if count <= 0:
            return
        ms = float(ms)
        self._counts[_bucket_index(ms)] += count
        self.count += count
        self.sum_ms += ms * count
        if self.min_ms is None or ms < self.min_ms:
            self.min_ms = ms
        if self.max_ms is None or ms > self.max_ms:
            self.max_ms = ms

    # -- queries ---------------------------------------------------------------
    @property
    def mean_ms(self) -> Optional[float]:
        return (self.sum_ms / self.count) if self.count else None

    def percentile(self, q: float) -> Optional[float]:
        """The ``q``-th percentile (0..100) as the holding bucket's upper
        edge, or ``None`` when the histogram is empty — an idle server
        must never fabricate a 0.0 latency."""
        if self.count == 0:
            return None
        if not 0.0 <= q <= 100.0:
            raise ValueError(f"percentile q must be in [0, 100], got {q}")
        # rank of the order statistic (1-based, ceil — the classic
        # nearest-rank definition, exact for bucket counts)
        rank = max(1, math.ceil(q / 100.0 * self.count))
        seen = 0
        for i, c in enumerate(self._counts):
            seen += c
            if seen >= rank:
                edge = _upper_edge(i)
                hi = self.max_ms if self.max_ms is not None else edge
                lo = self.min_ms if self.min_ms is not None else edge
                return min(max(edge, lo), hi)
        return self.max_ms  # unreachable; counts sum to self.count

    def merge(self, other: "LogHistogram") -> "LogHistogram":
        """Add ``other``'s counts into this histogram (exact — both use
        the module-wide bucket layout); returns ``self``."""
        for i, c in enumerate(other._counts):
            self._counts[i] += c
        self.count += other.count
        self.sum_ms += other.sum_ms
        for theirs in (other.min_ms,):
            if theirs is not None and \
                    (self.min_ms is None or theirs < self.min_ms):
                self.min_ms = theirs
        for theirs in (other.max_ms,):
            if theirs is not None and \
                    (self.max_ms is None or theirs > self.max_ms):
                self.max_ms = theirs
        return self

    def cumulative_buckets(self) -> Iterator[Tuple[float, int]]:
        """``(upper_edge_ms, cumulative_count)`` pairs for every
        *occupied prefix* of the bucket array — the Prometheus
        ``le``-label series.  Empty trailing buckets are skipped (the
        ``+Inf`` bucket, always emitted by the renderer, carries the
        total)."""
        cum = 0
        remaining = self.count
        for i, c in enumerate(self._counts):
            if remaining == 0:
                return
            cum += c
            remaining -= c
            if c:
                yield _upper_edge(i), cum

    def __len__(self) -> int:
        return self.count

    def __repr__(self) -> str:
        return (f"LogHistogram(count={self.count}, "
                f"p50={self.percentile(50)}, p99={self.percentile(99)})")

"""Self-tuning micro-batch shape menu.

A backend whose batch is one launch pads each bucket of same-template
requests up to a static batch shape, so the number of launch shapes
per template stays bounded.  A bigger launch is not automatically a
better launch (capacity growth, padding, cache pressure); which sizes
win is a property of the machine and workload, so the menu is measured,
not assumed.

``BatchTuner`` owns the menu.  Every vectorized launch reports
``(shape, live_requests, wall_ms)``; the tuner keeps per-bucket EWMAs of

* **per-slot time** — ``wall_ms / shape``, the marginal cost of a batch
  slot.  If a larger bucket's per-slot time exceeds a smaller active
  bucket's by ``tuner_margin``, the larger bucket is **retired**: padding
  *up* to it was strictly worse than launching the smaller shape more
  often.  This is how the batch-32 regression is discovered at runtime
  rather than hard-coded away.
* **occupancy / padding waste** — live slots per launch, reported so an
  operator can see which shapes their traffic actually fills.

The first ``tuner_discard`` launches per shape are excluded from the
estimates (they carry compile and first-touch time), and retirement needs
``tuner_min_samples`` counted launches on both buckets — one noisy
launch never reshapes the menu.  The smallest shape is never retired.
All decisions are deterministic given the observation stream.  A copy
of the reference package's module.

Only a batch that is one launch sequence is observed: the torch and
distributed backends' (``PreparedQuery.vectorized_batch``).  The eager
seat runs a batch's bindings in turn, so the engine neither pads nor
observes its batches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from repro_torch.runtime.config import RuntimeConfig

__all__ = ["BatchTuner"]


@dataclass
class _BucketStat:
    launches: int = 0            # counted launches (post-discard)
    discarded: int = 0           # compile-heavy launches excluded
    per_slot_ms: Optional[float] = None
    occupancy: Optional[float] = None
    live_requests: int = 0
    padded_slots: int = 0


class BatchTuner:
    """Adapt a static batch-shape menu from observed launch latencies."""

    def __init__(self, shapes: Tuple[int, ...], config: RuntimeConfig):
        shapes = tuple(sorted(set(int(s) for s in shapes)))
        if not shapes or shapes[0] < 1:
            raise ValueError("batch shapes must be positive ints")
        self.config = config
        self.shapes: Tuple[int, ...] = shapes
        self._retired: Dict[int, str] = {}
        self._stats: Dict[int, _BucketStat] = {s: _BucketStat()
                                               for s in shapes}

    # -- menu ------------------------------------------------------------------
    def active_shapes(self) -> Tuple[int, ...]:
        return tuple(s for s in self.shapes if s not in self._retired)

    def max_shape(self) -> int:
        return self.active_shapes()[-1]

    def bucket_for(self, n: int) -> int:
        """Smallest active shape holding ``n`` requests (callers chunk
        anything larger than the biggest active shape)."""
        for s in self.active_shapes():
            if s >= n:
                return s
        return self.max_shape()

    # -- observations ----------------------------------------------------------
    def observe(self, shape: int, live: int, wall_ms: float) -> None:
        """One vectorized launch of ``shape`` slots, ``live`` of them
        real requests, measured at ``wall_ms``."""
        st = self._stats.get(shape)
        if st is None:
            st = self._stats[shape] = _BucketStat()
        st.live_requests += live
        st.padded_slots += shape - live
        if st.discarded < self.config.tuner_discard:
            st.discarded += 1       # trace/compile launch; not evidence
            return
        st.launches += 1
        alpha = self.config.tuner_alpha
        per_slot = wall_ms / shape
        occ = live / shape
        st.per_slot_ms = per_slot if st.per_slot_ms is None else \
            (1.0 - alpha) * st.per_slot_ms + alpha * per_slot
        st.occupancy = occ if st.occupancy is None else \
            (1.0 - alpha) * st.occupancy + alpha * occ
        self._maybe_retire()

    def _maybe_retire(self) -> None:
        """Retire any bucket whose per-slot time is beaten by a smaller
        active bucket beyond the margin (both sufficiently sampled)."""
        need = self.config.tuner_min_samples
        margin = self.config.tuner_margin
        active = self.active_shapes()
        for i in range(len(active) - 1, 0, -1):     # never the smallest
            big = active[i]
            bs = self._stats[big]
            if bs.launches < need or bs.per_slot_ms is None:
                continue
            for small in active[:i]:
                ss = self._stats[small]
                if ss.launches < need or ss.per_slot_ms is None:
                    continue
                if bs.per_slot_ms > margin * ss.per_slot_ms:
                    self._retired[big] = (
                        f"per-slot {bs.per_slot_ms:.4f} ms > "
                        f"{margin:.2f}x bucket-{small} "
                        f"({ss.per_slot_ms:.4f} ms)")
                    break

    # -- observability ---------------------------------------------------------
    def report(self) -> Dict[str, object]:
        buckets = {}
        for s in sorted(self._stats):
            st = self._stats[s]
            slots = st.live_requests + st.padded_slots
            buckets[str(s)] = {
                "launches": st.launches,
                "per_slot_ms": None if st.per_slot_ms is None
                else round(st.per_slot_ms, 4),
                "occupancy": None if st.occupancy is None
                else round(st.occupancy, 4),
                "padding_waste": (st.padded_slots / slots) if slots else 0.0,
                "retired": self._retired.get(s),
            }
        return {"menu": list(self.shapes),
                "active": list(self.active_shapes()),
                "retired": {str(s): why for s, why in self._retired.items()},
                "buckets": buckets}

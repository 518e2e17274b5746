"""Statistics catalog (paper §6: "S2RDF collects statistics about all
tables in ExtVP during the initial creation process, most notably the
selectivities (SF values) and actual sizes, such that these statistics can
be used for query generation. It also stores statistics about empty tables
... as this empowers the query compiler to know that a query has no results
without actually running it.").

``Catalog`` is the single source of truth the compiler reads:
  * VP tables per predicate (+ the base triples table for unbound
    predicates),
  * materialized ExtVP tables keyed (kind, p1, p2),
  * SF + size statistics for every pair (materialized or not).

It is deliberately host-side: S2RDF's Spark driver also keeps statistics on
the driver and only ships table scans to executors.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Dict, Mapping, Optional, Tuple

import numpy as np

from repro_torch.core.table import Table
from repro_torch.core.vp import ExtVPBuild, build_extvp, build_vp, KINDS

__all__ = ["Catalog", "build_catalog", "compute_distinct_counts",
           "compute_second_moments"]

Key = Tuple[str, int, int]

#: the shared SF=0 fallback relation — ``Catalog.table()`` hands this
#: singleton out instead of allocating a fresh empty Table per call
_EMPTY_TABLE = Table(np.empty((0, 2), dtype=np.int32))


@dataclass
class Catalog:
    tt: np.ndarray                      # int32[N, 3]
    vp: Mapping[int, Table]
    extvp: ExtVPBuild
    dictionary: object = None           # Optional[repro_torch.rdf.Dictionary]
    vp_build_seconds: float = 0.0
    with_extvp: bool = True             # False: VP-only store (no pair stats)
    #: per-predicate distinct-subject / distinct-object counts and second
    #: moments (Σ per-value-count²) over the VP tables — the statistics
    #: of the cardinality-estimate planner, carried so a catalog holds
    #: everything the reference's does
    distinct_s: Optional[Dict[int, int]] = None
    distinct_o: Optional[Dict[int, int]] = None
    m2_s: Optional[Dict[int, int]] = None
    m2_o: Optional[Dict[int, int]] = None

    # ---- statistics API (what Algorithms 1 & 4 consume) --------------------
    def sf(self, kind: str, p1: int, p2: int) -> float:
        """SF of ExtVP^kind_{p1|p2}; 1.0 if unknown (≡ no reduction info)."""
        if p1 not in self.vp:
            return 0.0  # predicate absent from the data: empty result
        return self.extvp.sf.get((kind, p1, p2), 1.0)

    def size(self, kind: str, p1: int, p2: int) -> int:
        if p1 not in self.vp:
            return 0
        key = (kind, p1, p2)
        if key in self.extvp.sizes:
            return self.extvp.sizes[key]
        return len(self.vp[p1])

    def vp_size(self, p: int) -> int:
        return len(self.vp[p]) if p in self.vp else 0

    def materialized(self, kind: str, p1: int, p2: int) -> bool:
        """True when ExtVP^kind_{p1|p2} exists in the materialized (SF ≤ τ)
        set.  Table selection (Algorithm 1) must not credit a reduction
        that was pruned by the threshold: ``table()`` would fall back to
        the full VP relation while the plan's ordering and size
        statistics assume the reduced one."""
        return (kind, p1, p2) in self.extvp.tables

    # ---- table access -------------------------------------------------------
    def table(self, kind: Optional[str], p1: int, p2: Optional[int] = None) -> Optional[Table]:
        """Fetch a materialized table; VP when kind is None; None if absent.

        Falls back to the VP table when the ExtVP table was not materialized
        (SF=1, above threshold) — mirroring "S2RDF makes use of it, if they
        exist, or uses the normal VP tables instead" (§5.2).
        """
        if p1 not in self.vp:
            return None
        if kind is None:
            return self.vp[p1]
        t = self.extvp.tables.get((kind, p1, p2))
        if t is not None:
            return t
        sf = self.extvp.sf.get((kind, p1, p2), 1.0)
        if sf == 0.0:
            return _EMPTY_TABLE
        return self.vp[p1]

    @property
    def n_triples(self) -> int:
        return len(self.tt)

    # ---- storage accounting (paper Table 2) ---------------------------------
    def storage_report(self) -> Dict[str, float]:
        vp_tuples = sum(len(t) for t in self.vp.values())
        ext_tuples = self.extvp.total_tuples()
        return {
            "n_triples": float(len(self.tt)),
            "vp_tables": float(len(self.vp)),
            "vp_tuples": float(vp_tuples),
            "extvp_tables": float(len(self.extvp.tables)),
            "extvp_tuples": float(ext_tuples),
            "extvp_over_vp": float(ext_tuples) / max(vp_tuples, 1),
            "extvp_empty": float(sum(1 for v in self.extvp.sf.values() if v == 0.0)),
            "extvp_identity": float(sum(1 for v in self.extvp.sf.values() if v == 1.0)),
            "vp_build_seconds": self.vp_build_seconds,
            "extvp_build_seconds": self.extvp.build_seconds,
            "n_semijoins": float(self.extvp.n_semijoins),
        }


def compute_distinct_counts(
    vp: Mapping[int, Table],
) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Per-predicate distinct-subject / distinct-object counts over a VP
    catalog (the tables' cached ``unique_s`` / ``unique_o`` views)."""
    distinct_s = {int(p): int(len(t.unique_s)) for p, t in vp.items()}
    distinct_o = {int(p): int(len(t.unique_o)) for p, t in vp.items()}
    return distinct_s, distinct_o


def _m2(col: np.ndarray) -> int:
    counts = np.unique(np.asarray(col), return_counts=True)[1]
    return int((counts.astype(np.int64) ** 2).sum())


def compute_second_moments(
    vp: Mapping[int, Table],
) -> Tuple[Dict[int, int], Dict[int, int]]:
    """Per-predicate Σcount² over each VP column (the self-join sizes)."""
    m2_s = {int(p): _m2(t.rows[:, 0]) for p, t in vp.items()}
    m2_o = {int(p): _m2(t.rows[:, 1]) for p, t in vp.items()}
    return m2_s, m2_o


def build_catalog(
    tt: np.ndarray,
    dictionary=None,
    threshold: float = 1.0,
    kinds: Tuple[str, ...] = KINDS,
    with_extvp: bool = True,
) -> Catalog:
    """End-to-end load: TT -> VP -> ExtVP(τ) + stats (host build)."""
    t0 = time.perf_counter()
    vp = build_vp(tt)
    distinct_s, distinct_o = compute_distinct_counts(vp)
    m2_s, m2_o = compute_second_moments(vp)
    vp_secs = time.perf_counter() - t0
    if with_extvp:
        ext = build_extvp(vp, threshold=threshold, kinds=kinds)
    else:
        ext = ExtVPBuild(threshold=threshold, kinds=tuple(kinds))
    return Catalog(tt=np.asarray(tt, dtype=np.int32), vp=vp, extvp=ext,
                   dictionary=dictionary, vp_build_seconds=vp_secs,
                   with_extvp=with_extvp,
                   distinct_s=distinct_s, distinct_o=distinct_o,
                   m2_s=m2_s, m2_o=m2_o)

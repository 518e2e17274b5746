"""VP and ExtVP builders (paper §4.2, §5).

``build_vp``    — vertical partitioning: one (s, o) table per predicate.
``build_extvp`` — Extended Vertical Partitioning: for every ordered
predicate pair and correlation kind ∈ {SS, OS, SO}, the semi-join
reduction

    ExtVP^SS_{p1|p2} = VP_p1 ⋉_{s=s} VP_p2      (p1 ≠ p2)
    ExtVP^OS_{p1|p2} = VP_p1 ⋉_{o=s} VP_p2
    ExtVP^SO_{p1|p2} = VP_p1 ⋉_{s=o} VP_p2

OO correlations are not precomputed (paper §5.2: they are dominated by
same-predicate self-joins where the reduction is the identity).

A table is *materialized* only when it is a strict, non-empty reduction
whose selectivity factor ``SF = |ExtVP| / |VP_p1|`` is within the optional
threshold τ (§5.3).  Statistics (SF, sizes) are recorded for **all** pairs
— including empty (SF=0) and identity (SF=1) ones — because the query
compiler uses them for table selection, join ordering, and the
statistics-only ∅ short-circuit (ST-8).

The builder is the offline analogue of S2RDF's Spark load job.  This
module carries the ``"numpy"`` host build only (sorted-array membership
via ``np.searchsorted``, one semi-join per pair); the device build over
the semi-join kernel is not ported yet.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Dict, Tuple

import numpy as np

from repro_torch.core.table import Table

__all__ = ["build_vp", "build_extvp", "ExtVPBuild", "SS", "OS", "SO", "KINDS"]

SS, OS, SO = "SS", "OS", "SO"
KINDS = (SS, OS, SO)

Key = Tuple[str, int, int]  # (kind, p1, p2)


@dataclass
class ExtVPBuild:
    """Result of an ExtVP construction pass."""

    tables: Dict[Key, Table] = field(default_factory=dict)   # materialized only
    sf: Dict[Key, float] = field(default_factory=dict)       # stats for ALL pairs
    sizes: Dict[Key, int] = field(default_factory=dict)
    threshold: float = 1.0
    build_seconds: float = 0.0
    n_semijoins: int = 0
    kinds: Tuple[str, ...] = KINDS

    def n_tables(self, lo: float = 0.0, hi: float = 1.0) -> int:
        """Pairs whose SF falls in the materialization band (lo, hi]:
        the upper bound is inclusive (SF == τ materializes) and identity
        tables (SF = 1) never count."""
        return sum(1 for v in self.sf.values() if lo < v <= hi and v < 1.0)

    def total_tuples(self) -> int:
        return sum(len(t) for t in self.tables.values())


def build_vp(tt: np.ndarray) -> Dict[int, Table]:
    """Vertical partitioning of a triples table int32[N, 3] -> {pid: Table}."""
    tt = np.asarray(tt)
    order = np.argsort(tt[:, 1], kind="stable")
    sorted_tt = tt[order]
    pids, starts = np.unique(sorted_tt[:, 1], return_index=True)
    bounds = np.append(starts, len(sorted_tt))
    vp: Dict[int, Table] = {}
    for i, pid in enumerate(pids):
        chunk = sorted_tt[bounds[i]:bounds[i + 1]]
        vp[int(pid)] = Table.from_unsorted(chunk[:, [0, 2]])
    return vp


def _semijoin_mask(keys: np.ndarray, other_sorted_unique: np.ndarray) -> np.ndarray:
    """mask[i] = keys[i] ∈ other (other must be sorted unique)."""
    if len(other_sorted_unique) == 0:
        return np.zeros(len(keys), dtype=bool)
    idx = np.searchsorted(other_sorted_unique, keys)
    idx = np.minimum(idx, len(other_sorted_unique) - 1)
    return other_sorted_unique[idx] == keys


def _ranges_disjoint(a: np.ndarray, b: np.ndarray) -> bool:
    if len(a) == 0 or len(b) == 0:
        return True
    return a[-1] < b[0] or b[-1] < a[0]


def build_extvp(
    vp: Dict[int, Table],
    threshold: float = 1.0,
    kinds: Tuple[str, ...] = KINDS,
) -> ExtVPBuild:
    """Compute the ExtVP schema over a VP catalog.

    ``threshold`` is the SF threshold τ of §5.3: tables with SF > τ are not
    materialized (their statistics still are).  τ=1.0 reproduces the
    unthresholded schema (SF=1 identity tables are never stored, exactly
    as in the paper — "red tables" of Fig. 10).  The build runs on the
    host.
    """
    t0 = time.perf_counter()
    from repro_torch.core.extvp_build import build_extvp_planned
    out = build_extvp_planned(vp, threshold=threshold, kinds=kinds)
    out.build_seconds = time.perf_counter() - t0
    return out

"""Planned ExtVP construction (the paper's §5 load job): plan the pairs,
semi-join the ones that can match, materialize the reductions.

Host path only.  Pair planning applies the disjoint-entity-range
short-circuit (a pair whose probe-side and build-side entity ranges do
not overlap is structurally empty and never reaches a semi-join), and
:func:`evaluate_pairs` semi-joins the rest one pair at a time with
sorted-array membership.  The pair-batched device build over the
semi-join kernel is a later slice of the port.
"""

from __future__ import annotations

from typing import Dict, Iterable, Iterator, List, Sequence, Tuple

from repro_torch.core.table import Table
from repro_torch.core.vp import (
    ExtVPBuild, KINDS, OS, SO, SS, _ranges_disjoint, _semijoin_mask,
)

__all__ = ["all_pair_keys", "plan_pairs", "evaluate_pairs",
           "build_extvp_planned"]

Key = Tuple[str, int, int]


def all_pair_keys(preds: Sequence[int],
                  kinds: Sequence[str] = KINDS) -> Iterator[Key]:
    """Every (kind, p1, p2) the schema defines, in the build's order
    (SS self-pairs are identity by definition and excluded, §5.2)."""
    for p1 in preds:
        for p2 in preds:
            for kind in kinds:
                if kind == SS and p1 == p2:
                    continue
                yield (kind, p1, p2)


def plan_pairs(vp: Dict[int, Table],
               keys_iter: Iterable[Key]) -> Tuple[List[Key], List[Key]]:
    """Split pairs into (pruned, evals): a pair whose probe-side and
    build-side entity ranges are disjoint is structurally empty (SF = 0)
    and never reaches a semi-join."""
    pruned: List[Key] = []
    evals: List[Key] = []
    for key in keys_iter:
        kind, p1, p2 = key
        t1, t2 = vp[p1], vp[p2]
        own = t1.unique_o if kind == OS else t1.unique_s
        other = t2.unique_o if kind == SO else t2.unique_s
        (pruned if _ranges_disjoint(own, other) else evals).append(key)
    return pruned, evals


def evaluate_pairs(vp: Dict[int, Table], evals: Sequence[Key],
                   threshold: float,
                   ) -> Tuple[Dict[Key, float], Dict[Key, int],
                              Dict[Key, Table]]:
    """Semi-join every pair in ``evals``; returns (sf, sizes, tables)."""
    sf: Dict[Key, float] = {}
    sizes: Dict[Key, int] = {}
    tables: Dict[Key, Table] = {}
    for key in evals:
        kind, p1, p2 = key
        t1, t2 = vp[p1], vp[p2]
        probe = t1.o if kind == OS else t1.s
        other = t2.unique_o if kind == SO else t2.unique_s
        mask = _semijoin_mask(probe, other)
        m = int(mask.sum())
        n1 = len(t1)
        sfv = m / n1 if n1 else 0.0
        sf[key] = sfv
        sizes[key] = m
        if 0 < sfv < 1.0 and sfv <= threshold:
            tables[key] = Table(t1.rows[mask])   # mask keeps s-order
    return sf, sizes, tables


def build_extvp_planned(vp: Dict[int, Table], threshold: float = 1.0,
                        kinds: Tuple[str, ...] = KINDS) -> ExtVPBuild:
    """Full ExtVP schema via the planned pipeline (prune -> evaluate ->
    materialize)."""
    out = ExtVPBuild(threshold=threshold, kinds=tuple(kinds))
    pruned, evals = plan_pairs(vp, all_pair_keys(sorted(vp), kinds))
    for key in pruned:
        out.sf[key] = 0.0
        out.sizes[key] = 0
    sf, sizes, tables = evaluate_pairs(vp, evals, threshold)
    out.sf.update(sf)
    out.sizes.update(sizes)
    out.tables.update(tables)
    out.n_semijoins = len(evals)
    return out

"""Property-table (Sempala-style) baseline layout (paper §4.3, §3.2).

Sempala answers star sub-patterns from a unified property table without
joins and decomposes complex queries into *disjoint triple groups*
(star-shaped sub-patterns) that are then joined.  We emulate exactly that
plan shape on the VP substrate:

* patterns are grouped by subject term (the star pivots);
* within a group, the subject set is first intersected across all member
  predicates (≡ the property-table row lookup: one "row scan" instead of
  joins — no ExtVP reduction is available to shrink inputs);
* groups are joined pairwise like Sempala joins its triple groups.

This reproduces the baseline's characteristic profile: stars are cheap
(pre-intersection ≈ the PT row filter), but inputs are full VP tables and
linear chains degenerate to plain joins — the behaviour Table 4 of the
paper shows for Sempala.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from repro_torch.core.algebra import BGP, TriplePattern, is_var
from repro_torch.core.compiler import MISSING_TERM
from repro_torch.core.executor import Bindings, natural_join, scan_step
from repro_torch.core.compiler import ScanStep
from repro_torch.core.stats import Catalog


def _star_groups(patterns: List[TriplePattern]) -> List[List[TriplePattern]]:
    groups: Dict[object, List[TriplePattern]] = {}
    for tp in patterns:
        groups.setdefault(tp.s, []).append(tp)
    return list(groups.values())


def _subject_intersection(group: List[TriplePattern],
                          catalog: Catalog) -> np.ndarray:
    """Common subjects over the group's predicates (the PT row filter)."""
    subjects = None
    for tp in group:
        if is_var(tp.p):
            continue
        t = catalog.table(None, int(tp.p))
        if t is None:
            return np.empty(0, dtype=np.int32)
        s = t.unique_s
        if not is_var(tp.o):
            s = np.unique(t.rows[t.rows[:, 1] == int(tp.o), 0])
        subjects = s if subjects is None else \
            np.intersect1d(subjects, s, assume_unique=True)
        if subjects is not None and len(subjects) == 0:
            break
    return subjects if subjects is not None else np.empty(0, np.int32)


def execute_pt_bgp(bgp: BGP, catalog: Catalog) -> Bindings:
    patterns = list(bgp.patterns)
    if not patterns:
        return Bindings.unit()
    for tp in patterns:
        if any((not is_var(t)) and int(t) == MISSING_TERM
               for t in (tp.s, tp.p, tp.o)):
            return Bindings.empty(bgp.vars())

    group_results: List[Bindings] = []
    for group in _star_groups(patterns):
        subjects = None
        if len(group) > 1 and not any(is_var(tp.p) for tp in group):
            subjects = _subject_intersection(group, catalog)
        acc = None
        for tp in group:
            step = ScanStep(tp, None, None, 1.0,
                            catalog.vp_size(int(tp.p)) if not is_var(tp.p)
                            else catalog.n_triples,
                            uses_tt=is_var(tp.p))
            b = scan_step(step, catalog)
            if subjects is not None and is_var(tp.s):
                mask = np.isin(b.col(tp.s), subjects)
                b = Bindings(b.cols, b.data[mask])
            acc = b if acc is None else natural_join(acc, b)
        group_results.append(acc)

    # Sempala: join the disjoint triple groups
    out = group_results[0]
    for g in group_results[1:]:
        out = natural_join(out, g)
    return out

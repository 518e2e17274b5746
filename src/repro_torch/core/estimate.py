"""Cardinality estimation + bounded join-order enumeration.

The paper's Algorithm 4 orders joins by (#bound values, selected-table
size) — raw table size is a poor proxy for *intermediate* cardinality, so
a locally-small ExtVP table can still explode mid-pipeline on snowflake
and complex shapes.  This module is the ``planner="estimate"`` alternative
(PRoST, arXiv 1802.05898, makes the same statistics-driven argument):

* **per-scan estimate** — SF × table size is already folded into
  ``ScanStep.size`` (Algorithm 1 selected the smallest ExtVP variant);
  bound subject/object terms multiply it by the column's second-moment
  selectivity m2/|VP|² (``Catalog.second_moment`` — the expected match
  fraction for a constant drawn from the data distribution, robust to
  value skew like ``rdf:type``), falling back to the uniform
  1/distinct-count divisor (``Catalog.distinct``) when the skew
  statistics are absent;
* **per-join selectivity** — the System-R rule: joining relations R and T
  on shared variable v multiplies |R|·|T| by 1/max(d_R(v), d_T(v)), where
  per-variable distinct-value counts d(·) seed from the scan statistics
  and propagate through the pipeline (capped by the running cardinality);
  disconnected steps contribute the full cross product — never an
  undercount.  (A second-moment *floor* on join selectivity was tried
  and rejected: it perturbs orders enough to lose the lucky-zero
  intermediates greedy stumbles into on correlated WatDiv shapes —
  fan-out chains like C2 remain the known weak spot of the uniform
  join model.);
* **bounded enumeration** — exact dynamic programming over pattern
  subsets (left-deep join trees) up to ``DP_LIMIT`` patterns, greedy
  selection with cardinality propagation beyond it.  Like Algorithm 4,
  cross joins are admitted only when no remaining pattern is
  join-connected, so enumerated orders stay inside the fragment every
  backend (eager / torch / distributed) already executes.

Estimation is *template-level*: placeholder constants count as bound
terms but their values never enter a formula, so the order chosen at
compile time is valid for every re-binding and is cached with the
``PreparedQuery`` — re-binding never re-enumerates.

Catalogs without distinct-count statistics (version-1 stores) make
``order_steps`` return ``None`` and the compiler falls back to the
Algorithm-4 greedy order.

A copy of the reference package's module: the same formulas and
tiebreaks give the same orders on the same catalog.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.algebra import is_var, tp_vars

__all__ = ["DP_LIMIT", "StepEstimate", "supports", "scan_estimate",
           "estimate_order", "order_steps", "actual_cardinalities"]

#: exact-DP bound: 2^8 subset states; beyond this the enumerator switches
#: to greedy selection with cardinality propagation
DP_LIMIT = 8


@dataclass
class StepEstimate:
    """One pipeline position: the scan's own estimate and the estimated
    cardinality of the intermediate result after joining it in."""

    step: object                 # compiler.ScanStep
    scan_rows: float             # estimated scan output (SF × size × terms)
    rows: float                  # running pipeline cardinality


def supports(catalog) -> bool:
    """True when ``catalog`` carries the distinct-count statistics the
    estimator needs (false for catalogs loaded from version-1 stores)."""
    return bool(getattr(catalog, "has_distinct_stats", False))


def scan_estimate(step, catalog) -> Tuple[float, Dict[str, float]]:
    """Estimated output rows of one scan plus per-variable distinct-value
    estimates ``{var: d}`` for the variables it binds.

    The step's ``size`` is already SF × |VP| (Algorithm 1 picked the
    smallest ExtVP variant); bound subject/object terms multiply by the
    column's second-moment selectivity m2/|VP|² when the skew statistics
    are present (E[matches] for a data-distributed constant — immune to
    the uniformity trap on skewed columns like ``rdf:type``), else
    divide by the distinct count.  TT scans (unbound predicates) have no
    per-predicate statistics — their per-column distincts default to the
    table size, which makes joins through them conservatively weak.
    """
    tp = step.tp
    size = float(max(step.size, 0))
    if step.uses_tt and not is_var(tp.p):
        # layout="tt" forces a TT scan for a bound predicate; the scan
        # still only matches that predicate's rows
        size = float(catalog.vp_size(int(tp.p)))
    dist = None if (step.uses_tt or is_var(tp.p)) \
        else catalog.distinct(int(tp.p))
    ds, do = (float(dist[0]), float(dist[1])) if dist else (size, size)
    ds, do = max(ds, 1.0), max(do, 1.0)
    m2 = None if dist is None else catalog.second_moment(int(tp.p))
    vp_n = float(catalog.vp_size(int(tp.p))) if dist is not None else 0.0
    sel_s = m2[0] / vp_n ** 2 if m2 and vp_n else 1.0 / ds
    sel_o = m2[1] / vp_n ** 2 if m2 and vp_n else 1.0 / do

    rows = size
    s_var, o_var = is_var(tp.s), is_var(tp.o)
    if not s_var:
        rows *= sel_s
    if not o_var:
        rows *= sel_o
    if s_var and o_var and tp.s == tp.o:
        # ?x p ?x: the diagonal of the table
        rows /= max(ds, do)
    rows = max(rows, 0.0)

    dvar: Dict[str, float] = {}
    if s_var:
        dvar[tp.s] = max(min(ds, rows), 1.0)
    if o_var:
        dvar[tp.o] = min(max(min(do, rows), 1.0),
                         dvar.get(tp.o, float("inf")))
    if is_var(tp.p):
        # distinct predicates in the dataset (len() never loads a lazy map)
        dvar[tp.p] = max(min(float(len(catalog.vp)), rows), 1.0)
    return rows, dvar


def _join_in(rows: float, dvar: Dict[str, float],
             t_rows: float, t_dvar: Dict[str, float]
             ) -> Tuple[float, Dict[str, float]]:
    """Fold one scan into the running relation: System-R join selectivity
    per shared variable, cross product when none are shared."""
    shared = set(dvar) & set(t_dvar)
    out = rows * t_rows
    for v in shared:
        out /= max(dvar[v], t_dvar[v], 1.0)
    new_d: Dict[str, float] = {}
    for v in set(dvar) | set(t_dvar):
        d = min(dvar.get(v, float("inf")), t_dvar.get(v, float("inf")))
        new_d[v] = max(min(d, out), 0.0) if out > 0 else 0.0
    return out, new_d


def estimate_order(steps: Sequence, catalog) -> Optional[List[StepEstimate]]:
    """Propagate estimates through ``steps`` in the given order; ``None``
    when the catalog lacks distinct-count statistics."""
    if not supports(catalog):
        return None
    out: List[StepEstimate] = []
    rows, dvar = 0.0, {}
    for i, step in enumerate(steps):
        t_rows, t_dvar = scan_estimate(step, catalog)
        if i == 0:
            rows, dvar = t_rows, t_dvar
        else:
            rows, dvar = _join_in(rows, dvar, t_rows, t_dvar)
        out.append(StepEstimate(step=step, scan_rows=t_rows, rows=rows))
    return out


def _greedy_order(idx: List[int], scans, var_sets, tiebreak) -> List[int]:
    """Greedy selection with cardinality propagation (n > DP_LIMIT):
    start from the most selective scan, then repeatedly append the
    join-connected step minimizing the propagated cardinality."""
    first = min(idx, key=lambda i: (scans[i][0],) + tiebreak(i))
    order = [first]
    rows, dvar = scans[first]
    remaining = [i for i in idx if i != first]
    while remaining:
        connected = [i for i in remaining if var_sets[i] & set(dvar)]
        pool = connected or remaining        # cross joins only if forced
        best, best_state = None, None
        for i in pool:
            out, nd = _join_in(rows, dvar, *scans[i])
            key = (out,) + tiebreak(i)
            if best is None or key < best:
                best, best_state, pick = key, (out, nd), i
        order.append(pick)
        rows, dvar = best_state
        remaining.remove(pick)
    return order


def order_steps(steps: Sequence, catalog,
                dp_limit: int = DP_LIMIT) -> Optional[List]:
    """Enumerate a join order for ``steps`` minimizing the summed
    estimated intermediate cardinalities (the C_out cost).

    Exact subset DP over left-deep trees for ``len(steps) <= dp_limit``,
    greedy-with-propagation beyond.  Returns the reordered step list (a
    permutation of the input — table selection is untouched), or ``None``
    when the catalog has no distinct-count statistics (the caller then
    keeps the Algorithm-4 greedy order).
    """
    if not supports(catalog):
        return None
    steps = list(steps)
    n = len(steps)
    if n <= 1:
        return steps

    scans = [scan_estimate(s, catalog) for s in steps]
    var_sets = [set(tp_vars(s.tp)) for s in steps]

    def tiebreak(i: int) -> tuple:
        # deterministic: Algorithm-4's key, then the input position
        return (-steps[i].tp.n_bound(), steps[i].size, i)

    if n > dp_limit:
        order = _greedy_order(list(range(n)), scans, var_sets, tiebreak)
        return [steps[i] for i in order]

    # Exact DP over subsets (left-deep): state = joined subset,
    # value = (total C_out cost, running rows, per-var distincts, order).
    # A subset is only ever extended by a join-connected step unless NO
    # unjoined step connects — the same cross-join discipline as
    # Algorithm 4, so enumerated orders execute on every backend.
    best: Dict[int, tuple] = {}
    for i in range(n):
        rows, dvar = scans[i]
        key = 1 << i
        cand = (rows, rows, dvar, (i,))
        if key not in best or _beats(cand, best[key], tiebreak):
            best[key] = cand
    for mask in sorted(best.keys() | set(range(1, 1 << n)),
                       key=lambda m: bin(m).count("1")):
        state = best.get(mask)
        if state is None:
            continue
        cost, rows, dvar, order = state
        outside = [i for i in range(n) if not (mask >> i) & 1]
        if not outside:
            continue
        connected = [i for i in outside if var_sets[i] & set(dvar)]
        for i in (connected or outside):
            out, nd = _join_in(rows, dvar, *scans[i])
            key = mask | (1 << i)
            cand = (cost + out, out, nd, order + (i,))
            if key not in best or _beats(cand, best[key], tiebreak):
                best[key] = cand
    order = best[(1 << n) - 1][3]
    return [steps[i] for i in order]


def _beats(a: tuple, b: tuple, tiebreak) -> bool:
    """Deterministic DP dominance: lower cost, then lower final rows,
    then the lexicographically smaller tiebreak sequence."""
    ka = (a[0], a[1], tuple(tiebreak(i) for i in a[3]))
    kb = (b[0], b[1], tuple(tiebreak(i) for i in b[3]))
    return ka < kb


def actual_cardinalities(steps: Sequence, catalog) -> Optional[List[int]]:
    """Measured intermediate cardinalities of a flat BGP pipeline: scan
    and join the steps left-to-right on the host, recording each
    intermediate row count (``Engine.explain``'s estimated-vs-actual
    column).  Diagnostics only — builds every join but the last, whose
    rows it only counts."""
    from repro_torch.core.executor import join_count, natural_join, scan_step
    out: List[int] = []
    acc = None
    for i, step in enumerate(steps):
        b = scan_step(step, catalog)
        if acc is not None and i == len(steps) - 1:
            out.append(join_count(acc, b))
            break
        acc = b if acc is None else natural_join(acc, b)
        out.append(int(len(acc.data)))
    return out

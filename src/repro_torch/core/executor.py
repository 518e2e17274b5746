"""Eager (host) relational executor for compiled plans.

This is the reference engine: exact dynamic shapes, vectorized numpy.
It mirrors what Spark SQL does for S2RDF — materialized intermediate
relations, sort-merge natural joins, SQL-style outer joins for OPTIONAL —
and is the correctness baseline for both the static-capacity executor
(:mod:`repro_torch.core.jexec`) and the distributed engine
(:mod:`repro_torch.core.distributed`).  It is the ``"eager"`` backend,
and a copy of the reference package's module: the same plan over the
same catalog gives the same rows in the same order.  It reads the
catalog's host tables (in memory or memory-mapped), never a device
tensor.

Semantics notes:
* Solution mappings are rows of int32 ids; ``UNBOUND`` (-1) encodes SQL
  NULL.  Like S2RDF (which compiles OPTIONAL to Spark SQL LEFT OUTER
  JOIN), we inherit SQL NULL-join semantics: an unbound value never
  satisfies a join/filter equality.
* FILTER comparisons: ``=``/``!=`` compare term identity (ids);
  ``<,<=,>,>=`` (or any comparison against a numeric constant) compare
  numeric literal values via the dictionary's value table; non-numeric
  terms never satisfy an order comparison (SPARQL type error -> row
  dropped).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.algebra import (
    BGP, BoolOp, Bound, Cmp, Distinct, Filter, FilterExpr, JoinPair, LeftJoin,
    Node, NotExpr, OrderBy, Project, Query, Slice, TriplePattern, UnionOp,
    is_var,
)
from repro_torch.core.compiler import Plan, ScanStep, compile_bgp
from repro_torch.core.modifiers import ModifierSpine, peel_spine
from repro_torch.core.stats import Catalog
from repro_torch.rdf.dictionary import UNBOUND

__all__ = ["Bindings", "execute", "execute_plan", "scan_step", "natural_join",
           "join_count", "apply_spine_host", "stable_unique_rows", "order_rows"]


@dataclass
class Bindings:
    """A relation over query variables."""

    cols: Tuple[str, ...]
    data: np.ndarray  # (n, len(cols)) int32

    def __post_init__(self) -> None:
        arr = np.asarray(self.data, dtype=np.int32)
        if arr.ndim == 2 and arr.shape[1] == len(self.cols):
            self.data = arr
        elif len(self.cols):
            self.data = arr.reshape(-1, len(self.cols))
        else:  # 0-column relation (fully-bound patterns): keep row count
            n = arr.shape[0] if arr.ndim >= 1 else 0
            self.data = arr.reshape(n, 0)

    @staticmethod
    def empty(cols: Sequence[str]) -> "Bindings":
        return Bindings(tuple(cols), np.empty((0, len(cols)), dtype=np.int32))

    @staticmethod
    def unit() -> "Bindings":
        """The single empty mapping (identity of ⋈)."""
        return Bindings((), np.empty((1, 0), dtype=np.int32))

    def __len__(self) -> int:
        return self.data.shape[0]

    def col(self, var: str) -> np.ndarray:
        return self.data[:, self.cols.index(var)]

    def as_set(self) -> set:
        """Canonical comparable form: frozenset would lose duplicates; use
        sorted tuple list instead where bags matter."""
        return set(map(tuple, self.data.tolist()))

    def as_multiset(self) -> Dict[tuple, int]:
        out: Dict[tuple, int] = {}
        for row in self.data.tolist():
            t = tuple(row)
            out[t] = out.get(t, 0) + 1
        return out


# ---------------------------------------------------------------------------
# Scans
# ---------------------------------------------------------------------------

def scan_step(step: ScanStep, catalog: Catalog) -> Bindings:
    """Materialize one triple pattern from its selected table (Algorithm 2)."""
    tp = step.tp
    if step.uses_tt:
        return _scan_tt(tp, catalog)

    table = catalog.table(step.kind, int(tp.p), step.p2)
    if table is None:
        # predicate absent
        cols = tuple(v for v in (tp.s, tp.o) if is_var(v))
        return Bindings.empty(_dedup(cols))
    rows = table.rows  # (n, 2) [s, o]

    mask = np.ones(len(rows), dtype=bool)
    if not is_var(tp.s):
        mask &= rows[:, 0] == int(tp.s)
    if not is_var(tp.o):
        mask &= rows[:, 1] == int(tp.o)
    if is_var(tp.s) and is_var(tp.o) and tp.s == tp.o:
        mask &= rows[:, 0] == rows[:, 1]
    rows = rows[mask]

    cols: List[str] = []
    take: List[int] = []
    if is_var(tp.s):
        cols.append(tp.s)
        take.append(0)
    if is_var(tp.o) and tp.o not in cols:
        cols.append(tp.o)
        take.append(1)
    return Bindings(tuple(cols), rows[:, take])


def _scan_tt(tp: TriplePattern, catalog: Catalog) -> Bindings:
    tt = catalog.tt
    mask = np.ones(len(tt), dtype=bool)
    for pos, term in ((0, tp.s), (1, tp.p), (2, tp.o)):
        if not is_var(term):
            mask &= tt[:, pos] == int(term)
    rows = tt[mask]
    cols: List[str] = []
    take: List[int] = []
    for pos, term in ((0, tp.s), (1, tp.p), (2, tp.o)):
        if is_var(term):
            if term in cols:  # repeated variable: equality selection
                rows = rows[rows[:, pos] == rows[:, take[cols.index(term)]]]
            else:
                cols.append(term)
                take.append(pos)
    return Bindings(tuple(cols), rows[:, take])


def _dedup(cols: Sequence[str]) -> Tuple[str, ...]:
    seen: List[str] = []
    for c in cols:
        if c not in seen:
            seen.append(c)
    return tuple(seen)


# ---------------------------------------------------------------------------
# Joins
# ---------------------------------------------------------------------------

def _pack_keys(b: Bindings, shared: Sequence[str], null_code: int) -> np.ndarray:
    """int64 join key per row; rows with any UNBOUND key -> unmatchable."""
    c0 = b.col(shared[0]).astype(np.int64)
    if len(shared) == 1:
        key = c0
        isnull = c0 == UNBOUND
    else:
        c1 = b.col(shared[1]).astype(np.int64)
        key = c0 * np.int64(2**31) + c1
        isnull = (c0 == UNBOUND) | (c1 == UNBOUND)
    return np.where(isnull, np.int64(null_code), key)


def _cross(a: Bindings, b: Bindings) -> Bindings:
    na, nb = len(a), len(b)
    left = np.repeat(a.data, nb, axis=0)
    right = np.tile(b.data, (na, 1))
    return Bindings(a.cols + b.cols, np.concatenate([left, right], axis=1))


def natural_join(a: Bindings, b: Bindings,
                 return_provenance: bool = False):
    """Sort-merge natural join.  Optionally returns the source row index
    of ``a`` for each output row (for OPTIONAL's matched-set computation)."""
    shared = [c for c in a.cols if c in b.cols]
    b_only = [c for c in b.cols if c not in a.cols]
    out_cols = a.cols + tuple(b_only)

    if not shared:
        out = _cross(a, b)
        if return_provenance:
            prov = np.repeat(np.arange(len(a)), len(b))
            return out, prov
        return out

    # Join on (up to) two packed key columns; post-filter the rest.
    key_cols = shared[:2]
    ka = _pack_keys(a, key_cols, null_code=-3)
    kb = _pack_keys(b, key_cols, null_code=-5)

    order_b = np.argsort(kb, kind="stable")
    kb_sorted = kb[order_b]
    lo = np.searchsorted(kb_sorted, ka, side="left")
    hi = np.searchsorted(kb_sorted, ka, side="right")
    cnt = (hi - lo).astype(np.int64)
    total = int(cnt.sum())

    a_idx = np.repeat(np.arange(len(a)), cnt)
    starts = np.repeat(lo, cnt)
    prefix = np.cumsum(cnt) - cnt            # exclusive prefix, shape == cnt
    offs = np.arange(total, dtype=np.int64) - np.repeat(prefix, cnt)
    b_idx = order_b[starts + offs]

    left = a.data[a_idx]
    right = b.data[b_idx]

    # post-filter on remaining shared columns (SQL NULL never matches)
    keep = np.ones(total, dtype=bool)
    for c in shared[2:]:
        va = left[:, a.cols.index(c)]
        vb = right[:, b.cols.index(c)]
        keep &= (va == vb) & (va != UNBOUND)
    if not keep.all():
        left, right, a_idx = left[keep], right[keep], a_idx[keep]

    right_extra = right[:, [b.cols.index(c) for c in b_only]] if b_only else \
        np.empty((left.shape[0], 0), dtype=np.int32)
    out = Bindings(out_cols, np.concatenate([left, right_extra], axis=1))
    if return_provenance:
        return out, a_idx
    return out


def join_count(a: Bindings, b: Bindings) -> int:
    """``len(natural_join(a, b))`` without building the join when at most
    two variables are shared: the sum over ``a``'s packed keys of their
    matches in ``b`` (a cardinality report's last step)."""
    shared = [c for c in a.cols if c in b.cols]
    if len(shared) > 2:
        return len(natural_join(a, b))
    if not shared:
        return len(a) * len(b)
    ka = _pack_keys(a, shared, null_code=-3)
    kb = np.sort(_pack_keys(b, shared, null_code=-5))
    return int((np.searchsorted(kb, ka, side="right")
                - np.searchsorted(kb, ka, side="left")).sum())


def left_outer_join(a: Bindings, b: Bindings,
                    expr: Optional[FilterExpr], catalog: Catalog) -> Bindings:
    inner, prov = natural_join(a, b, return_provenance=True)
    if expr is not None and len(inner):
        keep = eval_filter(expr, inner, catalog)
        inner = Bindings(inner.cols, inner.data[keep])
        prov = prov[keep]
    matched = np.zeros(len(a), dtype=bool)
    matched[np.unique(prov)] = True
    b_only = [c for c in inner.cols if c not in a.cols]
    pad = np.full((int((~matched).sum()), len(b_only)), UNBOUND, dtype=np.int32)
    unmatched = np.concatenate([a.data[~matched], pad], axis=1)
    return Bindings(inner.cols, np.concatenate([inner.data, unmatched], axis=0))


def union(a: Bindings, b: Bindings) -> Bindings:
    cols = a.cols + tuple(c for c in b.cols if c not in a.cols)

    def lift(x: Bindings) -> np.ndarray:
        out = np.full((len(x), len(cols)), UNBOUND, dtype=np.int32)
        for j, c in enumerate(cols):
            if c in x.cols:
                out[:, j] = x.col(c)
        return out

    return Bindings(cols, np.concatenate([lift(a), lift(b)], axis=0))


# ---------------------------------------------------------------------------
# Filters
# ---------------------------------------------------------------------------

def _operand(b: Bindings, values: np.ndarray, term, numeric: bool):
    """Return (ids or None, numeric values) arrays for a filter operand.
    A variable the relation does not bind is UNBOUND everywhere (never
    satisfies a comparison — the reference-oracle semantics)."""
    if isinstance(term, str) and term.startswith("?"):
        ids = b.col(term) if term in b.cols else \
            np.full(len(b), UNBOUND, dtype=np.int32)
        if numeric:
            safe = np.clip(ids, 0, len(values) - 1)
            val = np.where(ids >= 0, values[safe], np.nan)
            return ids, val
        return ids, None
    if isinstance(term, float):
        return None, np.full(len(b), term)
    # constant id
    tid = int(term)
    if numeric:
        v = values[tid] if 0 <= tid < len(values) else np.nan
        return np.full(len(b), tid, dtype=np.int64), np.full(len(b), v)
    return np.full(len(b), tid, dtype=np.int64), None


def eval_filter(expr: FilterExpr, b: Bindings, catalog: Catalog) -> np.ndarray:
    """Boolean mask over rows of b."""
    values = catalog.dictionary.values if catalog.dictionary is not None else \
        np.empty(0, dtype=np.float64)

    if isinstance(expr, BoolOp):
        masks = [eval_filter(e, b, catalog) for e in expr.args]
        out = masks[0]
        for m in masks[1:]:
            out = (out & m) if expr.op == "&&" else (out | m)
        return out
    if isinstance(expr, NotExpr):
        return ~eval_filter(expr.arg, b, catalog)
    if isinstance(expr, Bound):
        if expr.var not in b.cols:
            return np.zeros(len(b), dtype=bool)
        return b.col(expr.var) != UNBOUND
    assert isinstance(expr, Cmp)

    numeric = expr.op in ("<", "<=", ">", ">=") or \
        isinstance(expr.lhs, float) or isinstance(expr.rhs, float)
    lid, lval = _operand(b, values, expr.lhs, numeric)
    rid, rval = _operand(b, values, expr.rhs, numeric)

    if numeric:
        with np.errstate(invalid="ignore"):
            if expr.op == "=":
                return np.asarray(lval == rval)
            if expr.op == "!=":
                return np.asarray(lval != rval) & ~np.isnan(lval) & ~np.isnan(rval)
            if expr.op == "<":
                return np.asarray(lval < rval)
            if expr.op == "<=":
                return np.asarray(lval <= rval)
            if expr.op == ">":
                return np.asarray(lval > rval)
            return np.asarray(lval >= rval)
    # identity comparisons on ids; UNBOUND never satisfies
    ok = (lid != UNBOUND) & (rid != UNBOUND)
    if expr.op == "=":
        return (lid == rid) & ok
    return (lid != rid) & ok


# ---------------------------------------------------------------------------
# Plan / node evaluation
# ---------------------------------------------------------------------------

def execute_plan(plan: Plan, catalog: Catalog) -> Bindings:
    if plan.empty:
        return Bindings.empty(plan.vars)
    if not plan.steps:
        return Bindings.unit()
    out = scan_step(plan.steps[0], catalog)
    for step in plan.steps[1:]:
        out = natural_join(out, scan_step(step, catalog))
    return out


def _eval(node: Node, catalog: Catalog, layout: str = "extvp") -> Bindings:
    if isinstance(node, BGP):
        if layout == "pt":   # Sempala-style property-table baseline
            from repro_torch.core.pt import execute_pt_bgp
            return execute_pt_bgp(node, catalog)
        return execute_plan(compile_bgp(node, catalog, layout), catalog)
    if isinstance(node, JoinPair):
        return natural_join(_eval(node.left, catalog, layout),
                            _eval(node.right, catalog, layout))
    if isinstance(node, Filter):
        child = _eval(node.child, catalog, layout)
        if not len(child):
            return child
        return Bindings(child.cols, child.data[eval_filter(node.expr, child, catalog)])
    if isinstance(node, LeftJoin):
        return left_outer_join(_eval(node.left, catalog, layout),
                               _eval(node.right, catalog, layout), node.expr, catalog)
    if isinstance(node, UnionOp):
        return union(_eval(node.left, catalog, layout),
                     _eval(node.right, catalog, layout))
    if isinstance(node, Distinct):
        child = _eval(node.child, catalog, layout)
        return Bindings(child.cols, stable_unique_rows(child.data))
    if isinstance(node, OrderBy):
        return order_rows(_eval(node.child, catalog, layout), node.keys,
                          catalog)
    if isinstance(node, Slice):
        child = _eval(node.child, catalog, layout)
        end = None if node.limit is None else node.offset + node.limit
        return Bindings(child.cols, child.data[node.offset:end])
    if isinstance(node, Project):
        return _project(_eval(node.child, catalog, layout), node.vars)
    raise TypeError(f"unknown node {type(node)}")


def _project(b: Bindings, vars: Optional[List[str]]) -> Bindings:
    if vars is None:
        return b
    data = np.full((len(b), len(vars)), UNBOUND, dtype=np.int32)
    for j, v in enumerate(vars):
        if v in b.cols:
            data[:, j] = b.col(v)
    return Bindings(tuple(vars), data)


# ---------------------------------------------------------------------------
# Solution modifiers (canonical order, shared with the device engines)
# ---------------------------------------------------------------------------

def stable_unique_rows(data: np.ndarray) -> np.ndarray:
    """First-occurrence-stable row dedup.  SPARQL DISTINCT must preserve
    the sequence order (an ORDER BY established before or after it must
    survive); ``np.unique`` alone re-sorts the rows, which is the
    modifier-ordering bug this replaces."""
    if len(data) <= 1:
        return data
    _, idx = np.unique(data, axis=0, return_index=True)
    return data[np.sort(idx)]


def order_rows(b: Bindings, keys: Sequence[Tuple[str, bool]],
               catalog: Catalog) -> Bindings:
    """ORDER BY over the dictionary's numeric value table: numeric
    literals sort by value, everything else by term id; UNBOUND sorts
    last under ASC (SQL NULLS LAST, shared with the device engines);
    stable, so tied rows keep their prior order.  Keys over variables
    the relation does not bind are constant (≡ skipped)."""
    if not len(b) or not keys:
        return b
    values = catalog.dictionary.values if catalog.dictionary is not None \
        else np.empty(0, dtype=np.float64)
    ks = []
    for var, asc in reversed(keys):
        if var not in b.cols:
            continue
        ids = b.col(var)
        if len(values):
            safe = np.clip(ids, 0, len(values) - 1)
            v = np.where(ids >= 0, values[safe], np.nan)
        else:
            v = np.full(len(b), np.nan)
        v = np.where(np.isnan(v), ids.astype(np.float64), v)
        v = np.where(ids == UNBOUND, np.inf, v)
        ks.append(v if asc else -v)
    if not ks:
        return b
    return Bindings(b.cols, b.data[np.lexsort(ks)])


def apply_spine_host(b: Bindings, spine: ModifierSpine,
                     catalog: Catalog) -> Bindings:
    """Apply a modifier spine in the canonical SPARQL order:
    FILTER* → ORDER BY → project → DISTINCT → OFFSET/LIMIT (ordering
    runs before projection, so sort keys outside the SELECT list work;
    projection and stable dedup both preserve the established order)."""
    for expr in spine.filters:
        if len(b):
            b = Bindings(b.cols, b.data[eval_filter(expr, b, catalog)])
    if spine.order:
        b = order_rows(b, spine.order, catalog)
    b = _project(b, list(spine.project) if spine.project is not None else None)
    if spine.distinct:
        b = Bindings(b.cols, stable_unique_rows(b.data))
    if spine.has_slice:
        end = None if spine.limit is None else spine.offset + spine.limit
        b = Bindings(b.cols, b.data[spine.offset:end])
    return b


def execute(query: Query, catalog: Catalog, layout: str = "extvp") -> Bindings:
    """Evaluate a parsed query.  ``layout`` selects the storage schema the
    compiler targets: "extvp" (default), "vp" or "tt" (paper §4 baselines).

    The modifier spine is peeled off the root and applied in the
    canonical order → project → distinct → slice sequence (DISTINCT
    before the slice and order-preserving, ORDER BY before projection),
    fixing the historical dedup-after-LIMIT behaviour."""
    core, spine = peel_spine(query)
    return apply_spine_host(_eval(core, catalog, layout), spine, catalog)

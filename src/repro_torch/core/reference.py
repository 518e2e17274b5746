"""Brute-force reference implementation of the query semantics.

Direct transcription of the BGP semantics of paper §2.1 (solution
mappings, compatibility, ⋈ of bags) with the same SQL-style OPTIONAL /
FILTER conventions as the engine.  O(|G|^patterns) — only for tests and
tiny graphs; this is the oracle every executor must agree with.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from repro_torch.core.algebra import (
    BGP, BoolOp, Bound, Cmp, Distinct, Filter, FilterExpr, JoinPair, LeftJoin,
    Node, NotExpr, OrderBy, Project, Query, Slice, TriplePattern, UnionOp,
    is_var,
)
from repro_torch.rdf.dictionary import UNBOUND

Mapping = Dict[str, int]
MISSING_TERM = -2


def _match_tp(tp: TriplePattern, triples: np.ndarray) -> List[Mapping]:
    out: List[Mapping] = []
    for s, p, o in triples.tolist():
        mu: Mapping = {}
        ok = True
        for term, val in ((tp.s, s), (tp.p, p), (tp.o, o)):
            if is_var(term):
                if term in mu and mu[term] != val:
                    ok = False
                    break
                mu[term] = val
            elif int(term) != val:
                ok = False
                break
        if ok:
            out.append(mu)
    return out


def _compatible(a: Mapping, b: Mapping) -> bool:
    for k, v in a.items():
        if k in b:
            if v != b[k] or v == UNBOUND or b[k] == UNBOUND:
                return False
    return True


def _merge_bags(xs: List[Mapping], ys: List[Mapping]) -> List[Mapping]:
    out = []
    for x in xs:
        for y in ys:
            if _compatible(x, y):
                m = dict(x)
                m.update(y)
                out.append(m)
    return out


def _eval_bgp(bgp: BGP, triples: np.ndarray) -> List[Mapping]:
    res: List[Mapping] = [{}]
    for tp in bgp.patterns:
        if any((not is_var(t)) and int(t) == MISSING_TERM
               for t in (tp.s, tp.p, tp.o)):
            return []
        res = _merge_bags(res, _match_tp(tp, triples))
        if not res:
            return []
    return res


def _filter_val(expr: FilterExpr, mu: Mapping, values: np.ndarray) -> bool:
    if isinstance(expr, BoolOp):
        vals = [_filter_val(e, mu, values) for e in expr.args]
        return all(vals) if expr.op == "&&" else any(vals)
    if isinstance(expr, NotExpr):
        return not _filter_val(expr.arg, mu, values)
    if isinstance(expr, Bound):
        return mu.get(expr.var, UNBOUND) != UNBOUND
    assert isinstance(expr, Cmp)

    def resolve(t):
        if isinstance(t, str) and t.startswith("?"):
            return mu.get(t, UNBOUND)
        return t

    lhs, rhs = resolve(expr.lhs), resolve(expr.rhs)
    numeric = expr.op in ("<", "<=", ">", ">=") or \
        isinstance(lhs, float) or isinstance(rhs, float)
    if numeric:
        def num(t):
            if isinstance(t, float):
                return t
            tid = int(t)
            if 0 <= tid < len(values):
                return float(values[tid])
            return float("nan")
        lv, rv = num(lhs), num(rhs)
        if np.isnan(lv) or np.isnan(rv):
            return False
        return {"=": lv == rv, "!=": lv != rv, "<": lv < rv,
                "<=": lv <= rv, ">": lv > rv, ">=": lv >= rv}[expr.op]
    li, ri = int(lhs), int(rhs)
    if li == UNBOUND or ri == UNBOUND:
        return False
    return (li == ri) if expr.op == "=" else (li != ri)


def _eval(node: Node, triples: np.ndarray, values: np.ndarray) -> List[Mapping]:
    if isinstance(node, BGP):
        return _eval_bgp(node, triples)
    if isinstance(node, JoinPair):
        return _merge_bags(_eval(node.left, triples, values),
                           _eval(node.right, triples, values))
    if isinstance(node, Filter):
        return [m for m in _eval(node.child, triples, values)
                if _filter_val(node.expr, m, values)]
    if isinstance(node, LeftJoin):
        left = _eval(node.left, triples, values)
        right = _eval(node.right, triples, values)
        out = []
        for x in left:
            matches = []
            for y in right:
                if _compatible(x, y):
                    m = dict(x)
                    m.update(y)
                    if node.expr is None or _filter_val(node.expr, m, values):
                        matches.append(m)
            out.extend(matches if matches else [dict(x)])
        return out
    if isinstance(node, UnionOp):
        return _eval(node.left, triples, values) + _eval(node.right, triples, values)
    if isinstance(node, Distinct):
        return _distinct(_eval(node.child, triples, values))
    if isinstance(node, OrderBy):
        res = _eval(node.child, triples, values)
        for var, asc in reversed(node.keys):
            def key(m):
                tid = m.get(var, UNBOUND)
                if tid == UNBOUND:
                    return float("inf")   # NULLS LAST, like the engines
                v = float(values[tid]) if 0 <= tid < len(values) else float("nan")
                return float(tid) if np.isnan(v) else v
            res = sorted(res, key=key, reverse=not asc)
        return res
    if isinstance(node, Slice):
        res = _eval(node.child, triples, values)
        end = None if node.limit is None else node.offset + node.limit
        return res[node.offset:end]
    if isinstance(node, Project):
        return [{v: m.get(v, UNBOUND) for v in node.vars}
                for m in _eval(node.child, triples, values)]
    raise TypeError(type(node))


def _distinct(res: List[Mapping]) -> List[Mapping]:
    seen, out = set(), []
    for m in res:
        key = tuple(sorted(m.items()))
        if key not in seen:
            seen.add(key)
            out.append(m)
    return out


def execute_reference(query: Query, triples: np.ndarray,
                      values: Optional[np.ndarray] = None) -> List[Mapping]:
    """Evaluate a query by brute force. Returns a bag of mappings.

    Solution modifiers follow the canonical order shared with the
    engines (see :mod:`repro_torch.core.modifiers`): the spine is peeled off
    the root and applied as FILTER* → ORDER BY → project → DISTINCT →
    OFFSET/LIMIT, with first-occurrence-stable dedup."""
    from repro_torch.core.modifiers import peel_spine

    values = values if values is not None else np.empty(0)
    core, spine = peel_spine(query)
    res = _eval(core, triples, values)
    for expr in spine.filters:
        res = [m for m in res if _filter_val(expr, m, values)]
    for var, asc in reversed(spine.order):   # pre-projection, W3C order
        def key(m, var=var):
            tid = m.get(var, UNBOUND)
            if tid == UNBOUND:
                return float("inf")       # NULLS LAST, like the engines
            v = float(values[tid]) if 0 <= tid < len(values) else float("nan")
            return float(tid) if np.isnan(v) else v
        res = sorted(res, key=key, reverse=not asc)
    if spine.project is not None:
        res = [{v: m.get(v, UNBOUND) for v in spine.project} for m in res]
    if spine.distinct:
        res = _distinct(res)
    if spine.has_slice:
        end = None if spine.limit is None else spine.offset + spine.limit
        res = res[spine.offset:end]
    return res


def mappings_to_multiset(res: List[Mapping], cols) -> Dict[tuple, int]:
    """Canonical multiset form over a fixed column order (UNBOUND fill)."""
    out: Dict[tuple, int] = {}
    for m in res:
        t = tuple(int(m.get(c, UNBOUND)) for c in cols)
        out[t] = out.get(t, 0) + 1
    return out

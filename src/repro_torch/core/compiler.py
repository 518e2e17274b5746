"""SPARQL → relational-plan compiler (paper §6, Algorithms 1–4).

``select_table``    — Algorithm 1 (TableSelection): per triple pattern,
choose the ExtVP table with the smallest SF over all SS/SO/OS correlations
to other patterns in the BGP; fall back to VP; TT for unbound predicates.

``compile_bgp``     — Algorithm 4 (BGP2SQL_OPT): join-order by
(#bound values, selected-table size), preferring join-connected patterns
so cross joins only happen when the BGP is genuinely disconnected;
short-circuits to the empty plan when any selected table has SF = 0
("a SPARQL query which contains a correlation between two predicates that
does not exist in the dataset can be answered by using the statistics
only").

The produced :class:`Plan` is declarative — a join-ordered list of
:class:`ScanStep` — and is executed by the static-capacity executor (:mod:`repro_torch.core.jexec`).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple, Union

from repro_torch.core.algebra import (
    BGP, CORR_OS, CORR_SO, CORR_SS, Filter, FilterExpr, JoinPair, LeftJoin,
    Node, TriplePattern, UnionOp, correlations, is_var, tp_vars,
)
from repro_torch.core.stats import Catalog

__all__ = ["ScanStep", "Plan", "select_table", "compile_bgp",
           "BGPSeg", "EmptySeg", "FilterSeg", "CombineSeg", "CorePlan",
           "compile_core", "core_filter_exprs", "seg_vars"]

MISSING_TERM = -2


@dataclass
class ScanStep:
    """One triple pattern bound to its selected table."""

    tp: TriplePattern
    kind: Optional[str]          # None => VP (or TT if tp.p is a var)
    p2: Optional[int]            # partner predicate for ExtVP tables
    sf: float                    # SF of the selected table
    size: int                    # tuples in the selected table (stats)
    uses_tt: bool = False        # unbound predicate => triples table

    def describe(self) -> str:
        if self.uses_tt:
            return f"TT{self.tp}"
        if self.kind is None:
            return f"VP[{self.tp.p}]{self.tp}"
        return f"ExtVP^{self.kind}[{self.tp.p}|{self.p2}]{self.tp} sf={self.sf:.3g}"


@dataclass
class Plan:
    steps: List[ScanStep] = field(default_factory=list)
    empty: bool = False          # statistics-proven empty result
    vars: Tuple[str, ...] = ()
    #: which join-order planner produced ``steps``: "greedy" (Algorithm 4)
    #: or "estimate" (cardinality-estimate enumeration).  A requested
    #: "estimate" that fell back (no distinct-count statistics) records
    #: "greedy" — the field reports what actually ran.
    planner: str = "greedy"

    def describe(self) -> str:
        if self.empty:
            return "EMPTY (statistics short-circuit)"
        return " ⋈ ".join(s.describe() for s in self.steps)


def select_table(tp: TriplePattern, bgp: List[TriplePattern],
                 catalog: Catalog, layout: str = "extvp") -> ScanStep:
    """Algorithm 1 (TableSelection).

    ``layout`` selects the storage schema under comparison (paper §4):
    "extvp" (the contribution), "vp" (Abadi-style vertical partitioning —
    the paper's own baseline) or "tt" (giant triples table)."""
    if layout == "tt":
        return ScanStep(tp, None, None, 1.0, catalog.n_triples, uses_tt=True)
    if is_var(tp.p):
        return ScanStep(tp, None, None, 1.0, catalog.n_triples, uses_tt=True)
    p = int(tp.p)
    if p == MISSING_TERM or catalog.vp_size(p) == 0:
        return ScanStep(tp, None, None, 0.0, 0)

    best_kind: Optional[str] = None
    best_p2: Optional[int] = None
    best_sf = 1.0
    best_size = catalog.vp_size(p)

    if layout == "vp":
        return ScanStep(tp, None, None, best_sf, best_size)

    for other in bgp:
        if other is tp or is_var(other.p):
            continue
        q = int(other.p)
        if q == MISSING_TERM:
            continue
        for corr in correlations(tp, other):
            if corr not in (CORR_SS, CORR_SO, CORR_OS):
                continue  # OO not precomputed (paper §5.2)
            sf = catalog.sf(corr, p, q)
            # Only credit reductions the store can actually serve: an SF
            # above the build threshold τ was never materialized, and
            # Catalog.table() would silently scan the full VP relation
            # while the recorded sf/size misled join ordering and the
            # cardinality estimator.  SF=0 stays selectable regardless —
            # it is a statistics-only short-circuit, no table needed.
            if sf < best_sf and (sf == 0.0 or catalog.materialized(corr, p, q)):
                best_sf = sf
                best_kind, best_p2 = corr, q
                best_size = catalog.size(corr, p, q)
    return ScanStep(tp, best_kind, best_p2, best_sf, best_size)


def _emptiness(tp: TriplePattern) -> bool:
    """A pattern with a bound term that is missing from the dictionary."""
    return any((not is_var(t)) and int(t) == MISSING_TERM
               for t in (tp.s, tp.p, tp.o))


def compile_bgp(bgp: BGP, catalog: Catalog, layout: str = "extvp",
                planner: str = "greedy") -> Plan:
    """Algorithm 4 (BGP2SQL_OPT): table selection + join ordering.

    ``planner`` selects the join-order strategy: ``"greedy"`` is the
    paper's (#bound values, table size) order.  ``"estimate"`` (the
    cardinality-estimate enumerator) is not ported yet and raises
    NotImplementedError.
    """
    if planner == "estimate":
        raise NotImplementedError(
            "the estimate planner is not ported yet; use planner='greedy'")
    if planner != "greedy":
        raise ValueError(f"unknown planner {planner!r}; expected 'greedy'")
    patterns = list(bgp.patterns)
    if not patterns:
        return Plan(steps=[], vars=())

    # Statistics-only empties: missing terms or SF=0 selected tables.
    if any(_emptiness(tp) for tp in patterns):
        return Plan(empty=True, vars=bgp.vars())

    selected = {id(tp): select_table(tp, patterns, catalog, layout)
                for tp in patterns}
    if any(s.sf == 0.0 for s in selected.values()):
        return Plan(empty=True, vars=bgp.vars())

    # Join ordering.  Paper: order by #bound values first, then repeatedly
    # pick the smallest-table pattern that is join-connected to the bound
    # variable set (avoiding cross joins unless the BGP is disconnected).
    remaining = list(patterns)
    bound_vars: set = set()
    ordered: List[ScanStep] = []
    while remaining:
        def sort_key(tp: TriplePattern):
            step = selected[id(tp)]
            connected = bool(bound_vars) and bool(set(tp_vars(tp)) & bound_vars)
            # Prefer: connected (after first), more bound values, smaller table
            return (
                0 if (connected or not bound_vars) else 1,
                -tp.n_bound(),
                step.size,
            )

        nxt = min(remaining, key=sort_key)
        remaining.remove(nxt)
        ordered.append(selected[id(nxt)])
        bound_vars |= set(tp_vars(nxt))

    return Plan(steps=ordered, vars=bgp.vars())


# ---------------------------------------------------------------------------
# Core plans: pattern trees (OPTIONAL / UNION / FILTER over BGPs) compiled
# for the static-shape device executors.
#
# A *core* is the graph-pattern part of a query (the tree under the
# solution-modifier spine).  The device engines execute it as a tree of
# segments over ONE flat join-ordered scan list:
#
#   * ``BGPSeg``     — a compiled BGP (Algorithm 4 plan) whose steps live
#                      at ``[start, start + len(plan.steps))`` in the flat
#                      plan, so constant re-binding stays a single
#                      ``(n_steps, 2)`` runtime bounds array;
#   * ``FilterSeg``  — a FILTER applied to its child's relation;
#   * ``CombineSeg`` — join / left-outer join (OPTIONAL) / union of two
#                      child segments;
#   * ``EmptySeg``   — a statistics-proven empty subtree (SF = 0 or a
#                      missing term), kept in the tree because OPTIONAL
#                      and UNION survive an empty operand.
# ---------------------------------------------------------------------------

@dataclass
class BGPSeg:
    """A compiled BGP; ``start`` is its offset in ``CorePlan.flat``."""

    plan: Plan
    start: int = 0


@dataclass
class EmptySeg:
    """Statistics-proven empty subtree (vars kept for column layout)."""

    vars: Tuple[str, ...] = ()


@dataclass
class FilterSeg:
    child: "CoreSeg"
    expr: FilterExpr


@dataclass
class CombineSeg:
    kind: str                 # 'join' | 'left' | 'union'
    left: "CoreSeg"
    right: "CoreSeg"
    expr: Optional[FilterExpr] = None   # OPTIONAL's join condition


CoreSeg = Union[BGPSeg, EmptySeg, FilterSeg, CombineSeg]


@dataclass
class CorePlan:
    """A segment tree plus the flat scan plan the segments index into.

    ``flat`` is what template re-binding operates on
    (:func:`repro_torch.engine.template.rebind_plan` /
    :func:`repro_torch.core.jexec.bounds_from_plan` are tree-agnostic: scan
    constants are positional over the flat step list).
    """

    root: CoreSeg
    flat: Plan
    empty: bool
    vars: Tuple[str, ...]

    def describe(self) -> str:
        if self.empty:
            return "EMPTY (statistics short-circuit)"

        def rec(seg: CoreSeg) -> str:
            if isinstance(seg, BGPSeg):
                return seg.plan.describe()
            if isinstance(seg, EmptySeg):
                return "EMPTY"
            if isinstance(seg, FilterSeg):
                return f"FILTER({rec(seg.child)})"
            op = {"join": "⋈", "left": "⟕", "union": "∪"}[seg.kind]
            return f"({rec(seg.left)} {op} {rec(seg.right)})"

        return rec(self.root)


def seg_vars(seg: CoreSeg) -> Tuple[str, ...]:
    """Variables a segment's relation binds, in column order (the order
    the device pipeline produces: left-to-right, first-seen)."""
    if isinstance(seg, EmptySeg):
        return tuple(seg.vars)
    if isinstance(seg, BGPSeg):
        return seg.plan.vars
    if isinstance(seg, FilterSeg):
        return seg_vars(seg.child)
    left = seg_vars(seg.left)
    return left + tuple(v for v in seg_vars(seg.right) if v not in left)


def core_filter_exprs(seg: CoreSeg) -> List[FilterExpr]:
    """Filter expressions of a core in evaluation order — the order the
    traced program consumes their constant slots (child before own
    expression; combine children left before right before the OPTIONAL
    condition).  Prepended to the spine's filters when building the
    shared runtime ``fconsts`` vector."""
    if isinstance(seg, FilterSeg):
        return core_filter_exprs(seg.child) + [seg.expr]
    if isinstance(seg, CombineSeg):
        out = core_filter_exprs(seg.left) + core_filter_exprs(seg.right)
        if seg.expr is not None:
            out.append(seg.expr)
        return out
    return []


def compile_core(node: Node, catalog: Catalog,
                 layout: str = "extvp", planner: str = "greedy") -> CorePlan:
    """Compile a graph-pattern tree into a :class:`CorePlan`.

    Two phases: (1) bottom-up build with emptiness pruning — a
    statistics-empty BGP collapses to :class:`EmptySeg` and the pruning
    respects operator identity (a join with an empty operand is empty; a
    left join survives an empty RIGHT side — its left rows pass through
    UNBOUND-padded; a union survives either side empty); (2) flat-offset
    assignment over the pruned tree, so discarded subtrees contribute no
    scan steps, no capacities and no bounds rows.

    Raises ``NotImplementedError`` for node kinds outside the device
    fragment — the backends' fall-back-to-eager signal.
    """

    def build(n: Node) -> CoreSeg:
        if isinstance(n, BGP):
            plan = compile_bgp(n, catalog, layout, planner)
            if plan.empty:
                return EmptySeg(vars=plan.vars)
            return BGPSeg(plan=plan)
        if isinstance(n, Filter):
            child = build(n.child)
            if isinstance(child, EmptySeg):
                return child
            return FilterSeg(child=child, expr=n.expr)
        if isinstance(n, JoinPair):
            left, right = build(n.left), build(n.right)
            if isinstance(left, EmptySeg) or isinstance(right, EmptySeg):
                lv = seg_vars(left)
                return EmptySeg(vars=lv + tuple(
                    v for v in seg_vars(right) if v not in lv))
            return CombineSeg(kind="join", left=left, right=right)
        if isinstance(n, LeftJoin):
            left, right = build(n.left), build(n.right)
            if isinstance(left, EmptySeg):
                lv = seg_vars(left)
                return EmptySeg(vars=lv + tuple(
                    v for v in seg_vars(right) if v not in lv))
            return CombineSeg(kind="left", left=left, right=right,
                              expr=n.expr)
        if isinstance(n, UnionOp):
            left, right = build(n.left), build(n.right)
            if isinstance(left, EmptySeg) and isinstance(right, EmptySeg):
                lv = seg_vars(left)
                return EmptySeg(vars=lv + tuple(
                    v for v in seg_vars(right) if v not in lv))
            return CombineSeg(kind="union", left=left, right=right)
        raise NotImplementedError(
            f"device core does not cover {type(n).__name__}")

    root = build(node)

    flat_steps: List[ScanStep] = []

    def assign(seg: CoreSeg) -> None:
        if isinstance(seg, BGPSeg):
            seg.start = len(flat_steps)
            flat_steps.extend(seg.plan.steps)
        elif isinstance(seg, FilterSeg):
            assign(seg.child)
        elif isinstance(seg, CombineSeg):
            assign(seg.left)
            assign(seg.right)

    assign(root)
    empty = isinstance(root, EmptySeg)

    def used(seg: CoreSeg) -> bool:
        if isinstance(seg, BGPSeg):
            return seg.plan.planner == "estimate"
        if isinstance(seg, FilterSeg):
            return used(seg.child)
        if isinstance(seg, CombineSeg):
            return used(seg.left) or used(seg.right)
        return False

    flat = Plan(steps=flat_steps, empty=empty, vars=seg_vars(root),
                planner="estimate" if used(root) else "greedy")
    return CorePlan(root=root, flat=flat, empty=empty, vars=flat.vars)

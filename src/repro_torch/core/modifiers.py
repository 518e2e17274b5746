"""SPARQL solution-modifier spine: one canonical form for every engine.

SPARQL queries produced by the parser are a *spine* of solution
modifiers wrapped around a graph-pattern core::

    Slice(OrderBy(Filter(... Filter(core) ...)))   + Query.select/.distinct

The W3C semantics pin the application order of the modifiers (SPARQL
1.1 §18.2.4–18.2.5): ORDER BY runs over the un-projected solutions (so
sorting by a variable outside the SELECT list is legal), dedup happens
on the *projected* rows and BEFORE the slice, and projection/DISTINCT
must not destroy the established order.  Historically each engine
re-derived that order ad hoc (and the eager engine applied DISTINCT
last, after LIMIT — the modifier-ordering bug this module exists to
kill).  ``peel_spine`` normalizes a query into ``(core, ModifierSpine)``
once, and every executor — the eager host engine, the brute-force
reference oracle, the jitted device pipeline and the distributed
shard_map engine — applies the same canonical sequence:

    core → FILTER* → ORDER BY → project → DISTINCT → OFFSET/LIMIT

with a first-occurrence-stable DISTINCT (it preserves the sorted order,
and because stable dedup commutes with a stable sort over projected
keys, this sequence also equals project→distinct→order→slice whenever
the sort keys survive projection).

The spine is also what the device backends compile: the jit/distributed
executors accept a ``ModifierSpine`` and lower each modifier onto the
static-shape relation (see :mod:`repro_torch.core.jexec`), with the filter's
constant operands riding the runtime ``fconsts`` input so constant
re-binding never re-traces.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Dict, List, Optional, Tuple

from repro_torch.core.algebra import (
    BoolOp, Bound, Cmp, Distinct, Filter, FilterExpr, Node, NotExpr, OrderBy,
    Project, Query, Slice,
)

__all__ = [
    "ModifierSpine", "peel_spine", "filter_const_slots", "filter_variables",
    "substitute_term", "substitute_filter", "substitute_spine",
]


@dataclass(frozen=True)
class ModifierSpine:
    """The solution modifiers of one query, in canonical application
    order: ``filters`` → ``order`` → ``project`` → ``distinct`` →
    ``offset``/``limit``."""

    filters: Tuple[FilterExpr, ...] = ()
    project: Optional[Tuple[str, ...]] = None     # None = SELECT *
    distinct: bool = False
    order: Tuple[Tuple[str, bool], ...] = ()      # (var, ascending)
    offset: int = 0
    limit: Optional[int] = None

    @property
    def trivial(self) -> bool:
        return (not self.filters and self.project is None
                and not self.distinct and not self.order
                and not self.offset and self.limit is None)

    @property
    def has_slice(self) -> bool:
        return bool(self.offset) or self.limit is not None

    @property
    def needs_global(self) -> bool:
        """True when the modifier needs the WHOLE relation (cross-shard
        on a distributed engine): DISTINCT / ORDER BY / OFFSET / LIMIT.
        FILTER and projection are row-local and stay sharded."""
        return self.distinct or bool(self.order) or self.has_slice


def peel_spine(query: Query) -> Tuple[Node, ModifierSpine]:
    """Split ``query`` into its graph-pattern core and modifier spine.

    Peels the parser-shaped spine — ``Slice`` → ``OrderBy`` →
    ``Distinct`` → ``Project`` → ``Filter``* — off the root and folds
    ``Query.select`` / ``Query.distinct`` in.  Nodes nested in any other
    arrangement stay in the core (the host ``_eval`` still interprets
    them); the spine captures exactly the shapes the grammar can emit.
    """
    node = query.root
    offset, limit = 0, None
    order: Tuple[Tuple[str, bool], ...] = ()
    distinct = bool(query.distinct)
    project = tuple(query.select) if query.select is not None else None

    if isinstance(node, Slice):
        offset, limit = node.offset, node.limit
        node = node.child
    if isinstance(node, OrderBy):
        order = tuple(node.keys)
        node = node.child
    if isinstance(node, Distinct):
        distinct = True
        node = node.child
    if isinstance(node, Project) and project is None:
        project = tuple(node.vars) if node.vars is not None else None
        node = node.child
    filters: List[FilterExpr] = []
    while isinstance(node, Filter):
        filters.append(node.expr)
        node = node.child
    filters.reverse()  # innermost Filter applies first
    return node, ModifierSpine(filters=tuple(filters), project=project,
                               distinct=distinct, order=order,
                               offset=offset, limit=limit)


# ---------------------------------------------------------------------------
# Filter-expression introspection (what the device compiler consumes)
# ---------------------------------------------------------------------------

def filter_const_slots(filters: Tuple[FilterExpr, ...]) -> Tuple[int, ...]:
    """Constant (non-var, non-float) operand ids of the filter exprs, in
    deterministic walk order.  These are the runtime ``fconsts`` slots of
    the compiled device program: the traced filter reads ``fconsts[i]``
    where this walk saw slot ``i``, so re-binding a template constant is
    a pure input change — no re-trace.  Ids may be template placeholders
    (negative band) or concrete dictionary ids; ``fconsts_from_mapping``
    resolves both."""
    slots: List[int] = []

    def walk(e: FilterExpr) -> None:
        if isinstance(e, Cmp):
            for t in (e.lhs, e.rhs):
                if not isinstance(t, (str, float)):
                    slots.append(int(t))
        elif isinstance(e, BoolOp):
            for a in e.args:
                walk(a)
        elif isinstance(e, NotExpr):
            walk(e.arg)
        # Bound carries no constants

    for e in filters:
        walk(e)
    return tuple(slots)


def filter_variables(filters: Tuple[FilterExpr, ...]) -> Tuple[str, ...]:
    """Variables referenced by the filter exprs, first-seen order."""
    out: List[str] = []

    def walk(e: FilterExpr) -> None:
        if isinstance(e, Cmp):
            for t in (e.lhs, e.rhs):
                if isinstance(t, str) and t.startswith("?") and t not in out:
                    out.append(t)
        elif isinstance(e, BoolOp):
            for a in e.args:
                walk(a)
        elif isinstance(e, NotExpr):
            walk(e.arg)
        elif isinstance(e, Bound):
            if e.var not in out:
                out.append(e.var)

    for e in filters:
        walk(e)
    return tuple(out)


def substitute_term(t, mapping: Dict[int, int]):
    """Rewrite a constant id through ``mapping``; variables and float
    literals pass through.  The single id-substitution primitive shared
    by filter, triple-pattern and plan re-binding (see
    :mod:`repro_torch.engine.template`)."""
    if isinstance(t, (str, float)):
        return t
    return mapping.get(int(t), t)


def substitute_filter(e: FilterExpr, mapping: Dict[int, int]) -> FilterExpr:
    """Clone a filter expression with constant ids rewritten."""
    if isinstance(e, Cmp):
        return Cmp(e.op, substitute_term(e.lhs, mapping),
                   substitute_term(e.rhs, mapping))
    if isinstance(e, BoolOp):
        return BoolOp(e.op, tuple(substitute_filter(a, mapping)
                                  for a in e.args))
    if isinstance(e, NotExpr):
        return NotExpr(substitute_filter(e.arg, mapping))
    assert isinstance(e, Bound)
    return e


def substitute_spine(spine: ModifierSpine,
                     mapping: Dict[int, int]) -> ModifierSpine:
    """Re-bind template placeholder ids inside the spine's filters (the
    host-path counterpart of the device ``fconsts`` input)."""
    if not mapping or not spine.filters:
        return spine
    return replace(spine, filters=tuple(substitute_filter(e, mapping)
                                        for e in spine.filters))

"""SPARQL algebra (paper §2.1, §6).

Terms in patterns are either variables (strings starting with ``?``) or
dictionary-encoded constants (ints).  The algebra is the W3C SPARQL 1.0
core the paper supports: BGPs + FILTER / OPTIONAL / UNION / DISTINCT /
ORDER BY / LIMIT / OFFSET / projection.  (SPARQL 1.1 aggregations and
subqueries are out of scope, as in the paper.)
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple, Union

TermT = Union[str, int]  # '?var' or dictionary id

__all__ = [
    "TriplePattern", "BGP", "FilterExpr", "Cmp", "BoolOp", "NotExpr", "Bound",
    "Filter", "LeftJoin", "UnionOp", "Distinct", "OrderBy", "Slice", "Project",
    "Query", "is_var", "tp_vars", "CORR_SS", "CORR_SO", "CORR_OS", "CORR_OO",
    "correlations",
]

CORR_SS, CORR_SO, CORR_OS, CORR_OO = "SS", "SO", "OS", "OO"


def is_var(t: TermT) -> bool:
    return isinstance(t, str) and t.startswith("?")


@dataclass(frozen=True)
class TriplePattern:
    s: TermT
    p: TermT
    o: TermT

    def n_bound(self) -> int:
        return sum(0 if is_var(t) else 1 for t in (self.s, self.p, self.o))

    def __repr__(self) -> str:  # compact
        return f"({self.s} {self.p} {self.o})"


def tp_vars(tp: TriplePattern) -> Tuple[str, ...]:
    return tuple(t for t in (tp.s, tp.p, tp.o) if is_var(t))


def correlations(a: TriplePattern, b: TriplePattern) -> List[str]:
    """Correlation kinds of ``a`` against ``b`` (paper Fig. 9).

    Returns the kinds through which ``a``'s table can be reduced: e.g. SS
    means a.s and b.s share a variable -> candidate ExtVP^SS_{a.p|b.p}.
    """
    out = []
    if is_var(a.s) and a.s == b.s:
        out.append(CORR_SS)
    if is_var(a.s) and a.s == b.o:
        out.append(CORR_SO)
    if is_var(a.o) and a.o == b.s:
        out.append(CORR_OS)
    if is_var(a.o) and a.o == b.o:
        out.append(CORR_OO)
    return out


# ---------------------------------------------------------------------------
# Filter expressions
# ---------------------------------------------------------------------------

class FilterExpr:
    pass


@dataclass(frozen=True)
class Cmp(FilterExpr):
    op: str                 # '=', '!=', '<', '<=', '>', '>='
    lhs: TermT              # var or const id
    rhs: TermT

    def __post_init__(self):
        assert self.op in ("=", "!=", "<", "<=", ">", ">=")


@dataclass(frozen=True)
class BoolOp(FilterExpr):
    op: str                 # '&&' or '||'
    args: Tuple[FilterExpr, ...]


@dataclass(frozen=True)
class NotExpr(FilterExpr):
    arg: FilterExpr


@dataclass(frozen=True)
class Bound(FilterExpr):
    var: str


# ---------------------------------------------------------------------------
# Graph-pattern algebra nodes
# ---------------------------------------------------------------------------

class Node:
    pass


@dataclass
class BGP(Node):
    patterns: List[TriplePattern]

    def vars(self) -> Tuple[str, ...]:
        seen: List[str] = []
        for tp in self.patterns:
            for v in tp_vars(tp):
                if v not in seen:
                    seen.append(v)
        return tuple(seen)


@dataclass
class JoinPair(Node):
    """Conjunction (join) of two non-BGP subpatterns."""
    left: Node
    right: Node


@dataclass
class Filter(Node):
    expr: FilterExpr
    child: Node


@dataclass
class LeftJoin(Node):        # OPTIONAL
    left: Node
    right: Node
    expr: Optional[FilterExpr] = None


@dataclass
class UnionOp(Node):
    left: Node
    right: Node


@dataclass
class Distinct(Node):
    child: Node


@dataclass
class OrderBy(Node):
    child: Node
    keys: List[Tuple[str, bool]]  # (var, ascending)


@dataclass
class Slice(Node):
    child: Node
    offset: int = 0
    limit: Optional[int] = None


@dataclass
class Project(Node):
    child: Node
    vars: Optional[List[str]]  # None = SELECT *


@dataclass
class Query:
    root: Node
    select: Optional[List[str]] = None   # None = *
    distinct: bool = False

"""Query templates: the unit of plan caching and constant re-binding.

A served SPARQL workload repeats a small set of *templates* with varying
entity constants (WatDiv's ``%x%`` placeholders, S2RDF §7).  Everything
expensive about a query — parsing, Algorithm-1 table selection,
Algorithm-4 join ordering, XLA compilation of the static-shape program —
depends only on the template: bound entity constants influence nothing but
the scan selection *values*.  This module makes that observation
executable:

* ``template_signature`` normalizes entity constants out of the query
  text (schema terms — predicates, class names — stay, because they
  determine table selection and therefore plan identity).
* ``QueryTemplate`` parses the query ONCE with each constant replaced by
  a unique placeholder id, so the algebra tree / compiled plan can be
  re-bound to new constants by a pure id substitution — no re-parse, no
  re-compile.
* ``ConstantBinding`` maps placeholder ids to real dictionary ids for one
  instantiation.  A constant absent from the dictionary marks the binding
  ``missing`` and is bound as ``MISSING_TERM``, which matches no triple.
  Only where it fills a slot of a *required* triple pattern is the whole
  answer empty (``short_circuit``: the statistics-only empty answer,
  S2RDF §6); under OPTIONAL, in one UNION branch or in a FILTER the
  query runs with it.

Placeholders get ids in a reserved negative band so they can never
collide with dictionary ids (dense ``[0, n)``), ``UNBOUND`` (-1) or
``MISSING_TERM`` (-2).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict, FrozenSet, Iterator, List, Optional, Tuple

from repro_torch.core.algebra import (
    BGP, Distinct, Filter, JoinPair, LeftJoin, Node, OrderBy, Project,
    Query, Slice, TriplePattern, UnionOp, is_var, tp_vars,
)
from repro_torch.core.compiler import Plan, ScanStep
from repro_torch.core.modifiers import substitute_filter, substitute_term
from repro_torch.core.sparql import MISSING_TERM, _Parser

__all__ = [
    "template_signature", "extract_constants", "ConstantBinding",
    "QueryTemplate", "substitute_query", "rebind_plan", "node_vars",
    "required_patterns", "PLACEHOLDER_BASE",
]

# Entity constants: IRIs, literals, and prefixed names whose local part
# contains a digit (instance ids like wsdbm:User3).  Schema terms —
# predicates, class names without instance suffixes — are left intact:
# they determine table selection, so they are part of the plan identity.
# The pname alternative must consume the WHOLE token (trailing chars after
# the digit included), otherwise slot substitution would split a name like
# wsdbm:User3a mid-token and corrupt the template text.
_CONST_RE = re.compile(
    r"(?:<[^>]*>|\"(?:[^\"\\]|\\.)*\""
    r"|(?<![?\w])[A-Za-z_][\w\-]*:[\w\-\.]*\d[\w\-\.]*)")

# PREFIX declarations carry IRIs that are namespace bindings, not entity
# constants: they must survive both signatures and template substitution.
_PROLOGUE_RE = re.compile(
    r"^(?:\s*PREFIX\s+[A-Za-z_][\w\-]*:\s*<[^>]*>)*\s*", re.IGNORECASE)

# Reserved id band for template placeholders: slot i gets id BASE - i.
PLACEHOLDER_BASE = -1000


def _normalize(qtext: str) -> str:
    return " ".join(qtext.split())


def _split_prologue(norm: str) -> Tuple[str, str]:
    m = _PROLOGUE_RE.match(norm)
    return norm[: m.end()], norm[m.end():]


def template_signature(qtext: str) -> str:
    """Normalize bound entity terms so template instantiations share a
    plan slot.  The prologue is kept verbatim (two queries binding the
    same prefix to different IRIs must not share a template)."""
    prologue, body = _split_prologue(_normalize(qtext))
    return prologue + _CONST_RE.sub("¤", body)


def extract_constants(qtext: str) -> List[str]:
    """Entity constants of one instantiation, in textual order — the
    positional counterpart of the ¤ slots in the signature."""
    _, body = _split_prologue(_normalize(qtext))
    return _CONST_RE.findall(body)


class _TemplateDictionary:
    """Dictionary view that resolves ``¤<i>`` tokens to placeholder ids."""

    def __init__(self, base) -> None:
        self._base = base

    def id_of(self, term: str) -> Optional[int]:
        if term.startswith("¤"):
            try:
                return PLACEHOLDER_BASE - int(term[1:])
            except ValueError:
                pass
        return self._base.id_of(term)


def _resolve_name(term: str, dictionary, prefixes: Dict[str, str]) -> Optional[int]:
    """Resolve a surface term exactly the way the parser would."""
    tid = dictionary.id_of(term)
    if tid is not None:
        return tid
    if ":" in term and not term.startswith('"'):
        pfx, local = term.split(":", 1)
        if pfx in prefixes:
            return dictionary.id_of(prefixes[pfx] + local)
    return None


def resolve_constant(text: str, dictionary,
                     prefixes: Dict[str, str]) -> Optional[int]:
    if text.startswith("<") and text.endswith(">"):
        return _resolve_name(text[1:-1], dictionary, prefixes)
    return _resolve_name(text, dictionary, prefixes)


@dataclass(frozen=True)
class ConstantBinding:
    """Placeholder-id → dictionary-id mapping for one instantiation."""

    mapping: Dict[int, int]
    missing: bool = False   # some constant absent from the dictionary
    # ... and one of them fills a slot of a required triple pattern
    # (:func:`required_patterns`): no solution exists, so the answer is
    # empty without running
    short_circuit: bool = False

    @property
    def empty(self) -> bool:
        return not self.mapping


_EMPTY_BINDING = ConstantBinding(mapping={}, missing=False)


class QueryTemplate:
    """A parsed query with entity constants lifted into rebindable slots.

    ``query`` holds placeholder ids (negative band) wherever the source
    text had an entity constant; ``binding_for(qtext)`` produces the
    substitution for a concrete instantiation of the same signature.
    """

    def __init__(self, qtext: str, dictionary) -> None:
        norm = _normalize(qtext)
        prologue, body = _split_prologue(norm)
        self.signature = prologue + _CONST_RE.sub("¤", body)
        self.dictionary = dictionary

        n = 0

        def _slot(m: re.Match) -> str:
            nonlocal n
            token = f"<¤{n}>"
            n += 1
            return token

        template_text = prologue + _CONST_RE.sub(_slot, body)
        parser = _Parser(template_text, _TemplateDictionary(dictionary))
        self.query: Query = parser.parse_query()
        self.prefixes: Dict[str, str] = parser.prefixes
        self.slot_ids: Tuple[int, ...] = tuple(
            PLACEHOLDER_BASE - i for i in range(n))
        # A placeholder in predicate position would poison table selection
        # (predicates are plan identity); such templates are not reusable.
        slot_set = set(self.slot_ids)
        self.rebindable = not any(
            (not is_var(tp.p)) and int(tp.p) in slot_set
            for tp in iter_patterns(self.query.root))
        self.required_slots: FrozenSet[int] = frozenset(
            int(t) for tp in required_patterns(self.query.root)
            for t in (tp.s, tp.p, tp.o)
            if not is_var(t) and int(t) in slot_set)

    @classmethod
    def concrete(cls, qtext: str, dictionary) -> "QueryTemplate":
        """A degenerate, slot-free template: the query parsed as-is.
        Used for queries whose template form is not rebindable."""
        self = cls.__new__(cls)
        self.signature = template_signature(qtext)
        self.dictionary = dictionary
        parser = _Parser(_normalize(qtext), dictionary)
        self.query = parser.parse_query()
        self.prefixes = parser.prefixes
        self.slot_ids = ()
        self.required_slots = frozenset()
        self.rebindable = False
        return self

    @property
    def n_slots(self) -> int:
        return len(self.slot_ids)

    def binding_for(self, qtext: str) -> ConstantBinding:
        if not self.slot_ids:
            return _EMPTY_BINDING
        consts = extract_constants(qtext)
        if len(consts) != len(self.slot_ids):
            raise ValueError(
                f"query does not match template: {len(consts)} constants "
                f"vs {len(self.slot_ids)} slots")
        mapping: Dict[int, int] = {}
        missing = short_circuit = False
        for slot, text in zip(self.slot_ids, consts):
            tid = resolve_constant(text, self.dictionary, self.prefixes)
            if tid is None:
                tid = MISSING_TERM
                missing = True
                short_circuit |= slot in self.required_slots
            mapping[slot] = tid
        return ConstantBinding(mapping=mapping, missing=missing,
                               short_circuit=short_circuit)


# ---------------------------------------------------------------------------
# Substitution: pure id rewrites over trees and plans
# ---------------------------------------------------------------------------

# The id-rewrite primitives live in repro_torch.core.modifiers (engine/ may
# import core/, not vice versa); these are the historical local names.
_sub_term = substitute_term
_sub_expr = substitute_filter


def _sub_tp(tp: TriplePattern, mapping: Dict[int, int]) -> TriplePattern:
    return TriplePattern(_sub_term(tp.s, mapping), _sub_term(tp.p, mapping),
                         _sub_term(tp.o, mapping))


def _sub_node(node: Node, mapping: Dict[int, int]) -> Node:
    if isinstance(node, BGP):
        return BGP([_sub_tp(tp, mapping) for tp in node.patterns])
    if isinstance(node, JoinPair):
        return JoinPair(_sub_node(node.left, mapping),
                        _sub_node(node.right, mapping))
    if isinstance(node, Filter):
        return Filter(_sub_expr(node.expr, mapping),
                      _sub_node(node.child, mapping))
    if isinstance(node, LeftJoin):
        return LeftJoin(_sub_node(node.left, mapping),
                        _sub_node(node.right, mapping),
                        None if node.expr is None else
                        _sub_expr(node.expr, mapping))
    if isinstance(node, UnionOp):
        return UnionOp(_sub_node(node.left, mapping),
                       _sub_node(node.right, mapping))
    if isinstance(node, Distinct):
        return Distinct(_sub_node(node.child, mapping))
    if isinstance(node, OrderBy):
        return OrderBy(_sub_node(node.child, mapping), node.keys)
    if isinstance(node, Slice):
        return Slice(_sub_node(node.child, mapping), node.offset, node.limit)
    if isinstance(node, Project):
        return Project(_sub_node(node.child, mapping), node.vars)
    raise TypeError(f"unknown node {type(node)}")


def substitute_query(query: Query, mapping: Dict[int, int]) -> Query:
    """Clone ``query`` with every constant id rewritten through ``mapping``."""
    if not mapping:
        return query
    return Query(root=_sub_node(query.root, mapping), select=query.select,
                 distinct=query.distinct)


def rebind_plan(plan: Plan, mapping: Dict[int, int]) -> Plan:
    """Re-bind scan constants of a compiled plan.  Table selection, join
    order and statistics are template-invariant, so only the triple
    patterns change."""
    if not mapping or plan.empty:
        return plan
    steps = [ScanStep(_sub_tp(s.tp, mapping), s.kind, s.p2, s.sf, s.size,
                      s.uses_tt) for s in plan.steps]
    return Plan(steps=steps, empty=plan.empty, vars=plan.vars,
                planner=plan.planner)


def iter_patterns(node: Node) -> Iterator[TriplePattern]:
    if isinstance(node, BGP):
        yield from node.patterns
    elif isinstance(node, (JoinPair, LeftJoin, UnionOp)):
        yield from iter_patterns(node.left)
        yield from iter_patterns(node.right)
    elif isinstance(node, (Filter, Distinct, OrderBy, Slice, Project)):
        yield from iter_patterns(node.child)


def required_patterns(node: Node) -> Iterator[TriplePattern]:
    """The triple patterns every solution must match: those of the
    top-level group, through joins of groups, filters, the left side of
    an OPTIONAL and the solution modifiers — never an OPTIONAL's right
    side or a UNION branch (a FILTER holds no pattern)."""
    if isinstance(node, BGP):
        yield from node.patterns
    elif isinstance(node, JoinPair):
        yield from required_patterns(node.left)
        yield from required_patterns(node.right)
    elif isinstance(node, LeftJoin):
        yield from required_patterns(node.left)
    elif isinstance(node, (Filter, Distinct, OrderBy, Slice, Project)):
        yield from required_patterns(node.child)


def node_vars(node: Node) -> Tuple[str, ...]:
    """Variables produced by a pattern tree, in first-seen order."""
    seen: List[str] = []
    for tp in iter_patterns(node):
        for v in tp_vars(tp):
            if v not in seen:
                seen.append(v)
    return tuple(seen)

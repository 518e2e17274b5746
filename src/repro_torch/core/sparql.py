"""SPARQL subset parser (the paper uses Jena ARQ; we parse natively).

Supported grammar (SPARQL 1.0 core, matching §6):

    query      := prologue? SELECT 'DISTINCT'? ('*' | var+) WHERE? group
                  ('ORDER' 'BY' orderCond+)? ('LIMIT' int)? ('OFFSET' int)?
    prologue   := ('PREFIX' pname ':' '<' iri '>')*
    group      := '{' (triplesBlock | 'FILTER' '(' expr ')' |
                       'OPTIONAL' group | group ('UNION' group)* | group)* '}'
    triples    := term term term ('.' | ';' term term)* — ';' predicate lists
    term       := var | '<iri>' | pname:local | literal | number
    expr       := or-expr over comparisons, '&&', '||', '!', 'BOUND(?v)'

Terms are resolved against the graph :class:`~repro_torch.rdf.Dictionary`:
prefixed names are looked up both raw (``wsdbm:User5``) and expanded via
the declared prefixes.  A bound term absent from the dictionary makes the
enclosing BGP provably empty, which the compiler exploits (≡ S2RDF's
statistics-only empty answers).
"""

from __future__ import annotations

import re
from typing import Dict, List, Optional, Tuple, Union

from repro_torch.core.algebra import (
    BGP, BoolOp, Bound, Cmp, Distinct, Filter, FilterExpr, JoinPair, LeftJoin,
    Node, NotExpr, OrderBy, Project, Query, Slice, TriplePattern, UnionOp,
)
from repro_torch.rdf.dictionary import Dictionary

__all__ = ["parse_sparql", "SparqlError", "MISSING_TERM"]

MISSING_TERM = -2  # bound term not present in the dictionary


class SparqlError(ValueError):
    pass


_TOKEN_RE = re.compile(
    r"""
      (?P<ws>\s+|\#[^\n]*)
    # No whitespace inside an IRI: '?a < 25 && ?b > 5' tokenizes as
    # comparisons.  A space-free '?a<25&&?b>5' still lexes '<25&&?b>' as
    # one IRI token (and then errors) — that matches the SPARQL IRIREF
    # grammar, which real lexers resolve the same way: put spaces around
    # '<' in filters.
    | (?P<iri><[^>\s]*>)
    | (?P<str>"(?:[^"\\]|\\.)*")
    | (?P<num>[+-]?\d+(?:\.\d+)?)
    | (?P<var>\?[A-Za-z_][A-Za-z0-9_]*)
    | (?P<pname>[A-Za-z_][A-Za-z0-9_\-]*:[A-Za-z0-9_\-\.]*)
    | (?P<kw>[A-Za-z_][A-Za-z0-9_]*)
    | (?P<op>&&|\|\||!=|<=|>=|[{}().;,*=<>!])
    """,
    re.VERBOSE,
)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            raise SparqlError(f"cannot tokenize at: {text[pos:pos+40]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind == "ws":
            continue
        toks.append((kind, m.group()))
    toks.append(("eof", ""))
    return toks


class _Parser:
    def __init__(self, text: str, dictionary: Dictionary,
                 prefixes: Optional[Dict[str, str]] = None):
        self.toks = _tokenize(text)
        self.i = 0
        self.d = dictionary
        self.prefixes: Dict[str, str] = dict(prefixes or {})

    # -- token helpers --------------------------------------------------------
    def peek(self, k: int = 0) -> Tuple[str, str]:
        return self.toks[min(self.i + k, len(self.toks) - 1)]

    def next(self) -> Tuple[str, str]:
        t = self.toks[self.i]
        self.i += 1
        return t

    def accept(self, val: str) -> bool:
        if self.peek()[1].upper() == val.upper() and self.peek()[0] in ("kw", "op"):
            self.i += 1
            return True
        return False

    def expect(self, val: str) -> None:
        if not self.accept(val):
            raise SparqlError(f"expected {val!r}, got {self.peek()[1]!r}")

    # -- term resolution -------------------------------------------------------
    def _resolve(self, term: str) -> int:
        tid = self.d.id_of(term)
        if tid is not None:
            return tid
        if ":" in term and not term.startswith('"'):
            pfx, local = term.split(":", 1)
            if pfx in self.prefixes:
                expanded = self.prefixes[pfx] + local
                tid = self.d.id_of(expanded)
                if tid is not None:
                    return tid
        return MISSING_TERM

    def parse_term(self) -> Union[str, int]:
        kind, val = self.next()
        if kind == "var":
            return val
        if kind == "iri":
            return self._resolve(val[1:-1])
        if kind == "pname":
            return self._resolve(val)
        if kind == "str":
            return self._resolve(val)
        if kind == "num":
            canon = f'"{val}"'
            tid = self._resolve(canon)
            if tid == MISSING_TERM and "." not in val:
                tid = self._resolve(f'"{int(val)}"')
            return tid
        if kind == "kw":
            if val == "a":  # rdf:type shorthand
                return self._resolve("rdf:type")
            return self._resolve(val)  # bare name (simplified notation)
        raise SparqlError(f"unexpected term token {val!r}")

    # -- grammar ----------------------------------------------------------------
    def parse_query(self) -> Query:
        while self.accept("PREFIX"):
            kind, val = self.next()
            # a PREFIX name is exactly "name:" — a pname token whose local
            # part is empty; anything else (missing colon, stray local
            # part) is a syntax error, not a silently-garbled prefix
            if kind != "pname" or not val.endswith(":"):
                raise SparqlError(
                    f"bad PREFIX name {val!r} (expected 'name:')")
            pfx = val[:-1]
            kind2, iri = self.next()
            if kind2 != "iri":
                raise SparqlError(f"bad PREFIX iri {iri!r}")
            self.prefixes[pfx] = iri[1:-1]

        self.expect("SELECT")
        distinct = self.accept("DISTINCT")
        select: Optional[List[str]] = None
        if self.accept("*"):
            select = None
        else:
            select = []
            while self.peek()[0] == "var":
                select.append(self.next()[1])
            if not select:
                raise SparqlError("empty SELECT clause")
        self.accept("WHERE")
        root: Node = self.parse_group()

        if self.accept("ORDER"):
            self.expect("BY")
            keys: List[Tuple[str, bool]] = []
            while True:
                if self.accept("ASC"):
                    self.expect("(")
                    keys.append((self.next()[1], True))
                    self.expect(")")
                elif self.accept("DESC"):
                    self.expect("(")
                    keys.append((self.next()[1], False))
                    self.expect(")")
                elif self.peek()[0] == "var":
                    keys.append((self.next()[1], True))
                else:
                    break
            root = OrderBy(root, keys)

        offset, limit = 0, None
        if self.accept("LIMIT"):
            limit = int(self.next()[1])
            if self.accept("OFFSET"):
                offset = int(self.next()[1])
        elif self.accept("OFFSET"):
            offset = int(self.next()[1])
            if self.accept("LIMIT"):
                limit = int(self.next()[1])
        if limit is not None or offset:
            root = Slice(root, offset, limit)

        if self.peek()[0] != "eof":
            raise SparqlError(f"trailing tokens at {self.peek()[1]!r}")
        return Query(root=root, select=select, distinct=distinct)

    def parse_group(self) -> Node:
        self.expect("{")
        node: Optional[Node] = None
        patterns: List[TriplePattern] = []
        filters: List[FilterExpr] = []
        optionals: List[Tuple[Node, Optional[FilterExpr]]] = []

        def flush() -> Optional[Node]:
            nonlocal patterns
            out: Optional[Node] = BGP(patterns) if patterns else None
            patterns = []
            return out

        def merge(a: Optional[Node], b: Optional[Node]) -> Optional[Node]:
            if a is None:
                return b
            if b is None:
                return a
            if isinstance(a, BGP) and isinstance(b, BGP):
                return BGP(a.patterns + b.patterns)
            # generic conjunction = join of two sub-results
            return JoinPair(a, b)

        while not self.accept("}"):
            tok_kind, tok_val = self.peek()
            up = tok_val.upper()
            if up == "FILTER":
                self.next()
                filters.append(self.parse_expr_parens())
            elif up == "OPTIONAL":
                self.next()
                right = self.parse_group()
                expr = None
                if isinstance(right, Filter):
                    right, expr = right.child, right.expr
                optionals.append((right, expr))
            elif tok_val == "{":
                sub = self.parse_group()
                while self.accept("UNION"):
                    sub2 = self.parse_group()
                    sub = UnionOp(sub, sub2)
                node = merge(merge(node, flush()), sub)
            else:
                patterns.append(self.parse_triples_same_subject())
                # '.' separators / ';' predicate lists handled inside
                while self.accept(";"):
                    if self.peek()[1] in (".", "}"):
                        break               # trailing ';' before '.' or '}'
                    prev = patterns[-1]
                    p = self.parse_term()
                    o = self.parse_term()
                    patterns.append(TriplePattern(prev.s, p, o))
                self.accept(".")

        node = merge(node, flush())
        if node is None:
            node = BGP([])
        for right, expr in optionals:
            node = LeftJoin(node, right, expr)
        for f in filters:
            node = Filter(f, node)
        return node

    def parse_triples_same_subject(self) -> TriplePattern:
        s = self.parse_term()
        p = self.parse_term()
        o = self.parse_term()
        return TriplePattern(s, p, o)

    # -- filter expressions -------------------------------------------------------
    def parse_expr_parens(self) -> FilterExpr:
        self.expect("(")
        e = self.parse_or()
        self.expect(")")
        return e

    def parse_or(self) -> FilterExpr:
        args = [self.parse_and()]
        while self.accept("||"):
            args.append(self.parse_and())
        return args[0] if len(args) == 1 else BoolOp("||", tuple(args))

    def parse_and(self) -> FilterExpr:
        args = [self.parse_unary()]
        while self.accept("&&"):
            args.append(self.parse_unary())
        return args[0] if len(args) == 1 else BoolOp("&&", tuple(args))

    def parse_unary(self) -> FilterExpr:
        if self.accept("!"):
            return NotExpr(self.parse_unary())
        if self.peek()[1] == "(":
            return self.parse_expr_parens()
        if self.peek()[1].upper() == "BOUND":
            self.next()
            self.expect("(")
            var = self.next()[1]
            self.expect(")")
            return Bound(var)
        lhs = self.parse_operand()
        kind, op = self.next()
        if op not in ("=", "!=", "<", "<=", ">", ">="):
            raise SparqlError(f"bad comparison operator {op!r}")
        rhs = self.parse_operand()
        return Cmp(op, lhs, rhs)

    def parse_operand(self) -> Union[str, int, float]:
        """Filter operand: var, term, or *numeric* constant (kept as float
        so comparisons work even for values outside the literal pool)."""
        if self.peek()[0] == "num":
            return float(self.next()[1])
        return self.parse_term()


def parse_sparql(text: str, dictionary: Dictionary,
                 prefixes: Optional[Dict[str, str]] = None) -> Query:
    return _Parser(text, dictionary, prefixes).parse_query()

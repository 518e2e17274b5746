"""The plain reference: SPARQL answers computed with NumPy from the
generated triples.

It reads the same encoded triples and term list that the program is
given, and nothing the program made.  It parses the query text itself
and evaluates the fragment the benchmark's query sets use: a group of
triple patterns (constants or variables in any position), ``FILTER`` of
one variable against a number, and ``OPTIONAL { ... }`` groups, under
multiset semantics (paper §2.1; SPARQL 1.1 §18).  Joins are sort-merge
joins over whole columns; an OPTIONAL keeps every left row that finds no
partner, with its new variables unbound (``UNBOUND``, -1).

An answer's canonical form (:func:`canonical`) is its rows, columns in
variable-name order, sorted: two answers are the same multiset exactly
when their canonical forms are equal.
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

UNBOUND = -1

_TOKEN = re.compile(r'\{|\}|\.(?=\s|$|\})|FILTER\s*\([^)]*\)|"[^"]*"|[^\s{}]+')
_FILTER = re.compile(r'FILTER\s*\(\s*(\?\w+)\s*(<=|>=|!=|=|<|>)\s*'
                     r'(-?[0-9.]+)\s*\)$')


@dataclass
class Group:
    patterns: List[Tuple[str, str, str]] = field(default_factory=list)
    filters: List[Tuple[str, str, float]] = field(default_factory=list)
    optionals: List["Group"] = field(default_factory=list)


def parse(qtext: str) -> Group:
    """The WHERE group of ``SELECT * WHERE { ... }``."""
    head, _, rest = qtext.partition("{")
    if head.split() != ["SELECT", "*", "WHERE"]:
        raise ValueError(f"unsupported query head: {head.strip()!r}")
    tokens = _TOKEN.findall("{" + rest)
    group, pos = _group(tokens, 0)
    if pos != len(tokens):
        raise ValueError("text after the WHERE group")
    return group


def _group(tokens: List[str], pos: int) -> Tuple[Group, int]:
    if tokens[pos] != "{":
        raise ValueError("expected '{'")
    pos += 1
    g, terms = Group(), []
    while True:
        tok = tokens[pos]
        if tok in (".", "}"):
            if terms:
                if len(terms) != 3:
                    raise ValueError(f"not a triple pattern: {terms}")
                g.patterns.append(tuple(terms))
                terms = []
            pos += 1
            if tok == "}":
                return g, pos
        elif tok.startswith("FILTER"):
            m = _FILTER.match(tok)
            if m is None:
                raise ValueError(f"unsupported filter: {tok}")
            g.filters.append((m.group(1), m.group(2), float(m.group(3))))
            pos += 1
        elif tok == "OPTIONAL":
            sub, pos = _group(tokens, pos + 1)
            g.optionals.append(sub)
        else:
            terms.append(tok)
            pos += 1


def numeric_values(terms: Sequence[str]) -> np.ndarray:
    """float64 value of every term that is a number, bare or quoted;
    NaN for every other term."""
    out = np.full(len(terms), np.nan)
    for i, t in enumerate(terms):
        s = t[1:t.index('"', 1)] if t.startswith('"') and '"' in t[1:] else t
        if s[:1].isdigit() or s[:1] in "-+.":
            try:
                out[i] = float(s)
            except ValueError:
                pass
    return out


class Relation:
    """A bag of solutions: ``vars`` names the columns of int32 ``data``."""

    def __init__(self, vars_: Sequence[str], data: np.ndarray):
        self.vars = list(vars_)
        self.data = np.asarray(data, dtype=np.int32).reshape(-1, len(self.vars))

    def __len__(self) -> int:
        return len(self.data)

    def col(self, v: str) -> np.ndarray:
        return self.data[:, self.vars.index(v)]


def _keys(rel: Relation, shared: List[str], other: Relation
          ) -> Tuple[np.ndarray, np.ndarray]:
    """Join keys of both sides over ``shared``, as int64, equal exactly
    when the shared columns are."""
    if len(shared) == 1:
        return rel.col(shared[0]).astype(np.int64), \
            other.col(shared[0]).astype(np.int64)
    both = np.concatenate([
        np.stack([r.col(v) for v in shared], axis=1) for r in (rel, other)])
    _, inv = np.unique(both, axis=0, return_inverse=True)
    inv = inv.reshape(-1).astype(np.int64)
    return inv[:len(rel)], inv[len(rel):]


def join(left: Relation, right: Relation, optional: bool = False) -> Relation:
    """``left ⋈ right`` on their shared variables (a left outer join when
    ``optional``); a cross product when they share none."""
    shared = [v for v in left.vars if v in right.vars]
    new = [v for v in right.vars if v not in left.vars]
    out_vars = left.vars + new
    if shared:
        if optional and any((left.col(v) == UNBOUND).any() for v in shared):
            raise ValueError("OPTIONAL over a variable the left side "
                             "leaves unbound is outside the fragment")
        kl, kr = _keys(left, shared, right)
        order = np.argsort(kr, kind="stable")
        krs = kr[order]
        lo = np.searchsorted(krs, kl, "left")
        cnt = np.searchsorted(krs, kl, "right") - lo
    else:
        order = np.arange(len(right))
        lo = np.zeros(len(left), dtype=np.int64)
        cnt = np.full(len(left), len(right), dtype=np.int64)
    keep = np.maximum(cnt, 1) if optional else cnt
    li = np.repeat(np.arange(len(left)), keep)
    total = int(keep.sum())
    # position of each output row within its left row's run of partners
    offs = np.arange(total) - np.repeat(np.cumsum(keep) - keep, keep)
    if len(right):
        pos = np.minimum(np.repeat(lo, keep) + offs, len(right) - 1)
        ri = order[pos]
    else:
        ri = np.zeros(total, dtype=np.int64)
    new_cols = [right.col(v)[ri] if len(right) else
                np.full(total, UNBOUND, dtype=np.int32) for v in new]
    if optional and new:
        miss = np.repeat(cnt == 0, keep)
        for c in new_cols:
            c[miss] = UNBOUND
    data = np.concatenate([left.data[li]] + [c[:, None] for c in new_cols],
                          axis=1)
    return Relation(out_vars, data)


class Store:
    """The triples split by predicate, each predicate's ``(s, o)`` pairs
    sorted by subject or by object on first use."""

    def __init__(self, tt: np.ndarray, terms: Sequence[str]):
        self.terms = list(terms)
        self.tt = np.asarray(tt)
        self._term_id: Optional[Dict[str, int]] = None
        self._values: Dict[int, float] = {}
        p = self.tt[:, 1]
        order = np.argsort(p, kind="stable")
        srt = self.tt[order]
        preds, starts = np.unique(srt[:, 1], return_index=True)
        ends = list(starts[1:]) + [len(srt)]
        self.by_p = {int(q): srt[a:b][:, [0, 2]] for q, a, b
                     in zip(preds, starts, ends)}
        self._sorted: Dict[Tuple[int, int], np.ndarray] = {}

    def term(self, text: str) -> Optional[int]:
        if self._term_id is None:
            self._term_id = {t: i for i, t in enumerate(self.terms)}
        return self._term_id.get(text)

    def values(self, ids: np.ndarray) -> np.ndarray:
        """float64 value of each id's term (NaN where it is no number, or
        for ``UNBOUND``)."""
        uniq = np.unique(ids)
        todo = [int(i) for i in uniq if int(i) not in self._values]
        if todo:
            vals = numeric_values([self.terms[i] if i >= 0 else "" for i in todo])
            self._values.update(zip(todo, vals.tolist()))
        table = np.array([self._values[int(i)] for i in uniq])
        return table[np.searchsorted(uniq, ids)] if len(ids) else \
            np.zeros(0)

    def pairs(self, p: int, pos: int) -> np.ndarray:
        """Predicate ``p``'s ``(s, o)`` pairs sorted by column ``pos``."""
        key = (p, pos)
        if key not in self._sorted:
            so = self.by_p.get(p, np.zeros((0, 2), dtype=self.tt.dtype))
            self._sorted[key] = so[np.argsort(so[:, pos], kind="stable")]
        return self._sorted[key]

    def _consts(self, pattern) -> Optional[List[Optional[int]]]:
        """Each position's constant id (None for a variable); None when a
        constant is not a term of the graph (no solution)."""
        out = []
        for t in pattern:
            if t.startswith("?"):
                out.append(None)
            else:
                c = self.term(t)
                if c is None:
                    return None
                out.append(c)
        return out

    def _rows(self, pattern) -> np.ndarray:
        """``(n, 3)`` triples that match the pattern's constants."""
        consts = self._consts(pattern)
        if consts is None:
            return np.zeros((0, 3), dtype=np.int64)
        cs, cp, co = consts
        if cp is None:
            rows = self.tt.astype(np.int64)
        else:
            pos = 0 if cs is not None else 1 if co is not None else None
            if pos is None:
                so = self.by_p.get(cp, np.zeros((0, 2), dtype=np.int64))
            else:
                so = self.pairs(cp, pos)
                c = cs if pos == 0 else co
                a, b = np.searchsorted(so[:, pos], [c, c + 1])
                so = so[a:b]
            rows = np.stack([so[:, 0], np.full(len(so), cp), so[:, 1]],
                            axis=1).astype(np.int64)
        keep = np.ones(len(rows), dtype=bool)
        for i, c in enumerate(consts):
            if c is not None:
                keep &= rows[:, i] == c
        return rows[keep]

    def scan(self, pattern: Tuple[str, str, str]) -> Relation:
        """The solutions of one triple pattern."""
        rows = self._rows(pattern)
        keep = np.ones(len(rows), dtype=bool)
        first_pos: Dict[str, int] = {}
        for i, t in enumerate(pattern):
            if t.startswith("?"):
                if t in first_pos:       # a repeated variable binds one value
                    keep &= rows[:, i] == rows[:, first_pos[t]]
                else:
                    first_pos[t] = i
        rows = rows[keep]
        return Relation(list(first_pos), rows[:, list(first_pos.values())])

    def _size(self, pattern) -> int:
        consts = self._consts(pattern)
        if consts is None:
            return 0
        cs, cp, co = consts
        if cp is None:
            return len(self.tt)
        if cs is None and co is None:
            return len(self.by_p.get(cp, ()))
        pos, c = (0, cs) if cs is not None else (1, co)
        a, b = np.searchsorted(self.pairs(cp, pos)[:, pos], [c, c + 1])
        return int(b - a)

    def _extend(self, left: Relation, pattern) -> Relation:
        """``left ⋈ pattern``, probing the predicate's pairs sorted on the
        first subject or object variable the two share."""
        s, p, o = pattern
        consts = self._consts(pattern)
        at = next((i for i in (0, 2) if pattern[i] in left.vars), None)
        if consts is None or consts[1] is None or at is None:
            return join(left, self.scan(pattern))
        pos = 0 if at == 0 else 1
        so = self.pairs(consts[1], pos)
        keys = left.col(pattern[at]).astype(np.int64)
        lo = np.searchsorted(so[:, pos], keys, "left")
        cnt = np.searchsorted(so[:, pos], keys, "right") - lo
        li = np.repeat(np.arange(len(left)), cnt)
        offs = np.arange(len(li)) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        pairs = so[np.repeat(lo, cnt) + offs]
        other, oi = (o, 1) if at == 0 else (s, 0)
        vals = pairs[:, oi]
        keep = np.ones(len(li), dtype=bool)
        new = []
        if not other.startswith("?"):
            keep &= vals == consts[2 if at == 0 else 0]
        elif other == pattern[at]:
            keep &= vals == pairs[:, pos]
        elif other in left.vars:
            keep &= vals == left.col(other)[li]
        else:
            new = [other]
        li, vals = li[keep], vals[keep]
        data = left.data[li]
        if new:
            data = np.concatenate([data, vals[:, None].astype(np.int32)],
                                  axis=1)
        return Relation(left.vars + new, data)

    def evaluate(self, group: Group) -> Relation:
        """The solutions of a group: its patterns joined (the smallest
        first, then always the smallest pattern connected to what is
        joined, where there is one), then each OPTIONAL group
        left-joined, then the filters."""
        pats = list(group.patterns)
        if not pats:
            out = Relation([], np.zeros((1, 0)))
        else:
            sizes = [self._size(tp) for tp in pats]
            i = int(np.argmin(sizes))
            out = self.scan(pats.pop(i))
            sizes.pop(i)
            while pats:
                linked = [j for j, tp in enumerate(pats)
                          if {t for t in tp if t.startswith("?")} &
                          set(out.vars)]
                cand = linked or list(range(len(pats)))
                j = min(cand, key=lambda k: sizes[k])
                tp = pats.pop(j)
                sizes.pop(j)
                out = self._extend(out, tp) if linked else \
                    join(out, self.scan(tp))
        for sub in group.optionals:
            out = join(out, self.evaluate(sub), optional=True)
        for var, op, num in group.filters:
            if var not in out.vars:
                out = Relation(out.vars, out.data[:0])
                continue
            vals = self.values(out.col(var))
            keep = {"<": vals < num, ">": vals > num, "<=": vals <= num,
                    ">=": vals >= num, "=": vals == num,
                    "!=": (vals != num) & ~np.isnan(vals)}[op]
            out = Relation(out.vars, out.data[keep])
        return out

    def answer(self, qtext: str) -> Relation:
        return self.evaluate(parse(qtext))


def canonical(vars_: Sequence[str], data: np.ndarray, n_terms: int
              ) -> Tuple[Tuple[str, ...], np.ndarray]:
    """``(sorted variables, sorted packed rows)``: equal for two answers
    exactly when they hold the same multiset of solutions.  Ids (and
    ``UNBOUND``) are shifted by one and packed ``21``-bit or ``31``-bit
    fields to an ``int64`` word, then the words are sorted row-wise."""
    names = tuple(sorted(vars_))
    data = np.asarray(data)
    cols = [data[:, list(vars_).index(v)].astype(np.int64) + 1 for v in names]
    bits = 21 if n_terms + 1 < 2 ** 21 else 31
    per = 63 // bits
    words = []
    for i in range(0, len(cols), per):
        w = np.zeros(len(data), dtype=np.int64)
        for c in cols[i:i + per]:
            w = (w << bits) | c
        words.append(w)
    if not words:
        return names, np.zeros((len(data), 0), dtype=np.int64)
    if len(words) == 1:
        return names, np.sort(words[0])[:, None]
    mat = np.stack(words, axis=1)
    return names, mat[np.lexsort(words[::-1])]


def same_answer(got: Tuple[Tuple[str, ...], np.ndarray],
                want: Tuple[Tuple[str, ...], np.ndarray]) -> bool:
    return got[0] == want[0] and got[1].shape == want[1].shape and \
        bool(np.array_equal(got[1], want[1]))

"""Dictionary encoding of RDF terms.

RDF terms (IRIs, literals) are strings; TPUs operate on dense integer
tensors.  Every term in a graph is assigned a dense ``int32`` id.  This is
the explicit analogue of what the paper gets implicitly from Parquet's
dictionary + run-length encoding (§2.2): after encoding, every relational
operation in the engine touches only ``int32`` columns.

Numeric literals additionally get a parallel ``float64`` value table so that
SPARQL FILTER comparisons (``?price < 500``) can be evaluated as a gather
from a dense array instead of string parsing at query time.

Ids are dense in ``[0, n_terms)``.  ``UNBOUND = -1`` is reserved as the
sentinel for unbound variables in OPTIONAL / UNION results, and
``PAD = 2**31 - 1`` as the padding key that sorts after every valid id in
sorted static-shape tables.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Union

import numpy as np

# Sentinels -----------------------------------------------------------------
UNBOUND: int = -1              # OPTIONAL/UNION missing binding
PAD: int = np.iinfo(np.int32).max  # padding key; sorts after all valid ids


def _try_float(term: str) -> float:
    """Numeric value of a literal term, or NaN."""
    # Plain numeric literal ("42", "19.99") or typed ("\"42\"^^xsd:integer").
    s = term
    if s.startswith('"'):
        end = s.find('"', 1)
        if end > 0:
            s = s[1:end]
    try:
        return float(s)
    except ValueError:
        return float("nan")


@dataclass
class Dictionary:
    """Bidirectional term <-> id mapping with a numeric-value side table."""

    term_to_id: Dict[str, int] = field(default_factory=dict)
    id_to_term: List[str] = field(default_factory=list)
    _values: List[float] = field(default_factory=list)

    # -- construction -------------------------------------------------------
    def add(self, term: str) -> int:
        tid = self.term_to_id.get(term)
        if tid is None:
            tid = len(self.id_to_term)
            self.term_to_id[term] = tid
            self.id_to_term.append(term)
            self._values.append(_try_float(term))
        return tid

    def add_all(self, terms: Iterable[str]) -> np.ndarray:
        return np.asarray([self.add(t) for t in terms], dtype=np.int32)

    @classmethod
    def from_terms(cls, terms: Sequence[str],
                   values: Optional[Sequence[float]] = None) -> "Dictionary":
        """Rebuild a dictionary from an id-ordered term list (the
        catalog carried across by :mod:`repro_torch.convert`).  ``values`` is the
        persisted float64 numeric-value table; when absent it is
        recomputed term by term — passing it skips the string parsing
        and guarantees bit-identical values (NaN payloads included)."""
        d = cls()
        d.id_to_term = list(terms)
        d.term_to_id = {t: i for i, t in enumerate(d.id_to_term)}
        if len(d.term_to_id) != len(d.id_to_term):
            raise ValueError("duplicate terms in id-ordered term list")
        if values is None:
            d._values = [_try_float(t) for t in d.id_to_term]
        else:
            if len(values) != len(d.id_to_term):
                raise ValueError(
                    f"value table length {len(values)} != {len(d.id_to_term)} terms")
            d._values = [float(v) for v in values]
        return d

    # -- lookup --------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.id_to_term)

    def id_of(self, term: str) -> Optional[int]:
        return self.term_to_id.get(term)

    def term_of(self, tid: int) -> str:
        if tid == UNBOUND:
            return "UNBOUND"
        return self.id_to_term[tid]

    def decode_rows(self, rows: np.ndarray) -> List[tuple]:
        return [tuple(self.term_of(int(t)) for t in row) for row in np.asarray(rows)]

    @property
    def values(self) -> np.ndarray:
        """float64[n_terms] numeric value per id (NaN if not numeric)."""
        return np.asarray(self._values, dtype=np.float64)

    # -- bulk encoding -------------------------------------------------------
    def encode_triples(self, triples: Sequence[tuple]) -> np.ndarray:
        """Encode an iterable of (s, p, o) string triples to int32[N, 3]."""
        out = np.empty((len(triples), 3), dtype=np.int32)
        for i, (s, p, o) in enumerate(triples):
            out[i, 0] = self.add(s)
            out[i, 1] = self.add(p)
            out[i, 2] = self.add(o)
        return out


def encode_graph(triples: Sequence[tuple]) -> tuple:
    """Convenience: encode string triples, returning (tt, dictionary)."""
    d = Dictionary()
    tt = d.encode_triples(triples)
    return tt, d

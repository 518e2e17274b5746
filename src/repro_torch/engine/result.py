"""Uniform query-result type.

``Result`` wraps a :class:`Bindings` relation — a bag of solution
mappings over id-encoded columns, on the host — plus the dictionary, so
callers can decode ids back to RDF terms and compare results under
SPARQL bag semantics (column order is presentation, not identity).
"""

from __future__ import annotations

from collections import Counter
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.rdf.dictionary import UNBOUND

__all__ = ["Bindings", "Result"]


@dataclass
class Bindings:
    """A relation over query variables (host rows)."""

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

    def __len__(self) -> int:
        return self.data.shape[0]

    def col(self, var: str) -> np.ndarray:
        return self.data[:, self.cols.index(var)]


@dataclass
class Result:
    """A relation over query variables, with optional term decoding."""

    bindings: Bindings
    dictionary: Optional[object] = None   # repro_torch.rdf.Dictionary

    @property
    def cols(self) -> Tuple[str, ...]:
        return self.bindings.cols

    @property
    def data(self) -> np.ndarray:
        return self.bindings.data

    def __len__(self) -> int:
        return len(self.bindings)

    @staticmethod
    def empty(cols: Sequence[str], dictionary=None) -> "Result":
        return Result(Bindings.empty(tuple(cols)), dictionary)

    def to_numpy(self) -> np.ndarray:
        """The (n, n_vars) int32 id matrix."""
        return self.bindings.data

    def to_terms(self) -> List[Dict[str, str]]:
        """Dictionary-decoded rows: one ``{var: term}`` mapping per
        solution (unbound OPTIONAL slots are omitted)."""
        if self.dictionary is None:
            raise ValueError("Result has no dictionary to decode with")
        return [{c: self.dictionary.term_of(int(v))
                 for c, v in zip(self.cols, row) if v != UNBOUND}
                for row in self.bindings.data.tolist()]

    def as_multiset(self, cols: Optional[Sequence[str]] = None) -> Counter:
        """Bag of solution tuples over ``cols`` (default: sorted columns).
        Columns the relation does not carry are UNBOUND-filled."""
        order = sorted(self.cols) if cols is None else list(cols)
        n = len(self)
        if not order:
            return Counter({(): n}) if n else Counter()
        arrs = [self.bindings.data[:, self.cols.index(c)] if c in self.cols
                else np.full(n, UNBOUND, dtype=np.int32) for c in order]
        return Counter(map(tuple, np.stack(arrs, axis=1).tolist()))

    def same_as(self, other: "Result") -> bool:
        """Multiset equality under SPARQL bag semantics, over the union
        of both column sets (missing columns are UNBOUND-filled)."""
        cols = sorted(set(self.cols) | set(other.cols))
        return self.as_multiset(cols) == other.as_multiset(cols)

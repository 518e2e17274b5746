"""Relational table representation for the S2RDF engine.

``Table`` is the host-side (numpy) exact-size two-column relation.  The
catalog (VP + ExtVP) lives in this form; it is the analogue of the
Parquet files S2RDF materializes in HDFS.  Tables are kept sorted by
subject, with a lazily-built object-sorted view, mirroring how a
Spark-side engine would keep sorted/clustered copies for merge joins
(and how RDF-3X/Hexastore keep permuted indexes).  The executor
(:mod:`repro_torch.core.jexec`) uploads each table once, padded to a
power-of-two capacity with ``PAD`` rows (which sort after all valid ids).
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import cached_property

import numpy as np

from repro_torch.rdf.dictionary import PAD

__all__ = ["Table", "pad_rows", "round_up_pow2"]


def round_up_pow2(n: int, minimum: int = 8) -> int:
    c = minimum
    while c < n:
        c *= 2
    return c


def pad_rows(rows: np.ndarray, capacity: int) -> np.ndarray:
    """Pad (n, k) rows to (capacity, k) with PAD."""
    n, k = rows.shape
    assert capacity >= n, (capacity, n)
    out = np.full((capacity, k), PAD, dtype=np.int32)
    out[:n] = rows
    return out


@dataclass
class Table:
    """Host-side two-column relation (s, o), sorted by s."""

    rows: np.ndarray  # (n, 2) int32, sorted by (s, o)

    def __post_init__(self) -> None:
        self.rows = np.asarray(self.rows, dtype=np.int32).reshape(-1, 2)

    @staticmethod
    def from_unsorted(rows: np.ndarray) -> "Table":
        rows = np.asarray(rows, dtype=np.int32).reshape(-1, 2)
        order = np.lexsort((rows[:, 1], rows[:, 0]))
        return Table(rows[order])

    def __len__(self) -> int:
        return len(self.rows)

    @property
    def s(self) -> np.ndarray:
        return self.rows[:, 0]

    @property
    def o(self) -> np.ndarray:
        return self.rows[:, 1]

    @cached_property
    def rows_by_o(self) -> np.ndarray:
        """(n, 2) rows sorted by (o, s) — the object-clustered view."""
        order = np.lexsort((self.rows[:, 0], self.rows[:, 1]))
        return self.rows[order]

    @cached_property
    def unique_s(self) -> np.ndarray:
        return np.unique(self.rows[:, 0])

    @cached_property
    def unique_o(self) -> np.ndarray:
        return np.unique(self.rows[:, 1])

    def nbytes(self) -> int:
        return int(self.rows.nbytes)

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

from collections.abc import Mapping
from dataclasses import dataclass
from functools import cached_property
from typing import Callable, Dict, Optional

import numpy as np

from repro_torch.rdf.dictionary import PAD

__all__ = ["Table", "LazyTableMap", "pad_rows", "round_up_pow2"]


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


class LazyTableMap(Mapping):
    """A ``Mapping[key, Table]`` whose values materialize on first access.

    This is the table-provider indirection behind ``Catalog.vp`` and
    ``Catalog.extvp.tables``: an in-RAM catalog uses plain dicts, a
    persistent one (:mod:`repro_torch.store`) uses a ``LazyTableMap`` of
    per-file loader callables that ``np.memmap`` the on-disk columns — the
    compiler and the executor cannot tell the two apart.  Key/len/contains
    queries never touch a loader; each loader runs at most once and its
    ``Table`` is cached (so per-table ``cached_property`` views such as
    ``rows_by_o`` persist across accesses exactly like the in-RAM form).

    ``lengths`` (optional, per-key row counts — the store reader passes
    the manifest's) lets size accounting (``total_rows``) answer without
    running a single loader.
    """

    def __init__(self, loaders: Dict[object, Callable[[], "Table"]],
                 lengths: Optional[Dict[object, int]] = None):
        self._loaders = dict(loaders)
        self._cache: Dict[object, Table] = {}
        self._lengths = None if lengths is None else dict(lengths)

    def __getitem__(self, key) -> "Table":
        t = self._cache.get(key)
        if t is None:
            t = self._loaders[key]()        # KeyError propagates
            self._cache[key] = t
        return t

    def __contains__(self, key) -> bool:
        return key in self._loaders

    def __iter__(self):
        return iter(self._loaders)

    def __len__(self) -> int:
        return len(self._loaders)

    @property
    def n_loaded(self) -> int:
        """How many tables have been touched (lazy-load observability)."""
        return len(self._cache)

    def total_rows(self) -> int:
        """Total rows across all tables — from the ``lengths`` metadata
        when available (no loader runs), by materializing otherwise."""
        if self._lengths is not None:
            return int(sum(self._lengths.values()))
        return sum(len(self[k]) for k in self._loaders)

    def loader_for(self, key) -> Callable[[], "Table"]:
        """The zero-arg provider for ``key``, WITHOUT materializing it —
        lets a derived catalog (``Dataset.append_triples`` carry-over)
        re-wrap untouched tables lazily instead of loading them."""
        t = self._cache.get(key)
        if t is not None:
            return lambda: t
        return self._loaders[key]

    def materialize_all(self) -> None:
        """Force every table (the eager-load mode)."""
        for key in self._loaders:
            self[key]

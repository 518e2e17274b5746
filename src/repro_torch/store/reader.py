"""Store reader: on-disk columnar store -> ``Catalog``.

Cold-start is **zero-copy and lazy**: ``load_catalog`` parses only the
manifest (statistics, SF/size maps, dictionary) and hands the catalog
:class:`~repro_torch.core.table.LazyTableMap` views whose per-table loaders
``np.memmap`` the raw little-endian column files on first
``Catalog.table()`` touch — no table bytes are read (or even mapped)
until a query actually scans them.  ``eager=True`` materializes every
table into RAM up front (the benchmarking / latency-critical mode);
``verify=True`` additionally CRC-checks each file's bytes when it is
first read (always up-front under ``eager``).

Loaded catalogs are indistinguishable from freshly built in-RAM ones:
the compiler and every execution backend go through the same
``Catalog.vp`` / ``Catalog.extvp.tables`` mappings and ``Catalog.table()``
accessor either way.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.core.table import LazyTableMap, Table
from repro_torch.store.format import (
    INT_DTYPE, VAL_DTYPE, StoreChecksumError, StoreFormatError, crc32_file,
    load_manifest, section_bytes, str_to_key,
)

__all__ = ["StoreInfo", "load_catalog", "load_dictionary"]


@dataclass
class StoreInfo:
    """What a catalog knows about its on-disk form (for Table 2 style
    accounting in ``Catalog.storage_report()`` and the inspect tool)."""

    path: str
    bytes_by_section: Dict[str, int] = field(default_factory=dict)
    delta_segments: int = 0

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_section.values())


def _check_entry(path: str, entry: Dict, dtype: np.dtype) -> str:
    """Structural validation of one manifest file entry; returns the
    absolute file path.  One ``stat`` per file — the lazy path defers it
    to first touch so cold-start cost stays O(manifest), not O(files)."""
    fpath = os.path.join(path, entry["file"])
    try:
        actual = os.stat(fpath).st_size
    except OSError:
        raise StoreFormatError(f"store file missing: {fpath!r}") from None
    expect = int(entry["nbytes"])
    if actual != expect:
        raise StoreFormatError(
            f"{fpath!r}: size {actual} != manifest nbytes {expect}")
    rows = int(entry.get("rows", 0))
    cols = int(entry.get("cols", 1))
    if "rows" in entry and rows * cols * dtype.itemsize != expect:
        raise StoreFormatError(
            f"{fpath!r}: {rows}x{cols} {dtype} rows do not fill {expect} bytes")
    return fpath


def _verify_crc(fpath: str, entry: Dict) -> None:
    actual = crc32_file(fpath)
    if actual != int(entry["crc32"]):
        raise StoreChecksumError(
            f"{fpath!r}: CRC-32 {actual:#010x} != manifest "
            f"{int(entry['crc32']):#010x}")


def _map_rows(fpath: str, rows: int, cols: int, eager: bool) -> np.ndarray:
    if rows == 0:
        return np.empty((0, cols), dtype=np.int32)
    if eager:
        return np.fromfile(fpath, dtype=INT_DTYPE).reshape(rows, cols)
    return np.memmap(fpath, dtype=INT_DTYPE, mode="r", shape=(rows, cols))


def _table_loader(path: str, entry: Dict, eager: bool, verify: bool):
    """A zero-arg loader closure for one column file (LazyTableMap value).

    All validation (size stat, optional CRC) runs on first touch, so a
    lazy cold start never stats a table file it does not use; under
    ``eager`` the caller materializes everything at load time and every
    check runs up front."""
    def load() -> Table:
        fpath = _check_entry(path, entry, INT_DTYPE)
        if verify:
            _verify_crc(fpath, entry)
        return Table(_map_rows(fpath, int(entry["rows"]),
                               int(entry["cols"]), eager))
    return load


def load_dictionary(path: str, manifest: Dict, verify: bool = False):
    """Rebuild the term dictionary (terms JSON + float64 value table)."""
    from repro_torch.rdf.dictionary import Dictionary
    d = manifest["dictionary"]
    tpath = _check_entry(path, d["terms"], np.dtype("u1"))
    vpath = _check_entry(path, d["values"], VAL_DTYPE)
    if verify:
        _verify_crc(tpath, d["terms"])
        _verify_crc(vpath, d["values"])
    try:
        with open(tpath, encoding="utf-8") as f:
            terms = json.load(f)
    except ValueError as e:
        raise StoreFormatError(f"unreadable term file {tpath!r}: {e}") from e
    if not isinstance(terms, list) or len(terms) != int(d["n_terms"]):
        raise StoreFormatError(
            f"{tpath!r}: expected a JSON array of {d['n_terms']} terms")
    values = np.fromfile(vpath, dtype=VAL_DTYPE) if os.path.getsize(vpath) \
        else np.empty((0,), dtype=VAL_DTYPE)
    return Dictionary.from_terms(terms, values)


def load_catalog(path: str, eager: bool = False, verify: bool = False
                 ) -> Tuple["Catalog", object]:
    """Open the store at ``path`` -> ``(Catalog, Dictionary)``.

    ``eager`` reads every column file into RAM now (and with ``verify``
    checks every checksum now); the default maps tables lazily.
    """
    path = os.fspath(path)
    manifest = load_manifest(path)

    from repro_torch.core.stats import Catalog
    from repro_torch.core.vp import ExtVPBuild

    dictionary = load_dictionary(path, manifest, verify=verify)

    tt_entry = manifest["tt"]
    tt_path = _check_entry(path, tt_entry, INT_DTYPE)
    if verify:
        _verify_crc(tt_path, tt_entry)
    tt = _map_rows(tt_path, int(tt_entry["rows"]), 3, eager)

    vp = LazyTableMap({int(pid): _table_loader(path, entry, eager, verify)
                       for pid, entry in manifest["vp"].items()},
                      lengths={int(pid): int(entry["rows"])
                               for pid, entry in manifest["vp"].items()})
    ext_tables = LazyTableMap(
        {str_to_key(k): _table_loader(path, entry, eager, verify)
         for k, entry in manifest["extvp"].items()},
        lengths={str_to_key(k): int(entry["rows"])
                 for k, entry in manifest["extvp"].items()})

    stats = manifest.get("stats", {})
    ext = ExtVPBuild(
        tables=ext_tables,
        sf={str_to_key(k): float(v) for k, v in manifest["sf"].items()},
        sizes={str_to_key(k): int(v) for k, v in manifest["sizes"].items()},
        threshold=float(manifest["threshold"]),
        build_seconds=float(stats.get("extvp_build_seconds", 0.0)),
        n_semijoins=int(stats.get("n_semijoins", 0)),
        backend=manifest.get("build_backend", "numpy"),
        kinds=tuple(manifest["kinds"]),
    )
    if eager:
        vp.materialize_all()
        ext_tables.materialize_all()

    # distinct-count statistics (format version 2; absent in version-1
    # manifests — the catalog then reports has_distinct_stats=False and
    # the estimate planner falls back to greedy).  Served straight from
    # the manifest: planning never touches a column file.
    distinct = manifest.get("distinct")
    distinct_s = distinct_o = m2_s = m2_o = None
    if isinstance(distinct, dict) and "s" in distinct and "o" in distinct:
        distinct_s = {int(p): int(v) for p, v in distinct["s"].items()}
        distinct_o = {int(p): int(v) for p, v in distinct["o"].items()}
        if "s2" in distinct and "o2" in distinct:
            # skew (second-moment) statistics — optional within v2
            m2_s = {int(p): int(v) for p, v in distinct["s2"].items()}
            m2_o = {int(p): int(v) for p, v in distinct["o2"].items()}

    from repro_torch.store.delta import delta_stats
    n_delta, _ = delta_stats(path)
    info = StoreInfo(path=path,
                     bytes_by_section=section_bytes(manifest, path),
                     delta_segments=n_delta)
    cat = Catalog(tt=tt, vp=vp, extvp=ext, dictionary=dictionary,
                  vp_build_seconds=float(stats.get("vp_build_seconds", 0.0)),
                  with_extvp=bool(manifest["with_extvp"]),
                  store=info, distinct_s=distinct_s, distinct_o=distinct_o,
                  m2_s=m2_s, m2_o=m2_o)
    return cat, dictionary

"""On-disk columnar catalog format (the persisted analogue of S2RDF's
Parquet store on HDFS, paper §4–§5).

A store is a directory::

    <path>/
      manifest.json            # versioned JSON manifest (written LAST)
      dictionary.json          # JSON array of terms, id order
      values.bin               # float64[n_terms] numeric literal values
      tt.bin                   # int32[N, 3] triples table, row-major
      vp/<pid>.bin             # int32[n, 2] (s, o) rows, sorted by (s, o)
      extvp/<kind>_<p1>_<p2>.bin   # materialized ExtVP tables, same layout
      delta/seg-<seq>.json     # append journal (see repro_torch.store.delta)

All ``.bin`` files are raw **little-endian** column files with no header:
the manifest records dtype-implied row/column counts, byte sizes and a
CRC-32 per file, so a reader can ``np.memmap`` any table zero-copy and
verify integrity independently.  The manifest also persists the
coordinator-side statistics (SF + sizes for **all** pairs, paper §6) so a
loaded catalog answers the compiler's statistics queries without touching
a single column file.

The manifest is written last (via tmp + ``os.replace``): a directory
without a readable, well-formed manifest is not a store.
"""

from __future__ import annotations

import json
import os
import zlib
from typing import Dict, Tuple

import numpy as np

__all__ = [
    "FORMAT_NAME", "FORMAT_VERSION", "SUPPORTED_VERSIONS", "MANIFEST_NAME",
    "INT_DTYPE",
    "VAL_DTYPE", "CHUNK_BYTES", "StoreError", "StoreFormatError",
    "StoreChecksumError", "key_to_str", "str_to_key", "table_filename",
    "crc32", "crc32_file", "load_manifest", "manifest_path", "is_store",
    "section_bytes",
]

FORMAT_NAME = "s2rdf-columnar-store"
#: version 2 added the per-predicate distinct-subject/object counts
#: ("distinct" manifest section) that feed the cardinality estimator;
#: version-1 stores still load — they just carry no distinct statistics,
#: so the estimate planner falls back to the greedy order.
FORMAT_VERSION = 2
SUPPORTED_VERSIONS = (1, 2)
MANIFEST_NAME = "manifest.json"

#: every table column file is raw little-endian int32; the numeric-literal
#: value table is little-endian float64
INT_DTYPE = np.dtype("<i4")
VAL_DTYPE = np.dtype("<f8")

#: streaming granularity for writes / checksum scans
CHUNK_BYTES = 1 << 22


class StoreError(Exception):
    """Base class for persistent-store failures."""


class StoreFormatError(StoreError):
    """Missing / malformed / unsupported manifest or file layout."""


class StoreChecksumError(StoreError):
    """A file's bytes do not match the CRC-32 recorded in the manifest."""


# ---------------------------------------------------------------------------
# Keys and filenames
# ---------------------------------------------------------------------------

Key = Tuple[str, int, int]


def key_to_str(key: Key) -> str:
    """(kind, p1, p2) -> "SS:3:7" (manifest dict key)."""
    kind, p1, p2 = key
    return f"{kind}:{int(p1)}:{int(p2)}"


def str_to_key(s: str) -> Key:
    kind, p1, p2 = s.split(":")
    return (kind, int(p1), int(p2))


def table_filename(kind: str, p1: int, p2: int) -> str:
    return f"extvp/{kind}_{int(p1)}_{int(p2)}.bin"


def manifest_path(path: str) -> str:
    return os.path.join(path, MANIFEST_NAME)


def is_store(path) -> bool:
    """True when ``path`` holds a readable store manifest."""
    return os.path.isfile(manifest_path(os.fspath(path)))


# ---------------------------------------------------------------------------
# Checksums
# ---------------------------------------------------------------------------

def crc32(data: bytes, value: int = 0) -> int:
    """CRC-32 of a byte chunk, chainable via ``value``."""
    return zlib.crc32(data, value)


def crc32_file(path: str) -> int:
    """Streaming CRC-32 of a file (never loads it whole)."""
    crc = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(CHUNK_BYTES)
            if not chunk:
                return crc
            crc = zlib.crc32(chunk, crc)


# ---------------------------------------------------------------------------
# Manifest
# ---------------------------------------------------------------------------

_REQUIRED_TOP = ("format", "version", "threshold", "kinds", "with_extvp",
                 "dictionary", "tt", "vp", "extvp", "sf", "sizes")


def load_manifest(path: str) -> Dict:
    """Read + structurally validate ``<path>/manifest.json``.

    Raises :class:`StoreFormatError` on a missing manifest, unparseable
    JSON, a foreign format tag, an unsupported version, or missing
    sections — checksum verification is separate (it requires reading
    the column files, which the lazy loader defers).
    """
    mpath = manifest_path(path)
    if not os.path.isfile(mpath):
        raise StoreFormatError(f"no store at {path!r}: missing {MANIFEST_NAME}")
    try:
        with open(mpath, encoding="utf-8") as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise StoreFormatError(f"unreadable manifest {mpath!r}: {e}") from e
    if not isinstance(manifest, dict) or manifest.get("format") != FORMAT_NAME:
        raise StoreFormatError(
            f"{mpath!r} is not a {FORMAT_NAME} manifest "
            f"(format={manifest.get('format') if isinstance(manifest, dict) else None!r})")
    if manifest.get("version") not in SUPPORTED_VERSIONS:
        raise StoreFormatError(
            f"unsupported store version {manifest.get('version')!r} "
            f"(this reader speaks versions {SUPPORTED_VERSIONS})")
    missing = [k for k in _REQUIRED_TOP if k not in manifest]
    if missing:
        raise StoreFormatError(f"manifest {mpath!r} missing sections: {missing}")
    return manifest


def section_bytes(manifest: Dict, path: str) -> Dict[str, int]:
    """On-disk bytes per store section (manifest / dictionary / tt / vp /
    extvp / delta) from manifest-recorded sizes plus a live scan of the
    delta journal."""
    from repro_torch.store.delta import delta_stats
    d = manifest["dictionary"]
    n_delta, delta_bytes = delta_stats(path)
    return {
        "manifest": os.path.getsize(manifest_path(path)),
        "dictionary": int(d["terms"]["nbytes"]) + int(d["values"]["nbytes"]),
        "tt": int(manifest["tt"]["nbytes"]),
        "vp": sum(int(e["nbytes"]) for e in manifest["vp"].values()),
        "extvp": sum(int(e["nbytes"]) for e in manifest["extvp"].values()),
        "delta": delta_bytes,
    }

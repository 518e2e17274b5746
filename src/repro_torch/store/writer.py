"""Streaming store writer: Catalog -> on-disk columnar store.

Every file is written in bounded chunks (the CRC-32 accumulates as the
bytes stream out, so no table is ever serialized twice or held whole as
bytes) and lands via ``<file>.tmp`` + ``os.replace``.  The manifest goes
last: until it is in place the directory is not a valid store, so a
crashed save never yields a half-readable catalog.  Replacing (rather
than truncating) also makes ``Dataset.compact()`` safe while the *same*
store's column files are still memory-mapped by the live catalog — the
old inodes stay alive under the open maps until they are dropped.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np

from repro_torch.store.format import (
    CHUNK_BYTES, FORMAT_NAME, FORMAT_VERSION, INT_DTYPE, MANIFEST_NAME,
    VAL_DTYPE, key_to_str, manifest_path, table_filename,
)
from repro_torch.store.format import crc32 as _crc32

__all__ = ["write_store"]


def _write_bytes(path: str, data: bytes) -> Tuple[int, int]:
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    return len(data), _crc32(data)


def _write_array(path: str, arr: np.ndarray, dtype: np.dtype) -> Tuple[int, int]:
    """Stream ``arr`` to ``path`` as raw ``dtype`` rows; (nbytes, crc32)."""
    arr = np.asarray(arr)
    if arr.dtype != dtype:
        arr = arr.astype(dtype)
    rows_per_chunk = max(1, CHUNK_BYTES // max(arr[:1].nbytes, 1)) \
        if len(arr) else 1
    crc = 0
    nbytes = 0
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        for i in range(0, len(arr), rows_per_chunk):
            chunk = np.ascontiguousarray(arr[i:i + rows_per_chunk]).tobytes()
            f.write(chunk)
            crc = _crc32(chunk, crc)
            nbytes += len(chunk)
    os.replace(tmp, path)
    return nbytes, crc


def _table_entry(path: str, rel: str, rows: np.ndarray, cols: int) -> Dict:
    nbytes, crc = _write_array(os.path.join(path, rel), rows, INT_DTYPE)
    return {"file": rel, "rows": int(len(rows)), "cols": cols,
            "nbytes": nbytes, "crc32": crc}


def _prune_stale(dirpath: str, keep: set) -> None:
    """Remove ``.bin``/``.tmp`` files a rewrite no longer references
    (unlink is safe under live memory maps)."""
    if not os.path.isdir(dirpath):
        return
    for name in os.listdir(dirpath):
        if name not in keep and (name.endswith(".bin") or name.endswith(".tmp")):
            os.remove(os.path.join(dirpath, name))


def write_store(catalog, dictionary, path: str,
                build_backend: str = "numpy") -> Dict:
    """Persist ``catalog`` (+ its ``dictionary``) under directory ``path``.

    Returns the manifest dict that was written.  Safe to call on a path
    that already holds a store: files are atomically replaced, stale
    table files pruned, and the delta journal is NOT touched here (the
    caller decides whether the rewrite supersedes it — ``Dataset.save``
    clears it).
    """
    path = os.fspath(path)
    os.makedirs(path, exist_ok=True)
    os.makedirs(os.path.join(path, "vp"), exist_ok=True)
    os.makedirs(os.path.join(path, "extvp"), exist_ok=True)

    ext = catalog.extvp
    manifest: Dict = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "threshold": float(ext.threshold),
        "kinds": list(ext.kinds),
        "with_extvp": bool(catalog.with_extvp),
        "build_backend": build_backend,
        "stats": {
            "vp_build_seconds": float(catalog.vp_build_seconds),
            "extvp_build_seconds": float(ext.build_seconds),
            "n_semijoins": int(ext.n_semijoins),
        },
    }

    # dictionary: terms as a JSON array (id order), values as float64 bin
    terms = list(dictionary.id_to_term)
    tdata = json.dumps(terms, ensure_ascii=False).encode("utf-8")
    tn, tcrc = _write_bytes(os.path.join(path, "dictionary.json"), tdata)
    vn, vcrc = _write_array(os.path.join(path, "values.bin"),
                            dictionary.values, VAL_DTYPE)
    manifest["dictionary"] = {
        "n_terms": len(terms),
        "terms": {"file": "dictionary.json", "nbytes": tn, "crc32": tcrc},
        "values": {"file": "values.bin", "nbytes": vn, "crc32": vcrc},
    }

    manifest["tt"] = _table_entry(path, "tt.bin", catalog.tt, 3)

    vp_entries: Dict[str, Dict] = {}
    for pid in sorted(catalog.vp):
        rel = f"vp/{int(pid)}.bin"
        vp_entries[str(int(pid))] = _table_entry(path, rel,
                                                 catalog.vp[pid].rows, 2)
    manifest["vp"] = vp_entries

    ext_entries: Dict[str, Dict] = {}
    for key in sorted(ext.tables):
        kind, p1, p2 = key
        rel = table_filename(kind, p1, p2)
        ext_entries[key_to_str(key)] = _table_entry(path, rel,
                                                    ext.tables[key].rows, 2)
    manifest["extvp"] = ext_entries

    # coordinator-side statistics for ALL pairs (materialized or not, §6)
    manifest["sf"] = {key_to_str(k): float(v)
                      for k, v in sorted(ext.sf.items())}
    manifest["sizes"] = {key_to_str(k): int(v)
                         for k, v in sorted(ext.sizes.items())}

    # per-predicate distinct-subject/object counts (format version 2):
    # the cardinality estimator's join-selectivity statistics, served
    # from the manifest so lazy loads never materialize a table to plan
    if catalog.distinct_s is not None and catalog.distinct_o is not None:
        manifest["distinct"] = {
            "s": {str(int(p)): int(v)
                  for p, v in sorted(catalog.distinct_s.items())},
            "o": {str(int(p)): int(v)
                  for p, v in sorted(catalog.distinct_o.items())},
        }
        # frequency second moments (skew statistics) ride along when the
        # catalog has them — optional even within format version 2
        if catalog.m2_s is not None and catalog.m2_o is not None:
            manifest["distinct"]["s2"] = {
                str(int(p)): int(v) for p, v in sorted(catalog.m2_s.items())}
            manifest["distinct"]["o2"] = {
                str(int(p)): int(v) for p, v in sorted(catalog.m2_o.items())}

    _prune_stale(os.path.join(path, "vp"),
                 {os.path.basename(e["file"]) for e in vp_entries.values()})
    _prune_stale(os.path.join(path, "extvp"),
                 {os.path.basename(e["file"]) for e in ext_entries.values()})

    mdata = json.dumps(manifest, ensure_ascii=False, indent=1).encode("utf-8")
    tmp = manifest_path(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(mdata)
    os.replace(tmp, manifest_path(path))
    return manifest

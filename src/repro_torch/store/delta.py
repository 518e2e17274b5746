"""Delta segments: the append journal of a persistent store.

``Dataset.append_triples`` on a store-attached dataset journals the raw
string triples as one JSON segment per append::

    delta/seg-000007.json
    {"format": "s2rdf-delta", "version": 1, "seq": 7,
     "n_triples": 3, "payload_crc32": ..., "triples": [[s, p, o], ...]}

The base store is never rewritten on append — ``Dataset.load`` replays
the segments in sequence through the incremental build path
(:func:`repro_torch.core.extvp_build.incremental_pairs`), which recomputes only
the ExtVP pairs each append actually touched.  ``Dataset.compact()``
folds the journal into a fresh base and clears it.

Segments carry *string* triples (not ids): the dictionary grows during
replay exactly as it did during the original append, so a replayed
catalog is byte-identical to the pre-restart one.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import List, Tuple

from repro_torch.store.format import StoreChecksumError, StoreFormatError, crc32

DELTA_FORMAT = "s2rdf-delta"
DELTA_VERSION = 1
DELTA_DIR = "delta"

_SEG_RE = re.compile(r"^seg-(\d{6})\.json$")

__all__ = ["DeltaSegment", "append_segment", "read_segments",
           "clear_segments", "delta_stats", "DELTA_DIR"]


@dataclass
class DeltaSegment:
    seq: int
    triples: List[Tuple[str, str, str]]
    path: str
    nbytes: int


def _delta_dir(store_path: str) -> str:
    return os.path.join(os.fspath(store_path), DELTA_DIR)


def _payload_crc(triples) -> int:
    payload = json.dumps([list(t) for t in triples], ensure_ascii=False,
                         separators=(",", ":"))
    return crc32(payload.encode("utf-8"))


def _segment_files(store_path: str) -> List[Tuple[int, str]]:
    ddir = _delta_dir(store_path)
    if not os.path.isdir(ddir):
        return []
    out = []
    for name in os.listdir(ddir):
        m = _SEG_RE.match(name)
        if m:
            out.append((int(m.group(1)), os.path.join(ddir, name)))
    return sorted(out)


def next_seq(store_path: str) -> int:
    files = _segment_files(store_path)
    return (files[-1][0] + 1) if files else 1


def append_segment(store_path: str, triples) -> DeltaSegment:
    """Journal one append as the next numbered segment (tmp + replace,
    so a crash mid-write never leaves a half segment behind)."""
    triples = [tuple(t) for t in triples]
    seq = next_seq(store_path)
    ddir = _delta_dir(store_path)
    os.makedirs(ddir, exist_ok=True)
    seg = {
        "format": DELTA_FORMAT, "version": DELTA_VERSION, "seq": seq,
        "n_triples": len(triples), "payload_crc32": _payload_crc(triples),
        "triples": [list(t) for t in triples],
    }
    path = os.path.join(ddir, f"seg-{seq:06d}.json")
    tmp = path + ".tmp"
    with open(tmp, "w", encoding="utf-8") as f:
        json.dump(seg, f, ensure_ascii=False)
    os.replace(tmp, path)
    return DeltaSegment(seq=seq, triples=triples, path=path,
                        nbytes=os.path.getsize(path))


def read_segments(store_path: str) -> List[DeltaSegment]:
    """All journal segments in sequence order, payload-checksummed.

    Delta segments are always verified (unlike lazily-touched column
    files they are the mutation-prone part of the store and are small).
    """
    out: List[DeltaSegment] = []
    for seq, path in _segment_files(store_path):
        try:
            with open(path, encoding="utf-8") as f:
                seg = json.load(f)
        except (OSError, ValueError) as e:
            raise StoreFormatError(f"unreadable delta segment {path!r}: {e}") from e
        if seg.get("format") != DELTA_FORMAT or seg.get("version") != DELTA_VERSION:
            raise StoreFormatError(f"{path!r} is not a {DELTA_FORMAT} segment")
        triples = [tuple(t) for t in seg.get("triples", [])]
        if len(triples) != seg.get("n_triples") or \
                _payload_crc(triples) != seg.get("payload_crc32"):
            raise StoreChecksumError(f"delta segment {path!r} failed its "
                                     "payload checksum")
        out.append(DeltaSegment(seq=int(seg["seq"]), triples=triples,
                                path=path, nbytes=os.path.getsize(path)))
    return out


def clear_segments(store_path: str) -> int:
    """Drop the journal (after a compact); returns segments removed."""
    files = _segment_files(store_path)
    for _, path in files:
        os.remove(path)
    return len(files)


def delta_stats(store_path: str) -> Tuple[int, int]:
    """(segment count, total journal bytes) without parsing payloads."""
    files = _segment_files(store_path)
    return len(files), sum(os.path.getsize(p) for _, p in files)

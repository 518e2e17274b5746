"""Persistent columnar catalog store (the analogue of S2RDF's one-time
Parquet load job on HDFS, paper §4–§5): write a built catalog to disk
once, then boot any number of query processes from it — memory-mapped,
zero-copy, without ever re-running the semi-join grid.

    ds = Dataset.watdiv(scale=1.0, threshold=0.25)
    ds.save("watdiv.store")                    # streaming columnar write
    ...
    ds = Dataset.load("watdiv.store")          # lazy memmap cold start
    ds.engine().query(...)                     # tables fault in on touch

The format is the JAX package's (``repro.store``) byte for byte: a store
written by either package loads in the other.

Layout, manifest and integrity rules: :mod:`repro_torch.store.format`.
Append journal (delta segments + compaction): :mod:`repro_torch.store.delta`.
"""

from repro_torch.store.delta import (
    DeltaSegment, append_segment, clear_segments, delta_stats, read_segments,
)
from repro_torch.store.format import (
    FORMAT_NAME, FORMAT_VERSION, StoreChecksumError, StoreError,
    StoreFormatError, is_store, load_manifest, section_bytes,
)
from repro_torch.store.reader import StoreInfo, load_catalog, load_dictionary
from repro_torch.store.writer import write_store

__all__ = [
    "FORMAT_NAME", "FORMAT_VERSION",
    "StoreError", "StoreFormatError", "StoreChecksumError",
    "is_store", "load_manifest", "section_bytes",
    "StoreInfo", "load_catalog", "load_dictionary", "write_store",
    "DeltaSegment", "append_segment", "read_segments", "clear_segments",
    "delta_stats",
]

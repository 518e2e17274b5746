"""The ``Dataset`` facade: one object owning the storage stack.

S2RDF's data layer is a pipeline — dictionary-encode the triples, build
VP tables, semi-join-reduce them into ExtVP with selectivity statistics
(paper §5).  ``Dataset`` owns that pipeline and hands out
:class:`~repro_torch.engine.engine.Engine` instances.

    # threshold is the paper's SF-threshold τ; 0.25 is the recommended
    # production trade-off (§7.4), 1.0 materializes every reduction.
    ds = Dataset.watdiv(scale=1.0, seed=0, threshold=0.25)   # on "cuda"
    eng = ds.engine()
    res = eng.query("SELECT * WHERE { ?u wsdbm:follows ?v }")
    res.to_terms()

    # persist once, boot forever (repro_torch.store): save() writes the
    # on-disk columnar store, load() memory-maps it lazily — no rebuild
    ds.save("watdiv.store")
    ds = Dataset.load("watdiv.store")

A dataset's ``device`` is where its ExtVP is built (``build_backend=
"torch"``, the default: the semi-join kernel on a CUDA device) and the
default device of its engines; ``device=None`` means ``"cuda"`` and
raises when no CUDA device is present.  Tests pass ``device="cpu"``.

Across the ranks of a ``torch.distributed`` process group, every rank
holds the same dataset; ``build_backend="distributed"`` splits the
ExtVP build across the ranks of ``group`` (None: the default group),
and ``ds.engine("distributed")`` serves over them:

    dist.init_process_group("nccl", init_method=..., rank=r, world_size=w)
    ds = Dataset.watdiv(scale=34, threshold=0.25,
                        build_backend="distributed")
    rows = ds.engine("distributed").query(q).to_terms()   # on every rank
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.stats import Catalog, _m2, build_catalog
from repro_torch.core.table import Table
from repro_torch.core.vp import KINDS, ExtVPBuild
from repro_torch.engine.engine import Engine, resolve_device

__all__ = ["Dataset"]


@dataclass
class Dataset:
    """A loaded RDF graph: dictionary + TT + VP + ExtVP(τ) + statistics,
    and the device its engines (and its ``"torch"`` builds) run on.

    ``build_backend`` selects the ExtVP build — ``"torch"``, the
    pair-batched build on ``device``, ``"numpy"``, the host loop, or
    ``"distributed"``, the ``"torch"`` build split across the ranks of
    the process group ``group`` (:mod:`repro_torch.core.extvp_build`);
    all build byte-identical catalogs, and the choice also seeds
    :meth:`append_triples`.  ``group`` (None: the default group) is
    also the default group of the dataset's distributed engines.
    """

    catalog: Catalog
    dictionary: object = None          # repro_torch.rdf.Dictionary
    schema: object = None              # Optional[WatDivSchema]
    device: torch.device = None
    build_backend: str = "torch"
    group: object = None
    #: directory of the on-disk store this dataset is attached to (set by
    #: :meth:`load` / :meth:`save`); appends journal delta segments there
    store_path: Optional[str] = field(default=None, repr=False)
    _engines: Dict[tuple, Engine] = field(default_factory=dict, repr=False)
    #: accounting of the last append_triples call (pairs reused vs rebuilt)
    last_append_report: Optional[Dict[str, int]] = field(default=None,
                                                         repr=False)

    def __post_init__(self) -> None:
        if self.dictionary is None:
            self.dictionary = self.catalog.dictionary
        self.device = resolve_device(self.device)

    # -- constructors ---------------------------------------------------------
    @classmethod
    def from_triples(cls, triples: Iterable[Tuple[str, str, str]],
                     threshold: float = 1.0,
                     kinds: Tuple[str, ...] = KINDS,
                     with_extvp: bool = True,
                     build_backend: str = "torch",
                     device=None, group=None) -> "Dataset":
        """Build the full store from (s, p, o) string triples."""
        from repro_torch.rdf.dictionary import Dictionary
        device = resolve_device(device)
        d = Dictionary()
        tt = d.encode_triples(list(triples))
        cat = build_catalog(tt, d, threshold=threshold, kinds=kinds,
                            with_extvp=with_extvp,
                            build_backend=build_backend, device=device,
                            group=group)
        return cls(catalog=cat, dictionary=d, device=device,
                   build_backend=build_backend, group=group)

    @classmethod
    def watdiv(cls, scale: float = 1.0, seed: int = 0,
               threshold: float = 1.0,
               kinds: Tuple[str, ...] = KINDS,
               with_extvp: bool = True,
               build_backend: str = "torch",
               device=None, group=None) -> "Dataset":
        """Generate a WatDiv-like graph (paper §7) and build its store."""
        from repro_torch.rdf.generator import WatDivConfig, generate_watdiv
        device = resolve_device(device)
        tt, d, sch = generate_watdiv(WatDivConfig(scale_factor=scale,
                                                  seed=seed))
        cat = build_catalog(tt, d, threshold=threshold, kinds=kinds,
                            with_extvp=with_extvp,
                            build_backend=build_backend, device=device,
                            group=group)
        return cls(catalog=cat, dictionary=d, schema=sch, device=device,
                   build_backend=build_backend, group=group)

    @classmethod
    def from_ntriples(cls, path: str, threshold: float = 1.0,
                      kinds: Tuple[str, ...] = KINDS,
                      with_extvp: bool = True,
                      build_backend: str = "torch",
                      device=None, group=None) -> "Dataset":
        """Load an N-Triples file (the paper's input format)."""
        from repro_torch.rdf.ntriples import parse_ntriples
        with open(path) as f:
            triples = parse_ntriples(f.read())
        return cls.from_triples(triples, threshold=threshold, kinds=kinds,
                                with_extvp=with_extvp,
                                build_backend=build_backend, device=device,
                                group=group)

    # -- incremental load -----------------------------------------------------
    def append_triples(self, triples: Iterable[Tuple[str, str, str]],
                       journal: bool = True) -> Dict[str, int]:
        """Append (s, p, o) string triples and incrementally refresh the
        store: only the VP tables of predicates that received rows are
        rebuilt, and only the ExtVP pairs those predicates touch — or
        whose probe-side entity range the new build keys intersect — are
        re-semi-joined (:func:`repro_torch.core.extvp_build
        .incremental_pairs`) with the dataset's ``build_backend``, on its
        device for the ``"torch"`` build and across the ranks of its
        ``group`` for the ``"distributed"`` one (every rank then appends
        the same triples).  The resulting catalog is equivalent to a
        from-scratch build over the concatenated triples.

        Cached engines are dropped, and with them the tables they hold
        on their device (their prepared plans scan the old tables);
        re-fetch them via :meth:`engine` afterwards.  Returns the
        pair-accounting report, also kept as ``last_append_report``.

        When the dataset is attached to an on-disk store (``store_path``
        set by :meth:`load` / :meth:`save`), the appended triples are
        also journaled as a delta segment so the next :meth:`load`
        replays them through this same incremental path;
        ``journal=False`` suppresses that (used by replay itself).
        :meth:`compact` folds accumulated segments back into the base.
        """
        triples = list(triples)
        cat = self.catalog
        if not triples:
            report = {"pairs": len(cat.extvp.sf), "reused": len(cat.extvp.sf),
                      "range_skipped": 0, "recomputed": 0, "evaluated": 0}
            self.last_append_report = report
            return report
        from repro_torch.core.extvp_build import incremental_pairs
        new_tt = self.dictionary.encode_triples(triples)
        tt = np.concatenate([cat.tt, new_tt])
        touched = {int(p) for p in np.unique(new_tt[:, 1])}

        t0 = time.perf_counter()
        vp = dict(cat.vp)
        for p in sorted(touched):
            rows = new_tt[new_tt[:, 1] == p][:, [0, 2]]
            if p in vp:
                rows = np.concatenate([vp[p].rows, rows])
            vp[p] = Table.from_unsorted(rows)
        # distinct-count statistics: recompute only the touched predicates
        # (their tables are materialized above anyway); catalogs without
        # the stats (version-1 stores) stay without them — back-filling
        # would force-load every lazy table
        distinct_s = distinct_o = m2_s = m2_o = None
        if cat.distinct_s is not None and cat.distinct_o is not None:
            distinct_s, distinct_o = dict(cat.distinct_s), dict(cat.distinct_o)
            for p in touched:
                distinct_s[p] = int(len(vp[p].unique_s))
                distinct_o[p] = int(len(vp[p].unique_o))
        if cat.m2_s is not None and cat.m2_o is not None:
            m2_s, m2_o = dict(cat.m2_s), dict(cat.m2_o)
            for p in touched:
                m2_s[p] = _m2(vp[p].rows[:, 0])
                m2_o[p] = _m2(vp[p].rows[:, 1])
        vp_secs = cat.vp_build_seconds + (time.perf_counter() - t0)

        # A store built with with_extvp=False has no pair statistics to
        # extend — keep it ExtVP-less instead of back-filling the schema.
        t0 = time.perf_counter()
        if cat.with_extvp:
            ext, report = incremental_pairs(
                cat.extvp, cat.vp, vp, touched,
                threshold=cat.extvp.threshold, kinds=tuple(cat.extvp.kinds),
                backend=self.build_backend, device=self.device,
                group=self.group)
        else:
            ext = ExtVPBuild(threshold=cat.extvp.threshold,
                             kinds=tuple(cat.extvp.kinds),
                             backend=self.build_backend)
            report = {"pairs": 0, "reused": 0, "range_skipped": 0,
                      "recomputed": 0, "evaluated": 0}
        ext.build_seconds = time.perf_counter() - t0
        self.catalog = Catalog(tt=tt, vp=vp, extvp=ext,
                               dictionary=self.dictionary,
                               vp_build_seconds=vp_secs,
                               with_extvp=cat.with_extvp,
                               store=cat.store,
                               distinct_s=distinct_s, distinct_o=distinct_o,
                               m2_s=m2_s, m2_o=m2_o)
        self._engines.clear()
        self.last_append_report = report
        if journal and self.store_path is not None:
            from repro_torch.store import append_segment, delta_stats
            append_segment(self.store_path, triples)
            if self.catalog.store is not None:
                n, nbytes = delta_stats(self.store_path)
                self.catalog.store.delta_segments = n
                self.catalog.store.bytes_by_section["delta"] = nbytes
        return report

    # -- persistence (repro_torch.store) --------------------------------------
    def save(self, path: Optional[str] = None) -> str:
        """Persist the catalog as an on-disk columnar store at ``path``
        (defaults to the attached ``store_path``).

        Writes the versioned manifest, the dictionary, and raw
        little-endian column files for TT / every VP table / every
        materialized ExtVP table via the streaming writer
        (:func:`repro_torch.store.write_store`), then clears any delta
        journal at the target — the rewritten base supersedes it.  The
        dataset becomes attached to ``path``: later :meth:`append_triples`
        calls journal there and :meth:`load` restores this exact state.
        """
        path = os.fspath(path) if path is not None else self.store_path
        if path is None:
            raise ValueError("no path: pass save(path) or load the dataset "
                             "from a store first")
        from repro_torch.store import (StoreInfo, clear_segments,
                                       section_bytes, write_store)
        manifest = write_store(self.catalog, self.dictionary, path,
                               build_backend=self.build_backend)
        clear_segments(path)
        self.catalog.store = StoreInfo(
            path=path, bytes_by_section=section_bytes(manifest, path),
            delta_segments=0)
        self.store_path = path
        return path

    @classmethod
    def load(cls, path: str, eager: bool = False, verify: bool = False,
             device=None) -> "Dataset":
        """Boot a dataset from an on-disk store — no build pipeline runs.

        The base catalog comes up **lazy and zero-copy** by default:
        only the manifest (statistics + dictionary) is parsed, and each
        table ``np.memmap``-s its column file on first touch.
        ``eager=True`` materializes everything now; ``verify=True``
        CRC-checks each file when it is first read.  Any journaled delta
        segments are then replayed through :meth:`append_triples` (the
        incremental semi-join path, the ``"torch"`` build on ``device``),
        so the result is equivalent to the pre-restart catalog.
        """
        from repro_torch.store import load_catalog, read_segments
        path = os.fspath(path)
        device = resolve_device(device)
        cat, dictionary = load_catalog(path, eager=eager, verify=verify)
        ds = cls(catalog=cat, dictionary=dictionary, device=device,
                 store_path=path)
        for seg in read_segments(path):
            ds.append_triples(seg.triples, journal=False)
        return ds

    def compact(self) -> str:
        """Fold the delta journal into the base store: rewrite the full
        columnar base from the current (already replayed/appended)
        catalog and drop the segments."""
        if self.store_path is None:
            raise ValueError("dataset is not attached to a store; "
                             "call save(path) first")
        return self.save(self.store_path)

    # -- engines --------------------------------------------------------------
    def engine(self, backend: str = "torch", device=None,
               layout: str = "extvp", planner: Optional[str] = None,
               plan_cache_size: int = 512, group=None,
               dual_partition: bool = False, batch_shapes=None,
               runtime=None) -> Engine:
        """An :class:`Engine` over this dataset.  ``backend`` is
        ``"eager"``, ``"torch"``, ``"distributed"`` or ``"auto"`` (the
        adaptive runtime: each template measured on every candidate
        backend and routed to the observed winner; the distributed
        backend is a candidate when a group is given).  ``device=None``
        means the dataset's device, ``group=None`` the dataset's group
        (of the ``"distributed"`` backend); ``layout`` is the storage
        schema (``"extvp"``, ``"vp"``, ``"tt"``, ``"pt"``);
        ``planner=None`` reads the planner from ``runtime`` (a
        :class:`~repro_torch.runtime.RuntimeConfig`, ``None`` meaning the
        process-wide default), ``batch_shapes=None`` the batch-shape
        menu.

        Engines on the default config are cached per configuration, so
        repeated calls share plan caches.  An engine given its own
        ``runtime`` is not cached: it holds its device tables only as
        long as its caller holds it."""
        dev = resolve_device(self.device if device is None else device)
        group = self.group if group is None else group
        key = (backend, str(dev), layout, planner, plan_cache_size,
               id(group), dual_partition,
               None if batch_shapes is None else tuple(batch_shapes))
        eng = None if runtime is not None else self._engines.get(key)
        if eng is None:
            eng = Engine(self, backend=backend, device=dev, layout=layout,
                         planner=planner, plan_cache_size=plan_cache_size,
                         group=group, dual_partition=dual_partition,
                         batch_shapes=batch_shapes, runtime=runtime)
            if runtime is None:
                self._engines[key] = eng
        return eng

    @property
    def n_triples(self) -> int:
        return self.catalog.n_triples

    def storage_report(self) -> Dict[str, float]:
        return self.catalog.storage_report()

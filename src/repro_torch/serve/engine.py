"""Batched SPARQL serving front end — a thin shell over
:class:`repro_torch.engine.Engine` plus a micro-batching request queue.

* **Plan cache.**  Parsing and Algorithm-1/4 compilation are
  per-template work; a served workload repeats templates with different
  constants, so prepared queries are cached in a bounded LRU on the
  template signature and the constants re-bind as runtime inputs (we
  cache compilation, never results).
* **Micro-batching.**  ``submit()`` enqueues a request; a
  :class:`~repro_torch.serve.batcher.MicroBatcher` groups same-template
  requests into size/latency-bounded buckets, runs each bucket through
  one ``run_batch`` call, and demuxes per-request results.  ``query()``
  stays the immediate single-request path.
* **Statistics short-circuit.**  Provably-empty plans are answered
  without touching data and counted in the metrics.
* **Engine selection.**  ``"eager"`` (the host numpy engine),
  ``"torch"`` (one device), ``"distributed"`` (a process group) — or
  ``"auto"``, which routes each template to the backend its measured
  latencies favor (:mod:`repro_torch.runtime`; ``runtime_report()``
  shows every decision).
* **Metrics.**  Latency percentiles, plan-cache hit rate, empty-answer
  count, rows served, batch occupancy and queue latency, the Prometheus
  exposition, and span traces (``runtime.trace_sample_rate``).

The server runs on ``"cuda"`` unless ``device="cpu"`` is passed; with
``backend="distributed"`` every rank of the process group runs one, fed
the same requests in the same order (see
:mod:`repro_torch.serve.batcher` for the flush rule there).
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Union

from repro_torch.core.stats import Catalog
from repro_torch.device import resolve_device
from repro_torch.engine import Dataset, Engine, Result, template_signature
from repro_torch.engine.backends import available_backends, create_backend
from repro_torch.engine.engine import ServerMetrics
from repro_torch.serve.batcher import MicroBatcher, PendingQuery

__all__ = ["SparqlServer", "ServerMetrics", "MicroBatcher", "PendingQuery",
           "template_signature"]


class SparqlServer:
    """Serve SPARQL queries over a loaded ExtVP catalog.

    ``source`` is a catalog-bearing :class:`~repro_torch.engine.Dataset`,
    a :class:`~repro_torch.core.stats.Catalog`, or a **store path** (str /
    PathLike): the server then boots from the persistent columnar store
    through ``Dataset.load`` — lazy and memory-mapped (``eager_load``
    materializes every table at boot, ``verify_store`` CRC-checks each
    file on first read) — without touching the build pipeline.

    ``max_batch`` / ``flush_ms`` default to the runtime config's knobs,
    ``runtime.planner`` selects the planner, and ``batch_shapes`` (else
    ``runtime.batch_shapes``) is the batch-shape menu.
    ``device=None`` means the dataset's device for a Dataset and
    ``"cuda"`` otherwise.
    """

    def __init__(self, source: Union[Dataset, Catalog, str, os.PathLike],
                 layout: str = "extvp", backend: str = "torch",
                 device=None, plan_cache_size: int = 512,
                 max_batch: Optional[int] = None,
                 flush_ms: Optional[float] = None,
                 eager_load: bool = False, verify_store: bool = False,
                 batch_shapes: Optional[Sequence[int]] = None,
                 runtime=None):
        # checked before the store boots: a server must not load a
        # catalog for a backend it cannot run
        if backend != "auto" and backend not in available_backends():
            create_backend(backend)     # raises: unknown backend
        if isinstance(source, (str, os.PathLike)):
            self.dataset = Dataset.load(source, eager=eager_load,
                                        verify=verify_store,
                                        device=resolve_device(device))
        elif isinstance(source, Catalog):
            self.dataset = Dataset(catalog=source,
                                   dictionary=source.dictionary,
                                   device=resolve_device(device))
        else:
            self.dataset = source
        self.engine: Engine = self.dataset.engine(
            backend, device=device, layout=layout,
            plan_cache_size=plan_cache_size, batch_shapes=batch_shapes,
            runtime=runtime)
        cfg = self.engine.config
        self.batcher = MicroBatcher(
            self.engine,
            max_batch=cfg.max_batch if max_batch is None else max_batch,
            flush_ms=cfg.flush_ms if flush_ms is None else flush_ms)

    @property
    def metrics(self) -> ServerMetrics:
        return self.engine.metrics

    def runtime_report(self):
        """Snapshot of the adaptive runtime: per-template routing state,
        batch-shape menu and per-bucket stats, knob values, and the
        serving metrics."""
        return self.engine.runtime_report()

    # -- public API ----------------------------------------------------------------
    def query(self, qtext: str) -> Result:
        """Immediate single-request execution (no queueing)."""
        return self.engine.query(qtext)

    def submit(self, qtext: str) -> PendingQuery:
        """Enqueue a request for micro-batched execution; resolve the
        returned handle with ``.result()`` (forces its bucket) or drain
        everything with :meth:`flush`."""
        return self.batcher.submit(qtext)

    def flush(self) -> int:
        """Drain all queued requests; returns how many were served."""
        return self.batcher.flush()

    def query_batch(self, qtexts: List[str]) -> List[Result]:
        """Serve a request list through the micro-batcher: same-template
        requests share one launch; results in submission order."""
        tickets = [self.batcher.submit(q) for q in qtexts]
        self.batcher.flush()
        return [t.result() for t in tickets]

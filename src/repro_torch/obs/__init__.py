"""Low-overhead observability: spans, flight recorder, histograms.

The serving layer's evidence plane, a copy of the reference package's
``obs`` (same bucket edges, export formats and metric names, and the
reference's span names), all wired through
:class:`~repro_torch.runtime.config.RuntimeConfig` knobs
(``REPRO_RT_TRACE_*``) and costing ~nothing when off:

* :mod:`repro_torch.obs.tracer` — per-request span traces with
  deterministic stride sampling (``trace_sample_rate``), carried by
  argument through ``Engine.query``/``query_batch``, the micro-batcher,
  prepared queries and both executors.  Beyond the reference's spans
  the port records ``submit`` and ``flush`` (the batcher), ``front``
  (the engine's routing, plan lookup and binding), ``head_sync`` (the
  host waiting on the stream inside ``device.launch``) and ``copyback``
  (the answers' rows to the host, with their ``bytes``); ``queue`` is a
  wait kept off the span stack; and while ``torch.profiler`` records,
  every host-work span opens a ``repro.<span>`` range (and the
  tracer's recording of a finished trace a ``repro.finish`` range), so
  the device trace names the card's idle time by program stage
  (``docs/observability_torch.md``);
* :mod:`repro_torch.obs.recorder` — the flight recorder: a ring of the
  last N complete traces plus a slow-query reservoir, exportable as
  Chrome ``chrome://tracing`` JSON and JSONL (``tools/trace_inspect.py``,
  ``launch/serve.py --trace-dump``);
* :mod:`repro_torch.obs.histogram` — O(1)-memory log-bucketed latency
  histograms backing ``ServerMetrics`` percentiles and the Prometheus
  text exposition (:mod:`repro_torch.obs.prometheus`,
  ``ServerMetrics.prometheus()``, ``launch/serve.py --metrics-out``);
* :mod:`repro_torch.obs.counters` — what a run moves: the collectives
  the executors issue (``record`` / ``note``) and the bytes of its aten
  operators (``OpCounter``), read by the dry run (``launch/dryrun.py``).
"""

from repro_torch.obs.histogram import LogHistogram
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.tracer import Span, TraceContext, Tracer

__all__ = ["LogHistogram", "FlightRecorder", "Span", "TraceContext",
           "Tracer"]

"""Low-overhead observability: spans, flight recorder, histograms.

The serving layer's evidence plane, a copy of the reference package's
``obs`` (same span names, bucket edges, export formats and metric
names), all wired through
:class:`~repro_torch.runtime.config.RuntimeConfig` knobs
(``REPRO_RT_TRACE_*``) and costing ~nothing when off:

* :mod:`repro_torch.obs.tracer` — per-request span traces with
  deterministic stride sampling (``trace_sample_rate``), carried by
  argument through ``Engine.query``/``query_batch``, the micro-batcher,
  prepared queries and both executors;
* :mod:`repro_torch.obs.recorder` — the flight recorder: a ring of the
  last N complete traces plus a slow-query reservoir, exportable as
  Chrome ``chrome://tracing`` JSON and JSONL (``tools/trace_inspect.py``,
  ``launch/serve.py --trace-dump``);
* :mod:`repro_torch.obs.histogram` — O(1)-memory log-bucketed latency
  histograms backing ``ServerMetrics`` percentiles and the Prometheus
  text exposition (:mod:`repro_torch.obs.prometheus`,
  ``ServerMetrics.prometheus()``, ``launch/serve.py --metrics-out``).
"""

from repro_torch.obs.histogram import LogHistogram
from repro_torch.obs.recorder import FlightRecorder
from repro_torch.obs.tracer import Span, TraceContext, Tracer

__all__ = ["LogHistogram", "FlightRecorder", "Span", "TraceContext",
           "Tracer"]

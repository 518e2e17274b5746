"""Prometheus text-exposition rendering of the serving metrics.

Renders a :class:`~repro_torch.engine.engine.ServerMetrics` (duck-typed —
this module must not import the engine, the engine imports *it*) into
the Prometheus text exposition format: counters for every request-path
count, histograms for request/queue latency from the
:class:`~repro_torch.obs.histogram.LogHistogram`s, per-stage span
histograms from the tracer's aggregates, and router/tuner state as
labelled gauges.  The names are the reference package's
(docs/observability.md):

* ``repro_served_total``, ``repro_rows_total``, ``repro_empties_total``,
  ``repro_short_circuits_total``, ``repro_device_fallbacks_total``,
  ``repro_plan_hits_total``, ``repro_plan_misses_total``,
  ``repro_batches_total``, ``repro_batched_requests_total``,
  ``repro_padding_slots_total``
* ``repro_routed_total{backend=...}``
* ``repro_request_latency_ms`` / ``repro_queue_ms`` (histograms)
* ``repro_stage_ms{stage=...}`` (histogram per span name)
* ``repro_traces_total{state=started|finished|sampled_out}``
* ``repro_router_ewma_ms{sig=...,backend=...}``,
  ``repro_router_requests{sig=...}``
* ``repro_tuner_per_slot_ms{shape=...}``,
  ``repro_tuner_occupancy{shape=...}``,
  ``repro_tuner_shape_active{shape=...}``
"""

from __future__ import annotations

from typing import Dict, List, Optional

from repro_torch.obs.histogram import LogHistogram

__all__ = ["render"]


def _esc(v: object) -> str:
    return str(v).replace("\\", r"\\").replace('"', r'\"') \
        .replace("\n", r"\n")


def _labels(kv: Dict[str, object]) -> str:
    if not kv:
        return ""
    inner = ",".join(f'{k}="{_esc(v)}"' for k, v in kv.items())
    return "{" + inner + "}"


def _counter(lines: List[str], name: str, value, help_: str,
             label_values: Optional[Dict[str, Dict[str, object]]] = None,
             kind: str = "counter") -> None:
    lines.append(f"# HELP {name} {help_}")
    lines.append(f"# TYPE {name} {kind}")
    if label_values is None:
        lines.append(f"{name} {value}")
    else:
        for labels, v in label_values.items():
            lines.append(f"{name}{labels} {v}")


def _histogram(lines: List[str], name: str, hist: LogHistogram,
               help_: str, labels: Optional[Dict[str, object]] = None
               ) -> None:
    labels = labels or {}
    lines.append(f"# HELP {name} {help_}")
    lines.append(f"# TYPE {name} histogram")
    for edge, cum in hist.cumulative_buckets():
        le = "+Inf" if edge == float("inf") else f"{edge:.6g}"
        lines.append(f"{name}_bucket{_labels({**labels, 'le': le})} {cum}")
    lines.append(f"{name}_bucket{_labels({**labels, 'le': '+Inf'})} "
                 f"{hist.count}")
    lines.append(f"{name}_sum{_labels(labels)} {hist.sum_ms:.6g}")
    lines.append(f"{name}_count{_labels(labels)} {hist.count}")


def render(metrics) -> str:
    """The full exposition page for one engine's ``ServerMetrics``."""
    lines: List[str] = []
    for attr, help_ in (
            ("served", "requests answered"),
            ("rows", "result rows returned"),
            ("empties", "zero-row answers"),
            ("short_circuits", "answers from statistics alone"),
            ("device_fallbacks", "requests served via eager fallback"),
            ("plan_hits", "plan-cache hits"),
            ("plan_misses", "plan-cache misses"),
            ("batches", "batched device launches"),
            ("batched_requests", "requests served through a batch"),
            ("padding_slots", "batch slots wasted on padding")):
        _counter(lines, f"repro_{attr}_total", getattr(metrics, attr),
                 help_)
    routed = getattr(metrics, "routed", {}) or {}
    if routed:
        _counter(lines, "repro_routed_total", None,
                 "requests per executing backend",
                 {_labels({"backend": b}): n
                  for b, n in sorted(routed.items())})
    _histogram(lines, "repro_request_latency_ms", metrics.latency_hist,
               "end-to-end request latency (ms)")
    _histogram(lines, "repro_queue_ms", metrics.queue_hist,
               "micro-batch queue wait, submit to result (ms)")

    tracer = getattr(metrics, "tracer", None)
    if tracer is not None:
        _counter(lines, "repro_traces_total", None,
                 "trace lifecycle counts",
                 {_labels({"state": s}): getattr(tracer, s)
                  for s in ("started", "finished", "sampled_out")})
        for stage in sorted(tracer.stage_hist):
            _histogram(lines, "repro_stage_ms", tracer.stage_hist[stage],
                       "per-stage span duration (ms)", {"stage": stage})

    report = metrics.runtime_report()
    router = report.get("router") if isinstance(report, dict) else None
    if router:
        ewma_rows: Dict[str, object] = {}
        req_rows: Dict[str, object] = {}
        for sig, st in router.get("signatures", {}).items():
            req_rows[_labels({"sig": sig})] = st.get("requests", 0)
            for backend, ms in st.get("ewma_ms", {}).items():
                ewma_rows[_labels({"sig": sig, "backend": backend})] = ms
        if req_rows:
            _counter(lines, "repro_router_requests", None,
                     "requests routed per template signature", req_rows)
        if ewma_rows:
            _counter(lines, "repro_router_ewma_ms", None,
                     "router latency estimate per (signature, backend)",
                     ewma_rows, kind="gauge")
    tuner = report.get("tuner") if isinstance(report, dict) else None
    if tuner:
        active = set(tuner.get("active", []))
        slot_rows: Dict[str, object] = {}
        occ_rows: Dict[str, object] = {}
        act_rows: Dict[str, object] = {}
        for shape, st in tuner.get("buckets", {}).items():
            act_rows[_labels({"shape": shape})] = \
                int(int(shape) in active)
            if st.get("per_slot_ms") is not None:
                slot_rows[_labels({"shape": shape})] = st["per_slot_ms"]
            if st.get("occupancy") is not None:
                occ_rows[_labels({"shape": shape})] = st["occupancy"]
        if act_rows:
            _counter(lines, "repro_tuner_shape_active", None,
                     "1 when the batch shape is still in the menu",
                     act_rows, kind="gauge")
        if slot_rows:
            _counter(lines, "repro_tuner_per_slot_ms", None,
                     "EWMA per-slot launch time per batch shape",
                     slot_rows, kind="gauge")
        if occ_rows:
            _counter(lines, "repro_tuner_occupancy", None,
                     "EWMA live-slot fraction per batch shape",
                     occ_rows, kind="gauge")
    return "\n".join(lines) + "\n"

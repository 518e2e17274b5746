"""The query engine: template LRU cache over the torch backend.

``Engine`` is the public execution surface.  It owns

* a bounded LRU plan cache keyed on the template signature (prefixed
  ``planner=<p>::`` for a non-greedy planner) — each entry holds the
  backend's :class:`~repro_torch.engine.backends.PreparedQuery` (parsed
  template, compiled plan, executor with its device-resident tables), so
  a repeated templated query is served with zero parsing and zero
  compilation: its constants re-bind as runtime inputs;
* the statistics short-circuit (provably-empty plans and constants
  missing from the dictionary are answered without touching data);
* ``query_batch``: same-template requests grouped by signature and run
  through one batched launch per chunk of at most ``MAX_BATCH``;
* operator metrics (:class:`ServerMetrics`): latency and queue
  histograms, plan-cache hit rate, empty answers, rows served, batches,
  the Prometheus exposition;
* span tracing (:mod:`repro_torch.obs`), inert until the runtime
  config's ``trace_sample_rate`` is above 0, and ``explain()``.

Two backends: ``"torch"`` runs on one device, ``"distributed"`` on
every rank of a ``torch.distributed`` process group (each rank builds
the same engine and sends the same queries in the same order).

S2RDF notes that repeated Virtuoso queries benefit from caching while its
own runtimes are stable: here we cache *compilation*, never results.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch.distributed as dist

from repro_torch.core.algebra import BGP
from repro_torch.core.modifiers import peel_spine
from repro_torch.device import resolve_device
from repro_torch.engine.backends import (
    DistributedBackend, ExecutionContext, PreparedQuery, TorchBackend,
)
from repro_torch.engine.result import Result
from repro_torch.engine.template import (
    QueryTemplate, _normalize, rebind_plan, template_signature,
)
from repro_torch.obs import LogHistogram, Tracer
from repro_torch.obs.tracer import TraceContext
from repro_torch.runtime import RuntimeConfig
from repro_torch.runtime.config import runtime_config as _global_runtime_config

__all__ = ["Engine", "ServerMetrics", "PlanCache", "resolve_device",
           "LAYOUTS"]

#: storage schemas a plan can compile for (paper §4); ``"pt"`` (the
#: property table) runs on a host engine the port does not have, so its
#: templates raise NotImplementedError and count as device fallbacks
LAYOUTS = ("extvp", "vp", "tt", "pt")

# cardinality-drift reports cached per (prepared, binding): a hot
# template's repeated traces must not re-run the host joins every time
_DRIFT_CACHE_SIZE = 1024


def _flat_bgp(prepared: PreparedQuery) -> bool:
    """Whether the template's core under its solution modifiers is one
    BGP (the only shape whose steps join in sequence)."""
    return isinstance(peel_spine(prepared.template.query)[0], BGP)


@dataclass
class ServerMetrics:
    served: int = 0
    rows: int = 0
    empties: int = 0          # zero-row answers, however produced
    short_circuits: int = 0   # answered from statistics alone (no data touched)
    # templates the device path cannot serve (the request raised): the
    # reference would serve them on its host engine
    device_fallbacks: int = 0
    plan_hits: int = 0
    plan_misses: int = 0
    # micro-batching: one "batch" is one run_batch call serving B requests
    batches: int = 0          # batched launches executed
    batched_requests: int = 0 # requests served through a batched launch
    # slots wasted padding up to a static shape: always 0 here, since
    # the executor runs each binding of a batch in turn and nothing pads
    padding_slots: int = 0
    # requests per backend executed on (one key on a static engine)
    routed: Dict[str, int] = field(default_factory=dict)

    # Attached by the owning Engine: lets the Prometheus renderer expose
    # per-stage span histograms without a reference to the engine.
    tracer: Optional[Tracer] = None

    def __post_init__(self) -> None:
        # O(1) memory, O(1) record, exact counts, mergeable
        self.latency_hist = LogHistogram()
        self.queue_hist = LogHistogram()

    def record_route(self, backend: str, count: int = 1) -> None:
        self.routed[backend] = self.routed.get(backend, 0) + count

    def record_latency(self, ms: float, count: int = 1) -> None:
        self.latency_hist.record(ms, count)

    def record_queue(self, ms: float) -> None:
        self.queue_hist.record(ms)

    def summary(self) -> Dict[str, object]:
        """Operator summary.  Percentiles are ``None`` (not a fabricated
        0.0) until at least one sample exists, so a dashboard can tell
        "idle" from "fast"."""
        slots = self.batched_requests + self.padding_slots
        lat, qms = self.latency_hist, self.queue_hist
        return {
            "served": self.served,
            "rows": self.rows,
            "empties": self.empties,
            "short_circuits": self.short_circuits,
            "device_fallbacks": self.device_fallbacks,
            "plan_hit_rate": self.plan_hits / max(self.plan_hits
                                                  + self.plan_misses, 1),
            "p50_ms": lat.percentile(50),
            "p90_ms": lat.percentile(90),
            "p99_ms": lat.percentile(99),
            "batches": self.batches,
            "batched_requests": self.batched_requests,
            # fraction of launched batch slots carrying real requests
            "batch_occupancy": self.batched_requests / max(slots, 1),
            "padding_waste": self.padding_slots / max(slots, 1),
            "queue_p50_ms": qms.percentile(50),
            "queue_p99_ms": qms.percentile(99),
            "routed": dict(self.routed),
        }

    def prometheus(self) -> str:
        """This metrics object in the Prometheus text exposition format
        (counters, latency/queue/per-stage histograms) — see
        :mod:`repro_torch.obs.prometheus`."""
        from repro_torch.obs.prometheus import render
        return render(self)


class PlanCache:
    """Bounded LRU: cache key -> PreparedQuery."""

    def __init__(self, capacity: int = 512):
        self.capacity = max(1, int(capacity))
        self._data: "OrderedDict[str, PreparedQuery]" = OrderedDict()
        self.evictions = 0

    def get(self, key: str) -> Optional[PreparedQuery]:
        hit = self._data.get(key)
        if hit is not None:
            self._data.move_to_end(key)
        return hit

    def put(self, key: str, prepared: PreparedQuery) -> None:
        self._data[key] = prepared
        self._data.move_to_end(key)
        while len(self._data) > self.capacity:
            self._data.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def keys(self):
        return self._data.keys()


class Engine:
    """Execute SPARQL text over a Dataset.

    ``backend`` is ``"torch"`` (one device) or ``"distributed"`` (the
    ranks of the process group ``group``, ``None`` meaning the default
    group, which must be initialized; ``dual_partition`` adds the
    object-partitioned table copies); ``device`` is where this process's
    executors run — ``None`` means ``"cuda"``.  ``layout`` is the storage
    schema plans compile for (:data:`LAYOUTS`).  ``runtime`` is the
    :class:`~repro_torch.runtime.RuntimeConfig` (``None``: the
    process-wide default) whose knobs and clock the engine reads;
    ``planner``, when given, overrides ``runtime.planner``.
    """

    #: Most requests of one template in one batched launch.  Nothing is
    #: padded: the executor runs each binding of a launch in turn, so a
    #: padded slot would cost a whole query and buy no fixed shape.
    MAX_BATCH: int = 32

    def __init__(self, dataset, backend: str = "torch", device=None,
                 layout: str = "extvp", planner: Optional[str] = None,
                 plan_cache_size: int = 512, group=None,
                 dual_partition: bool = False,
                 runtime: Optional[RuntimeConfig] = None):
        names = [TorchBackend.name, DistributedBackend.name]
        if backend not in names:
            raise ValueError(f"unknown backend {backend!r}; available: "
                             f"{names}")
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; available: "
                             f"{list(LAYOUTS)}")
        if planner not in (None, "greedy", "estimate"):
            raise ValueError(f"unknown planner {planner!r}; expected "
                             "'greedy' or 'estimate'")
        if backend == DistributedBackend.name:
            if not dist.is_available() or not dist.is_initialized():
                raise ValueError(
                    "the distributed backend needs an initialized process "
                    "group: call torch.distributed.init_process_group(...) "
                    "first (nccl on the card, gloo on the CPU)")
            self._backend = DistributedBackend(dual_partition)
        elif dual_partition:
            raise ValueError("dual_partition applies to the distributed "
                             "backend only")
        else:
            self._backend = TorchBackend()
        self.device = resolve_device(device)
        # engines without an explicit runtime= share the process-wide
        # default instance
        self.config = runtime if runtime is not None else \
            _global_runtime_config
        self._planner_override = planner
        self.dataset = dataset
        self.layout = layout
        self.ctx = ExecutionContext(catalog=dataset.catalog,
                                    dictionary=dataset.dictionary,
                                    layout=layout, planner=self.planner,
                                    device=self.device, group=group)
        self.cache = PlanCache(plan_cache_size)
        self.metrics = ServerMetrics()
        #: span tracing (repro_torch.obs) — inert until the config's
        #: ``trace_sample_rate`` knob is > 0 (the hot path's only cost is
        #: the ``tracer.active`` guard)
        self.tracer = Tracer(self.config)
        self.metrics.tracer = self.tracer
        self._drift_cache: "OrderedDict" = OrderedDict()

    @property
    def backend(self) -> str:
        return self._backend.name

    @property
    def planner(self) -> str:
        """The join-order planner: the ``planner=`` the engine was built
        with, else the live ``config.planner`` (read on every use, so
        flipping it mid-session re-plans; the cache key includes it)."""
        if self._planner_override is not None:
            return self._planner_override
        return self.config.planner

    # -- compilation ----------------------------------------------------------
    def _cache_key(self, sig: str) -> str:
        # plans compiled under different join-order planners are
        # different artifacts and must never shadow each other
        planner = self.planner
        return sig if planner == "greedy" else f"planner={planner}::{sig}"

    def _lookup(self, qtext: str, sig: str) -> Optional[PreparedQuery]:
        prepared = self.cache.get(self._cache_key(sig))
        if prepared is not None:
            return prepared
        # Non-rebindable templates (e.g. a constant in predicate position)
        # are cached under the exact normalized text instead.
        return self.cache.get(self._cache_key("=" + _normalize(qtext)))

    def _build(self, qtext: str, sig: str,
               trace: Optional[TraceContext] = None) -> PreparedQuery:
        self.ctx.planner = self.planner
        sid = trace.start("parse") if trace is not None else None
        try:
            template = QueryTemplate(qtext, self.ctx.dictionary)
        except ValueError:
            # template substitution produced unparseable text; fall back
            # to the concrete query (a malformed query raises from there)
            template = None
        if template is None or not template.rebindable:
            template = QueryTemplate.concrete(qtext, self.ctx.dictionary)
        if trace is not None:
            trace.end(sid, rebindable=template.rebindable)
            sid = trace.start("plan", backend=self.backend,
                              planner=self.planner)
        try:
            prepared = self._backend.prepare(template, self.ctx)
        except NotImplementedError:
            # the reference would serve this template on its host engine;
            # the port has none, so the request fails and is counted
            self.metrics.device_fallbacks += 1
            raise
        if trace is not None:
            trace.end(sid, fallback=False)
        key = sig if template.rebindable else "=" + _normalize(qtext)
        self.cache.put(self._cache_key(key), prepared)
        return prepared

    def _prepared_for(self, qtext: str, sig: str, counted: bool = False,
                      trace: Optional[TraceContext] = None
                      ) -> PreparedQuery:
        prepared = self._lookup(qtext, sig)
        if prepared is not None:
            if counted:
                self.metrics.plan_hits += 1
            if trace is not None:
                trace.event("plan_cache", outcome="hit",
                            backend=self.backend)
            return prepared
        if counted:
            self.metrics.plan_misses += 1
        if trace is not None:
            trace.event("plan_cache", outcome="miss", backend=self.backend)
        return self._build(qtext, sig, trace=trace)

    def prepare(self, qtext: str) -> PreparedQuery:
        """Prepared form of ``qtext``'s template, from cache if present.
        Cache-hit bookkeeping happens in :meth:`query`; ``prepare`` is
        the silent path for callers managing their own loop."""
        return self._prepared_for(qtext, template_signature(qtext))

    def explain(self, qtext: str) -> str:
        """The compiled plan of ``qtext``'s template plus (for flat BGP
        cores) per-step estimated vs. actual intermediate cardinalities,
        which join-order planner produced the plan, and the backend the
        request runs on (the actual column executes the pipeline's joins
        on the host)."""
        prepared = self.prepare(qtext)
        plan = getattr(prepared, "plan", None)
        lines = [plan.describe() if plan is not None else "(operator tree)"]
        lines.extend(self._explain_cardinalities(prepared, qtext, plan))
        lines.append(f"backend: {self.backend} (forced)")
        return "\n".join(lines)

    def _explain_cardinalities(self, prepared: PreparedQuery, qtext: str,
                               plan) -> List[str]:
        """Estimated-vs-actual per-step cardinality lines for flat BGP
        pipelines (sequentially joining the flat steps of an
        OPTIONAL/UNION tree would misstate its semantics, so those only
        report the winning planner): :meth:`_cardinality_drift`'s report
        as text."""
        if plan is None:
            return []
        requested = self.planner
        out = [f"planner: {plan.planner} (requested {requested})"
               if plan.planner != requested else f"planner: {plan.planner}"]
        if plan.empty or not plan.steps or not _flat_bgp(prepared):
            return out
        binding = prepared.template.binding_for(qtext) \
            if prepared.template.rebindable else None
        if binding is not None and binding.missing:
            out.append("cardinalities: skipped (constant absent from "
                       "the dictionary; answered from statistics)")
            return out
        drift = self._cardinality_drift(prepared, binding)
        if all(d["est"] is None for d in drift):
            out.append("cardinalities: estimates unavailable (catalog has "
                       "no distinct-count statistics)")
        for d in drift:
            shown = "?" if d["est"] is None else f"{d['est']:.1f}"
            out.append(f"  step {d['step']}: {d['op']} "
                       f"est={shown} actual={d['actual']}")
        return out

    # -- execution ------------------------------------------------------------
    def _record(self, prepared: PreparedQuery, binding, res: Result) -> None:
        """Per-request result accounting shared by the single-query and
        batched paths."""
        self.metrics.served += 1
        self.metrics.rows += len(res)
        if len(res) == 0:
            self.metrics.empties += 1
        plan = getattr(prepared, "plan", None)
        if (plan is not None and plan.empty) or \
                (binding is not None and binding.missing):
            self.metrics.short_circuits += 1

    def query(self, qtext: str) -> Result:
        clock = self.config.clock
        t0 = clock()
        # guard-first fast path: with tracing off this costs one
        # attribute load and one float compare
        tr = self.tracer
        trace = tr.begin(qtext) if tr is not None and tr.active else None
        sig = template_signature(qtext)
        if trace is not None:
            trace.annotate(sig=sig)
        prepared = self._prepared_for(qtext, sig, counted=True, trace=trace)
        binding = prepared.template.binding_for(qtext) \
            if prepared.template.rebindable else None
        if trace is not None:
            sid = trace.start("execute", backend=self.backend)
            res = prepared.run(binding, trace=trace)
            trace.end(sid, rows=len(res))
        else:
            res = prepared.run(binding)
        self.metrics.record_latency((clock() - t0) * 1e3)
        self.metrics.record_route(self.backend)
        self._record(prepared, binding, res)
        if trace is not None:
            self._trace_finish(trace, prepared, binding)
        return res

    # -- batched execution -----------------------------------------------------
    def max_active_batch(self) -> int:
        """Largest batch one launch serves (the micro-batcher's bucket
        bound): ``MAX_BATCH``, since nothing here retires batch shapes."""
        return self.MAX_BATCH

    def _run_group(self, prepared: PreparedQuery,
                   bindings: List[Optional[object]],
                   traces: Optional[List[Optional[TraceContext]]] = None
                   ) -> List[Result]:
        """Same-template bindings through ``run_batch``, in chunks of at
        most ``MAX_BATCH``, unpadded.

        ``traces`` (parallel to ``bindings``) carries the sampled
        requests' trace contexts.  A chunk shares ONE launch, so the
        ``device.launch`` spans land on the chunk's first traced context
        (the *lead*); every other traced request of the chunk gets its
        own ``execute`` span flagged ``shared_launch=True``."""
        out: List[Result] = []
        clock = self.config.clock
        step = self.max_active_batch()
        if traces is None:
            traces = [None] * len(bindings)
        for start in range(0, len(bindings), step):
            chunk = bindings[start: start + step]
            traced = [(j, t) for j, t in
                      enumerate(traces[start: start + step])
                      if t is not None]
            lead = traced[0][1] if traced else None
            open_sids = [
                (t, t.start("execute", backend=self.backend,
                            batch=len(chunk), shape=len(chunk),
                            shared_launch=t is not lead))
                for _, t in traced]
            t0 = clock()
            res = prepared.run_batch(chunk, trace=lead) \
                if lead is not None else prepared.run_batch(chunk)
            dt_ms = (clock() - t0) * 1e3
            self.metrics.batches += 1
            self.metrics.batched_requests += len(chunk)
            # every request in the batch observed the batch's wall time
            self.metrics.record_latency(dt_ms, count=len(chunk))
            self.metrics.record_route(self.backend, count=len(chunk))
            for (j, t), (_, sid) in zip(traced, open_sids):
                t.end(sid, rows=len(res[j]))
            out.extend(res)
        return out

    def query_batch(self, qtexts: List[str],
                    traces: Optional[List[Optional[TraceContext]]] = None
                    ) -> List[Result]:
        """Execute a list of queries: requests sharing a template
        signature run through one batched launch; results come back in
        submission order.  This is the synchronous core the serving
        layer's micro-batcher drains into.  ``traces`` lets the batcher
        hand over trace contexts begun at submit time (so the queue span
        is part of the trace); called directly, the engine samples its
        own."""
        tr = self.tracer
        if traces is None:
            traces = [tr.begin(q) for q in qtexts] \
                if tr is not None and tr.active else [None] * len(qtexts)
        results: List[Optional[Result]] = [None] * len(qtexts)
        sig_groups: "OrderedDict[str, List[int]]" = OrderedDict()
        for i, qtext in enumerate(qtexts):
            sig_groups.setdefault(template_signature(qtext), []).append(i)
        for sig, idxs in sig_groups.items():
            groups: "OrderedDict[int, Tuple[PreparedQuery, List[int]]]" = \
                OrderedDict()
            for i in idxs:
                if traces[i] is not None:
                    traces[i].annotate(sig=sig)
                prepared = self._prepared_for(qtexts[i], sig, counted=True,
                                              trace=traces[i])
                groups.setdefault(id(prepared), (prepared, []))[1].append(i)
            for prepared, sub in groups.values():
                bindings = [prepared.template.binding_for(qtexts[i])
                            if prepared.template.rebindable else None
                            for i in sub]
                group_results = self._run_group(prepared, bindings,
                                                [traces[i] for i in sub])
                for i, binding, res in zip(sub, bindings, group_results):
                    results[i] = res
                    self._record(prepared, binding, res)
                    if traces[i] is not None:
                        self._trace_finish(traces[i], prepared, binding)
        return results  # type: ignore[return-value]

    # -- trace support ---------------------------------------------------------
    def _trace_finish(self, trace: TraceContext, prepared: PreparedQuery,
                      binding) -> None:
        """Join the cardinality-drift report onto the trace's launch
        spans and hand the finished trace to the flight recorder."""
        if self.config.trace_cardinality:
            drift = self._cardinality_drift(prepared, binding)
            if drift is not None:
                trace.annotate_named("device.launch", cardinalities=drift)
                trace.annotate(cardinalities=drift)
        trace.finish(backend=self.backend)

    def _cardinality_drift(self, prepared: PreparedQuery, binding
                           ) -> Optional[List[Dict[str, object]]]:
        """Estimated vs. actual per-step cardinalities of a flat BGP
        pipeline — ``explain()``'s drift report as a per-trace artifact.
        The actual column joins the steps on the host, so reports are
        cached per (prepared, binding): a hot template's traces pay the
        joins once, not per request."""
        plan = getattr(prepared, "plan", None)
        if plan is None or plan.empty or not plan.steps:
            return None
        if binding is not None and binding.missing:
            return None
        key = (id(prepared),
               tuple(sorted(binding.mapping.items()))
               if binding is not None else ())
        hit = self._drift_cache.get(key)
        if hit is not None:
            self._drift_cache.move_to_end(key)
            return hit
        if not _flat_bgp(prepared):
            return None
        concrete = plan if binding is None \
            else rebind_plan(plan, binding.mapping)
        from repro_torch.core import estimate as _estimate
        ests = _estimate.estimate_order(concrete.steps, self.ctx.catalog)
        actuals = _estimate.actual_cardinalities(concrete.steps,
                                                 self.ctx.catalog)
        if ests is None:
            ests = [None] * len(concrete.steps)
        drift = [{"step": i, "op": step.describe(),
                  "est": None if est is None else round(est.rows, 1),
                  "actual": int(act)}
                 for i, (step, est, act)
                 in enumerate(zip(concrete.steps, ests, actuals))]
        self._drift_cache[key] = drift
        while len(self._drift_cache) > _DRIFT_CACHE_SIZE:
            self._drift_cache.popitem(last=False)
        return drift

    # -- observability ---------------------------------------------------------
    def runtime_report(self) -> Dict[str, object]:
        """One JSON-friendly snapshot: the backend, the planner, the knob
        values and the serving metrics."""
        return {
            "backend": self.backend,
            "planner": self.planner,
            "config": self.config.snapshot(),
            "metrics": self.metrics.summary(),
        }

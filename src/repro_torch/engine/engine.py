"""The query engine: template LRU cache + backend dispatch.

``Engine`` is the public execution surface.  It owns

* a bounded LRU plan cache keyed on the template signature (prefixed
  ``planner=<p>::`` for a non-greedy planner) — each entry holds the
  backend's :class:`~repro_torch.engine.backends.PreparedQuery` (parsed
  template, compiled plan, executor with its device-resident tables), so
  a repeated templated query is served with zero parsing and zero
  compilation: its constants re-bind as runtime inputs;
* the statistics short-circuit (provably-empty plans, and constants
  missing from the dictionary in a required triple pattern, are
  answered without touching data);
* the **adaptive runtime** (``backend="auto"``): a per-template
  :class:`~repro_torch.runtime.router.BackendRouter` that measures
  eager / torch / distributed latency and routes each signature to its
  observed winner, and a :class:`~repro_torch.runtime.tuner.BatchTuner`
  over the batch-shape menu;
* ``query_batch``: same-template requests grouped by signature and run
  through one ``run_batch`` call per chunk of at most the tuner's
  largest active shape;
* operator metrics (:class:`ServerMetrics`): latency and queue
  histograms, plan-cache hit rate, empty answers, host fallbacks, rows
  served, batches, per-backend routing counts, the Prometheus
  exposition;
* the plan verifier (:mod:`repro_torch.analysis.verifier`), run on
  every plan-cache miss before the prepared query is cached when the
  runtime config's ``verify_plans`` is on (a rejected plan raises
  :class:`~repro_torch.analysis.PlanVerificationError` and never
  launches), and reported by ``explain()`` whatever the knob says;
* span tracing (:mod:`repro_torch.obs`), inert until the runtime
  config's ``trace_sample_rate`` is above 0, and ``explain()``.

Backends: ``"eager"`` on the host, ``"torch"`` on one device,
``"distributed"`` on every rank of a ``torch.distributed`` process group
(each rank builds the same engine and sends the same queries in the same
order), or ``"auto"`` over the first two (and the third when a ``group``
is given).

S2RDF notes that repeated Virtuoso queries benefit from caching while its
own runtimes are stable: here we cache *compilation*, never results.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from repro_torch.analysis.verifier import verify_prepared
from repro_torch.core.algebra import BGP
from repro_torch.core.modifiers import peel_spine
from repro_torch.device import resolve_device
from repro_torch.engine.backends import (
    DistributedBackend, ExecutionBackend, ExecutionContext, PreparedQuery,
    create_backend, is_device_error,
)
from repro_torch.engine.result import Result
from repro_torch.engine.template import (
    QueryTemplate, _normalize, rebind_plan, template_signature,
)
from repro_torch.obs import LogHistogram, Tracer, counters
from repro_torch.obs.tracer import TraceContext
from repro_torch.runtime import BackendRouter, BatchTuner, RouteDecision, \
    RuntimeConfig
from repro_torch.runtime.config import runtime_config as _global_runtime_config

__all__ = ["Engine", "ServerMetrics", "PlanCache", "resolve_device",
           "LAYOUTS"]

#: storage schemas a plan can compile for (paper §4); ``"pt"`` (the
#: property table) runs on the host engine, so on a device backend its
#: templates are served through a flagged eager fallback
LAYOUTS = ("extvp", "vp", "tt", "pt")

# Compat sample windows (``latencies_ms`` / ``queue_ms`` below) keep only
# the newest slice: the histograms are the percentile source and never
# truncate.
_MAX_SAMPLES = 8192

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
    # requests served through an eager fallback on a device backend (the
    # prepared query's ``fallback`` flag): host execution stays visible
    device_fallbacks: int = 0
    plan_hits: int = 0
    plan_misses: int = 0
    # micro-batching: one "batch" is one run_batch call serving B requests
    batches: int = 0          # batched launches executed
    batched_requests: int = 0 # requests served through a batched launch
    # slots wasted padding up to a static shape (only a batch that is one
    # launch sequence is padded: the torch and distributed backends', not
    # the eager seat's)
    padding_slots: int = 0
    # adaptive runtime: requests per backend actually executed on (on a
    # static engine this is all one key; under "auto" it shows the mix)
    routed: Dict[str, int] = field(default_factory=dict)

    # Snapshot provider attached by the owning Engine — lets anything
    # holding the metrics object (SparqlServer, the Prometheus renderer)
    # pull the router/tuner state without a reference to the engine.
    runtime_report_fn = None
    # Attached by the owning Engine: lets the Prometheus renderer expose
    # per-stage span histograms without a reference to the engine.
    tracer: Optional[Tracer] = None

    def __post_init__(self) -> None:
        # O(1) memory, O(1) record, exact counts, mergeable; the bounded
        # deques back only the deprecated list views below
        self.latency_hist = LogHistogram()
        self.queue_hist = LogHistogram()
        self._lat_samples: "deque" = deque(maxlen=_MAX_SAMPLES)
        self._queue_samples: "deque" = deque(maxlen=_MAX_SAMPLES)

    # -- compat views (deprecated) -----------------------------------------------
    @property
    def latencies_ms(self) -> List[float]:
        """Newest latency samples as a list (bounded window).  Deprecated
        read-only view: percentiles come from ``latency_hist``."""
        return list(self._lat_samples)

    @property
    def queue_ms(self) -> List[float]:
        """Newest queue-wait samples as a list (bounded window).
        Deprecated read-only view: use ``queue_hist``."""
        return list(self._queue_samples)

    def record_route(self, backend: str, count: int = 1) -> None:
        self.routed[backend] = self.routed.get(backend, 0) + count

    def record_latency(self, ms: float, count: int = 1) -> None:
        self.latency_hist.record(ms, count)
        # the window never needs more than maxlen copies
        self._lat_samples.extend([ms] * min(count, _MAX_SAMPLES))

    def record_queue(self, ms: float) -> None:
        self.queue_hist.record(ms)
        self._queue_samples.append(ms)

    def runtime_report(self) -> Dict[str, object]:
        """The owning engine's router/tuner snapshot (empty when the
        metrics object is not attached to an engine)."""
        fn = self.runtime_report_fn
        return fn() if fn is not None else {}

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
        (counters, latency/queue/per-stage histograms, router and tuner
        gauges) — see :mod:`repro_torch.obs.prometheus`."""
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
    """Execute SPARQL text over a Dataset through one backend — or
    through the adaptive runtime.

    ``backend`` is a registry key of
    :func:`~repro_torch.engine.backends.register_backend`: ``"eager"``
    (the host numpy engine), ``"torch"`` (one
    device), ``"distributed"`` (the ranks of the process group
    ``group``, ``None`` meaning the default group, which must be
    initialized; ``dual_partition`` adds the object-partitioned table
    copies), or ``"auto"``: the engine then prepares templates on every
    candidate backend (eager + torch, plus distributed when ``group`` is
    given) and a :class:`~repro_torch.runtime.BackendRouter` routes each
    template signature to its measured-latency winner (warmup → exploit
    → periodic probe; knobs on ``runtime``).  ``device`` is where this
    process's executors run — ``None`` means ``"cuda"``.  ``layout`` is
    the storage schema plans compile for (:data:`LAYOUTS`).  ``runtime``
    is the :class:`~repro_torch.runtime.RuntimeConfig` (``None``: the
    process-wide default) whose knobs and clock the engine reads;
    ``planner``, when given, overrides ``runtime.planner``;
    ``batch_shapes``, when given, overrides ``runtime.batch_shapes``.

    Under ``"auto"`` on a process group every rank must route a request
    to the same backend, or the distributed seat's collectives go
    unpaired: each measured latency is max-reduced over the group before
    the router and the tuner see it, so every rank makes the same
    decisions from the same numbers.
    """

    def __init__(self, dataset, backend: str = "torch", device=None,
                 layout: str = "extvp", planner: Optional[str] = None,
                 plan_cache_size: int = 512, group=None,
                 dual_partition: bool = False,
                 batch_shapes: Optional[Sequence[int]] = None,
                 runtime: Optional[RuntimeConfig] = None):
        if layout not in LAYOUTS:
            raise ValueError(f"unknown layout {layout!r}; available: "
                             f"{list(LAYOUTS)}")
        if planner not in (None, "greedy", "estimate"):
            raise ValueError(f"unknown planner {planner!r}; expected "
                             "'greedy' or 'estimate'")
        if backend == "auto":
            names = ["eager", "torch"] + \
                (["distributed"] if group is not None else [])
        else:
            names = [backend]
        chosen = [DistributedBackend(dual_partition)
                  if n == "distributed" and dual_partition
                  else create_backend(n) for n in names]
        self._backends: Dict[str, ExecutionBackend] = \
            {b.name: b for b in chosen}
        if dual_partition and "distributed" not in self._backends:
            raise ValueError("dual_partition applies to the distributed "
                             "backend only")
        if "distributed" in self._backends and \
                (not dist.is_available() or not dist.is_initialized()):
            raise ValueError(
                "the distributed backend needs an initialized process "
                "group: call torch.distributed.init_process_group(...) "
                "first (nccl on the card, gloo on the CPU)")
        self.auto = backend == "auto"
        self.device = resolve_device(device)
        # engines without an explicit runtime= share the process-wide
        # default instance
        self.config = runtime if runtime is not None else \
            _global_runtime_config
        self._planner_override = planner
        self.dataset = dataset
        self.layout = layout
        self.group = group
        self.ctx = ExecutionContext(catalog=dataset.catalog,
                                    dictionary=dataset.dictionary,
                                    layout=layout, planner=self.planner,
                                    device=self.device, group=group)
        self.cache = PlanCache(plan_cache_size)
        self.metrics = ServerMetrics()
        self.metrics.runtime_report_fn = self.runtime_report
        #: span tracing (repro_torch.obs) — inert until the config's
        #: ``trace_sample_rate`` knob is > 0 (the hot path's only cost is
        #: the ``tracer.active`` guard)
        self.tracer = Tracer(self.config)
        self.metrics.tracer = self.tracer
        self._drift_cache: "OrderedDict" = OrderedDict()
        shapes = self.config.batch_shapes if batch_shapes is None \
            else tuple(batch_shapes)
        if not shapes or min(shapes) < 1:
            raise ValueError("batch_shapes must be positive ints")
        self.batch_shapes: Tuple[int, ...] = tuple(sorted(shapes))
        self.router = BackendRouter(tuple(self._backends), self.config)
        self.tuner = BatchTuner(self.batch_shapes, self.config)
        # ranks route alike only on the same latencies (class docstring)
        self._agree = self.auto and "distributed" in self._backends

    @property
    def backend(self) -> str:
        if self.auto:
            return "auto"
        return next(iter(self._backends))

    @property
    def backends(self) -> Tuple[str, ...]:
        """The backends this engine may run a request on."""
        return tuple(self._backends)

    @property
    def planner(self) -> str:
        """The join-order planner: the ``planner=`` the engine was built
        with, else the live ``config.planner`` (read on every use, so
        flipping it mid-session re-plans; the cache key includes it)."""
        if self._planner_override is not None:
            return self._planner_override
        return self.config.planner

    # -- compilation ----------------------------------------------------------
    def _cache_key(self, bname: str, sig: str) -> str:
        # static engines key on the bare signature; auto engines hold one
        # prepared query per (backend, signature).  Plans compiled under
        # different join-order planners are different artifacts and must
        # never shadow each other.
        key = sig if not self.auto else f"{bname}::{sig}"
        planner = self.planner
        return key if planner == "greedy" else f"planner={planner}::{key}"

    def _lookup(self, bname: str, qtext: str, sig: str
                ) -> Optional[PreparedQuery]:
        prepared = self.cache.get(self._cache_key(bname, sig))
        if prepared is not None:
            return prepared
        # Non-rebindable templates (e.g. a constant in predicate position)
        # are cached under the exact normalized text instead.
        return self.cache.get(self._cache_key(bname,
                                              "=" + _normalize(qtext)))

    def _build(self, bname: str, qtext: str, sig: str,
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
            sid = trace.start("plan", backend=bname, planner=self.planner)
        prepared = self._backends[bname].prepare(template, self.ctx)
        if trace is not None:
            trace.end(sid, fallback=prepared.fallback)
        if self.config.verify_plans:
            # before the plan is cached: nothing it rejects ever launches
            sid = trace.start("verify") if trace is not None else None
            verify_prepared(prepared, self.ctx.catalog).raise_if_failed()
            if trace is not None:
                trace.end(sid)
        key = sig if template.rebindable else "=" + _normalize(qtext)
        self.cache.put(self._cache_key(bname, key), prepared)
        return prepared

    def _prepared_for(self, bname: str, qtext: str, sig: str,
                      counted: bool = False,
                      trace: Optional[TraceContext] = None
                      ) -> PreparedQuery:
        prepared = self._lookup(bname, qtext, sig)
        if prepared is not None:
            if counted:
                self.metrics.plan_hits += 1
            if trace is not None:
                trace.event("plan_cache", outcome="hit", backend=bname)
            return prepared
        if counted:
            self.metrics.plan_misses += 1
        if trace is not None:
            trace.event("plan_cache", outcome="miss", backend=bname)
        return self._build(bname, qtext, sig, trace=trace)

    def prepare(self, qtext: str) -> PreparedQuery:
        """Prepared form of ``qtext``'s template, from cache if present,
        on the backend the router currently favors.  Cache-hit
        bookkeeping happens in :meth:`query`; ``prepare`` is the silent
        path for callers managing their own loop."""
        sig = template_signature(qtext)
        _, prepared = self._route(qtext, sig, counted=False, peek=True)
        return prepared

    # -- routing ---------------------------------------------------------------
    def _route(self, qtext: str, sig: str, counted: bool = True,
               peek: bool = False,
               use: Optional[RouteDecision] = None,
               trace: Optional[TraceContext] = None
               ) -> Tuple[RouteDecision, PreparedQuery]:
        """Decide a backend for this request and return its prepared
        query.  Under ``"auto"``, a device backend whose ``prepare``
        raises is excluded for the signature and the router re-decides —
        except on a CUDA error or a kernel that cannot be built or
        loaded, which propagate — and a prepared query that fell back to
        the eager host engine is likewise excluded: the router must
        never attribute eager latencies to a device backend.  ``use``
        short-circuits the first decision (a micro-batch group decides
        once via :meth:`BackendRouter.decide` and shares it); the
        exclusion/re-route machinery still applies."""
        while True:
            if use is not None:
                decision, use = use, None
            else:
                decision = self.router.peek(sig) if peek \
                    else self.router.decide(sig)
            bname = decision.backend
            if trace is not None:
                # the routing decision is a trace event, with the EWMAs
                # it was judged against
                trace.event("router.decide", backend=bname,
                            reason=decision.reason,
                            ewma_ms=self.router.estimates(sig))
            try:
                prepared = self._prepared_for(bname, qtext, sig, counted,
                                              trace=trace)
            except Exception as exc:
                if self.auto and bname != "eager" and \
                        not is_device_error(exc):
                    self.router.mark_failed(sig, bname)
                    if trace is not None:
                        trace.event("router.exclude", backend=bname,
                                    why="prepare failed")
                    counted = False    # one request, one hit/miss count
                    continue
                raise
            if self.auto and bname != "eager" and prepared.fallback:
                self.router.mark_fallback(sig, bname)
                if trace is not None:
                    trace.event("router.exclude", backend=bname,
                                why="eager fallback")
                counted = False
                continue
            return decision, prepared

    def _agreed_ms(self, ms: float) -> float:
        """``ms`` as the router and tuner see it: on an auto engine over a
        process group, the largest of the ranks' measurements (one
        scalar all-reduce), so that every rank routes alike."""
        if not self._agree:
            return ms
        group = self.group
        dev = self.device if dist.get_backend(group) == "nccl" \
            else torch.device("cpu")
        t = torch.tensor([ms], dtype=torch.float64, device=dev)
        counters.note("all-reduce", t)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
        return float(t.item())

    def explain(self, qtext: str) -> str:
        """The compiled plan of ``qtext``'s template plus (for flat BGP
        cores) per-step estimated vs. actual intermediate cardinalities,
        which join-order planner produced the plan, and the routing
        decision the request would get right now and why (``forced`` on a
        static engine, ``warmup``/``measured``/``probe`` under ``auto``)
        and the static verifier's verdict — diagnostics, consumes no
        routing budget (the actual column executes the pipeline's joins
        on the host)."""
        sig = template_signature(qtext)
        decision, prepared = self._route(qtext, sig, counted=False,
                                         peek=True)
        plan = getattr(prepared, "plan", None)
        lines = [plan.describe() if plan is not None else "(operator tree)"]
        lines.extend(self._explain_cardinalities(prepared, qtext, plan))
        st = self.router.report()["signatures"].get(sig, {})
        ewma = st.get("ewma_ms", {})
        detail = ", ".join(f"{b}={ewma[b]:.3f}ms" for b in sorted(ewma))
        lines.append(f"backend: {decision.backend} ({decision.reason}"
                     + (f"; measured {detail}" if detail else "") + ")")
        if prepared.fallback:
            lines.append("note: prepared as an eager fallback "
                         "(device path cannot express this template)")
        # the static verifier's verdict — always reported here (explain
        # is the diagnostic surface), whatever the verify_plans knob says
        lines.append(verify_prepared(prepared, self.ctx.catalog).describe())
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
        if binding is not None and binding.short_circuit:
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
        if prepared.fallback:
            self.metrics.device_fallbacks += 1
        plan = getattr(prepared, "plan", None)
        if (plan is not None and plan.empty) or \
                (binding is not None and binding.short_circuit):
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
        decision, prepared = self._route(qtext, sig, trace=trace)
        binding = prepared.template.binding_for(qtext) \
            if prepared.template.rebindable else None
        t_run = clock()
        if trace is not None:
            sid = trace.start("execute", backend=decision.backend)
            res = prepared.run(binding, trace=trace)
            trace.end(sid, rows=len(res))
        else:
            res = prepared.run(binding)
        self.router.observe(sig, decision.backend,
                            self._agreed_ms((clock() - t_run) * 1e3),
                            reason=decision.reason)
        self.metrics.record_latency((clock() - t0) * 1e3)
        self.metrics.record_route(decision.backend)
        self._record(prepared, binding, res)
        if trace is not None:
            self._trace_finish(trace, prepared, binding, decision)
        return res

    # -- batched execution -----------------------------------------------------
    def bucket_shape(self, n: int) -> int:
        """Smallest *active* static batch shape holding ``n`` requests
        (``n`` larger than the biggest shape is chunked by the caller).
        The menu starts as ``batch_shapes`` and shrinks as the tuner
        retires shapes that measure slower than smaller ones."""
        return self.tuner.bucket_for(n)

    def max_active_batch(self) -> int:
        """Largest currently-active batch shape (the micro-batcher's
        effective bucket bound)."""
        return self.tuner.max_shape()

    def _run_group(self, sig: str, decision: RouteDecision,
                   prepared: PreparedQuery,
                   bindings: List[Optional[object]],
                   traces: Optional[List[Optional[TraceContext]]] = None
                   ) -> List[Result]:
        """Execute same-template bindings through ``run_batch``, chunked
        at the largest active static shape and padded up to the bucket
        shape (the pad repeats a real binding; padded results are
        dropped).  A backend whose ``run_batch`` runs its bindings in turn
        (the eager seat) is not padded — padding only buys something when
        the batch is one launch sequence — and the tuner observes only the
        padded ones (the torch and distributed seats).

        ``traces`` (parallel to ``bindings``) carries the sampled
        requests' trace contexts.  A chunk shares ONE launch sequence, so
        the ``device.launch`` spans land on the chunk's first traced
        context (the *lead*); every other traced request of the chunk
        gets its own ``execute`` span flagged ``shared_launch=True``.
        The router and the tuner see ``_agreed_ms`` of the chunk's wall
        time, so every rank of a group keeps one seat and one menu."""
        out: List[Result] = []
        clock = self.config.clock
        max_shape = self.max_active_batch()
        pad = prepared.vectorized_batch
        if traces is None:
            traces = [None] * len(bindings)
        for start in range(0, len(bindings), max_shape):
            chunk = bindings[start: start + max_shape]
            traced = [(j, t) for j, t in
                      enumerate(traces[start: start + max_shape])
                      if t is not None]
            lead = traced[0][1] if traced else None
            shape = self.bucket_shape(len(chunk)) if pad else len(chunk)
            padded = chunk + [chunk[-1]] * (shape - len(chunk))
            # the chunk's work is the lead's: only its span opens a
            # profiler range
            open_sids = [
                (t, t.start("execute", mirror=t is lead,
                            backend=decision.backend,
                            batch=len(chunk), shape=shape,
                            shared_launch=t is not lead))
                for _, t in traced]
            if lead is not None and shape != len(chunk):
                lead.event("batch.pad", shape=shape, live=len(chunk),
                           padding=shape - len(chunk))
            t0 = clock()
            res = prepared.run_batch(padded, trace=lead) \
                if lead is not None else prepared.run_batch(padded)
            dt_ms = (clock() - t0) * 1e3
            self.metrics.batches += 1
            self.metrics.batched_requests += len(chunk)
            self.metrics.padding_slots += shape - len(chunk)
            # every request in the batch observed the batch's wall time
            self.metrics.record_latency(dt_ms, count=len(chunk))
            self.metrics.record_route(decision.backend, count=len(chunk))
            # the router compares per-request service time across
            # backends; the tuner compares per-slot time across shapes
            dt_ms = self._agreed_ms(dt_ms)
            self.router.observe(sig, decision.backend, dt_ms / len(chunk),
                                reason=decision.reason, weight=len(chunk))
            if pad:
                before = self.tuner.active_shapes() \
                    if lead is not None else None
                self.tuner.observe(shape, len(chunk), dt_ms)
                if lead is not None:
                    after = self.tuner.active_shapes()
                    if after != before:
                        lead.event("tuner.retire", retired=[
                            s for s in before if s not in after])
            kept = res[: len(chunk)]
            for (j, t), (_, sid) in zip(traced, open_sids):
                t.end(sid, rows=len(kept[j]))
            out.extend(kept)
        return out

    def query_batch(self, qtexts: List[str],
                    traces: Optional[List[Optional[TraceContext]]] = None
                    ) -> List[Result]:
        """Execute a list of queries: requests sharing a template
        signature run through one ``run_batch`` call per chunk; results
        come back in submission order.  This is the synchronous core the
        serving layer's micro-batcher drains into.  ``traces`` lets the
        batcher hand over trace contexts begun at submit time (so the
        queue span is part of the trace) and finishes them itself, after
        its own bookkeeping; called directly, the engine samples and
        finishes its own.

        The first traced request of each signature group gets a
        ``front`` span (``requests``: the group's size) over its
        routing, plan-cache lookups (``parse`` / ``plan`` / ``verify``
        on a miss) and constant binding, closed before its first
        ``execute``; the first group's also covers the grouping, when
        the batch's first request is traced."""
        tr = self.tracer
        tracing = tr is not None and tr.active
        own = traces is None
        if own:
            traces = [tr.begin(q) for q in qtexts] \
                if tracing else [None] * len(qtexts)
        # the first group's lead is traces[0] whenever that is traced
        front = traces[0].start("front") \
            if tracing and traces and traces[0] is not None else None
        results: List[Optional[Result]] = [None] * len(qtexts)
        sig_groups: "OrderedDict[str, List[int]]" = OrderedDict()
        for i, qtext in enumerate(qtexts):
            sig_groups.setdefault(template_signature(qtext), []).append(i)
        for sig, idxs in sig_groups.items():
            lead = next((traces[i] for i in idxs if traces[i] is not None),
                        None) if tracing else None
            if lead is not None and front is None:
                front = lead.start("front")
            # ONE routing decision per signature group: the whole group
            # lands on one backend, and the router costs one decision per
            # launch group, not one per request
            shared = self.router.decide(sig, n=len(idxs))
            groups: "OrderedDict[int, Tuple[RouteDecision, PreparedQuery, List[int]]]" = \
                OrderedDict()
            for i in idxs:
                if traces[i] is not None:
                    traces[i].annotate(sig=sig)
                # per-request _route keeps the failure/fallback re-route
                # machinery; on the cached fast path it is one dict get
                decision, prepared = self._route(qtexts[i], sig,
                                                 use=shared,
                                                 trace=traces[i])
                groups.setdefault(id(prepared),
                                  (decision, prepared, []))[2].append(i)
            bound = [(decision, prepared, sub,
                      [prepared.template.binding_for(qtexts[i])
                       if prepared.template.rebindable else None
                       for i in sub])
                     for decision, prepared, sub in groups.values()]
            if front is not None:
                lead.end(front, requests=len(idxs))
                front = None
            for decision, prepared, sub, bindings in bound:
                group_results = self._run_group(sig, decision, prepared,
                                                bindings,
                                                [traces[i] for i in sub])
                for i, binding, res in zip(sub, bindings, group_results):
                    results[i] = res
                    self._record(prepared, binding, res)
                    if traces[i] is not None:
                        self._trace_finish(traces[i], prepared, binding,
                                           decision, finish=own)
        return results  # type: ignore[return-value]

    # -- trace support ---------------------------------------------------------
    def _trace_finish(self, trace: TraceContext, prepared: PreparedQuery,
                      binding, decision: RouteDecision,
                      finish: bool = True) -> None:
        """Join the cardinality-drift report onto the trace's launch
        spans (the host engine's ``host.execute`` span when nothing
        launched) and hand the finished trace to the flight recorder;
        with ``finish`` False the trace only takes its backend and its
        owner finishes it."""
        if self.config.trace_cardinality:
            drift = self._cardinality_drift(prepared, binding)
            if drift is not None:
                if trace.annotate_named("device.launch",
                                        cardinalities=drift) == 0:
                    trace.annotate_named("host.execute",
                                         cardinalities=drift)
                trace.annotate(cardinalities=drift)
        if finish:
            trace.finish(backend=decision.backend)
        else:
            trace.annotate(backend=decision.backend)

    def _cardinality_drift(self, prepared: PreparedQuery, binding
                           ) -> Optional[List[Dict[str, object]]]:
        """Estimated vs. actual per-step cardinalities of a flat BGP
        pipeline — ``explain()``'s drift report as a per-trace artifact.
        The actual column joins the steps on the host engine
        (:func:`repro_torch.core.estimate.actual_cardinalities`), so
        reports are cached per (prepared, binding): a hot template's
        traces pay the joins once, not per request."""
        plan = getattr(prepared, "plan", None)
        if plan is None or plan.empty or not plan.steps:
            return None
        if binding is not None and binding.short_circuit:
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
        """One JSON-friendly snapshot of every adaptive-runtime decision:
        per-signature backend choices with their latency estimates, the
        decision log tail, the live batch-shape menu with per-bucket
        stats, the active knob values, and the serving metrics."""
        return {
            "backend": self.backend,
            "auto": self.auto,
            "planner": self.planner,
            "router": self.router.report(),
            "tuner": self.tuner.report(),
            "config": self.config.snapshot(),
            "metrics": self.metrics.summary(),
        }

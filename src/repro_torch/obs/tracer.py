"""Per-request span tracing with deterministic sampling.

One sampled request carries one :class:`TraceContext` through the whole
serving path — batcher queue, plan cache, device launch, demux/decode —
collecting explicit start/end **span** records plus instantaneous
**events** (plan-cache hit/miss, statistics short-circuits).  Everything
is measured through the
:class:`~repro_torch.runtime.config.RuntimeConfig` clock, so traces are
deterministic and unit-testable with an injected fake clock.

The cardinal rule is that **disabled tracing costs ~nothing**: the hot
path's only obligation is

    tr = engine.tracer
    ctx = tr.begin(qtext) if tr is not None and tr.active else None

— one attribute load and one float compare when ``trace_sample_rate``
is 0.  Sampling is deterministic stride sampling (1 in
``round(1/rate)`` requests), not random — reproducible under test and
immune to unlucky streaks.

Two kinds of span share a trace.  Host work (:meth:`TraceContext.start`)
nests on a stack of open spans, so a span's parent falls out of call
order and ending a span closes whatever is still open inside it.  Waits
(:meth:`TraceContext.start_wait`: the batcher's ``queue``; the root
``request`` itself) stay off that stack, so host work may begin and end
inside a wait without closing it.

While ``torch.profiler`` records, every host-work span also opens a
profiler range named ``repro.<span>`` and closes it with the span, so
the device trace and the program's spans share a clock: an idle gap of
the card is named by the program stage around it.  :meth:`finish` hands
a trace to the tracer inside a ``repro.finish`` range: tracing's own
cost, after the trace's spans have closed.  The gate is
``torch.autograd.profiler._is_profiler_enabled``, read at each
:meth:`~TraceContext.start`; with the profiler off a span enters no
range.

Finished traces flow into the tracer's
:class:`~repro_torch.obs.recorder.FlightRecorder` (ring + slow-query
reservoir) and feed per-stage :class:`~repro_torch.obs.histogram.LogHistogram`
aggregates, which :mod:`repro_torch.obs.prometheus` exposes as
``repro_stage_ms`` series.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch
from torch.autograd import profiler as _profiler

from repro_torch.obs.histogram import LogHistogram
from repro_torch.obs.recorder import FlightRecorder

__all__ = ["Span", "TraceContext", "Tracer"]

#: the prefix of the profiler range a host-work span opens
RANGE_PREFIX = "repro."


class Span:
    """One timed region of a trace.  ``t0``/``t1`` are raw clock seconds
    (the config clock's units); ``t1 is None`` while the span is open."""

    __slots__ = ("sid", "name", "parent", "t0", "t1", "attrs", "events")

    def __init__(self, sid: int, name: str, parent: Optional[int],
                 t0: float, attrs: Dict[str, Any]):
        self.sid = sid
        self.name = name
        self.parent = parent      # parent span's sid (None for the root)
        self.t0 = t0
        self.t1: Optional[float] = None
        self.attrs = attrs
        self.events: List[Dict[str, Any]] = []

    @property
    def duration_ms(self) -> Optional[float]:
        return None if self.t1 is None else (self.t1 - self.t0) * 1e3

    def __repr__(self) -> str:
        dur = self.duration_ms
        shown = "open" if dur is None else f"{dur:.3f}ms"
        return f"Span({self.sid}, {self.name!r}, {shown})"


class TraceContext:
    """The spans and events of ONE sampled request.

    Span 0 is the root (``request``), a wait that :meth:`finish` closes.
    :meth:`start`/:meth:`end` manage a stack of open host-work spans so
    nesting falls out of call order; :meth:`start_wait` records a span
    off that stack.  The context is carried *by argument* through the
    engine, batcher, prepared queries and executors — there is no
    thread-local or global state, so the untraced path never looks
    anything up.
    """

    __slots__ = ("trace_id", "clock", "spans", "_open", "_tracer",
                 "duration_ms", "_ranges")

    def __init__(self, trace_id: int, clock, tracer: "Optional[Tracer]",
                 name: str = "request", **attrs: Any):
        self.trace_id = trace_id
        self.clock = clock
        self._tracer = tracer
        self.duration_ms: Optional[float] = None
        root = Span(0, name, None, clock(), attrs)
        self.spans: List[Span] = [root]
        self._open: List[int] = []
        #: sid -> the profiler range its span holds open
        self._ranges: Dict[int, Any] = {}

    @property
    def root(self) -> Span:
        return self.spans[0]

    # -- spans -----------------------------------------------------------------
    def start(self, name: str, *, mirror: bool = True, **attrs: Any) -> int:
        """Open a host-work span under the innermost open span (the root
        when none is); returns its sid for :meth:`end`.  While the
        profiler records, the span also opens the range
        ``repro.<name>``, unless ``mirror`` is False (work another
        trace's span already covers)."""
        sid = len(self.spans)
        parent = self._open[-1] if self._open else 0
        self.spans.append(Span(sid, name, parent, self.clock(), attrs))
        self._open.append(sid)
        if mirror and _profiler._is_profiler_enabled:
            self._ranges[sid] = torch.ops.profiler._record_function_enter_new(
                RANGE_PREFIX + name, None)
        return sid

    def start_wait(self, name: str, **attrs: Any) -> int:
        """Open a wait: a child of the root that stays off the stack of
        open spans (host work begun and ended meanwhile does not close
        it) and opens no profiler range.  :meth:`end` or :meth:`finish`
        closes it."""
        sid = len(self.spans)
        self.spans.append(Span(sid, name, 0, self.clock(), attrs))
        return sid

    def end(self, sid: int, **attrs: Any) -> None:
        """Close span ``sid``.  Ending a span on the stack (or the root)
        closes anything left open inside it — a child that escaped its
        ``end`` must not dangle past its parent; ending a wait touches
        nothing else."""
        t = self.clock()
        stack = self._open
        if sid == 0 or sid in stack:
            while stack and stack[-1] != sid:
                self._close(stack.pop(), t)
            if stack:
                stack.pop()
        self._close(sid, t)
        if attrs:
            self.spans[sid].attrs.update(attrs)

    def _close(self, sid: int, t: float) -> None:
        span = self.spans[sid]
        if span.t1 is None:
            span.t1 = t
        handle = self._ranges.pop(sid, None)
        if handle is not None:
            torch.ops.profiler._record_function_exit._RecordFunction(handle)

    # -- events / annotations --------------------------------------------------
    def event(self, name: str, **attrs: Any) -> None:
        """Instantaneous event on the innermost open span."""
        holder = self.spans[self._open[-1]] if self._open else self.root
        holder.events.append({"name": name, "t": self.clock(),
                              "attrs": attrs})

    def annotate(self, sid: int = 0, **attrs: Any) -> None:
        """Attach attributes to span ``sid`` (default: the root)."""
        self.spans[sid].attrs.update(attrs)

    def annotate_named(self, name: str, **attrs: Any) -> int:
        """Attach attributes to every span called ``name`` (how the
        engine joins estimated/actual cardinalities onto device-launch
        spans after the fact); returns the number annotated."""
        n = 0
        for span in self.spans:
            if span.name == name:
                span.attrs.update(attrs)
                n += 1
        return n

    def finish(self, **attrs: Any) -> None:
        """Close the root (and any stragglers, open waits included) and
        hand the complete trace to the tracer's recorder/aggregates."""
        if self.root.t1 is not None:
            return                      # already finished (idempotent)
        self.end(0, **attrs)
        t = self.root.t1
        for span in self.spans:
            if span.t1 is None:
                span.t1 = t
        self.duration_ms = self.root.duration_ms
        if self._tracer is not None:
            # the tracer's own cost, after every span has closed, gets a
            # range of its own, so the device trace does not read it as
            # time outside the program
            handle = torch.ops.profiler._record_function_enter_new(
                RANGE_PREFIX + "finish", None) \
                if _profiler._is_profiler_enabled else None
            self._tracer._finished(self)
            if handle is not None:
                torch.ops.profiler._record_function_exit._RecordFunction(
                    handle)


class Tracer:
    """Sampling front door + aggregate sink for :class:`TraceContext`.

    Reads ``trace_sample_rate`` from the config on every :meth:`begin`,
    so the rate is live-tunable (one engine can serve at several rates
    in turn).
    """

    def __init__(self, config):
        self.config = config
        self.recorder = FlightRecorder(
            ring=getattr(config, "trace_ring", 256),
            slow_ms=getattr(config, "trace_slow_ms", 100.0),
            slow_keep=getattr(config, "trace_slow_keep", 64))
        #: per span-name duration aggregates (repro_stage_ms in the
        #: Prometheus exposition)
        self.stage_hist: Dict[str, LogHistogram] = {}
        self.started = 0          # sampled-in traces begun
        self.finished = 0
        self.sampled_out = 0      # requests the stride skipped
        self._seen = 0            # all begin() calls (stride counter)
        self._next_id = 0

    @property
    def active(self) -> bool:
        """False ⇒ the engine must not even build a TraceContext — the
        guard the ≤1%-overhead gate measures."""
        return self.config.trace_sample_rate > 0.0

    def begin(self, qtext: Optional[str] = None,
              **attrs: Any) -> Optional[TraceContext]:
        """A TraceContext for this request, or ``None`` when the stride
        samples it out (sampled-out requests create zero records)."""
        rate = self.config.trace_sample_rate
        if rate <= 0.0:
            return None
        self._seen += 1
        if rate < 1.0:
            stride = max(1, round(1.0 / rate))
            if (self._seen - 1) % stride != 0:
                self.sampled_out += 1
                return None
        self._next_id += 1
        self.started += 1
        if qtext is not None:
            attrs.setdefault("qtext", qtext[:200])
        return TraceContext(self._next_id, self.config.clock, self,
                            **attrs)

    def _finished(self, ctx: TraceContext) -> None:
        self.finished += 1
        for span in ctx.spans:
            dur = span.duration_ms
            if dur is None:
                continue
            hist = self.stage_hist.get(span.name)
            if hist is None:
                hist = self.stage_hist[span.name] = LogHistogram()
            hist.record(dur)
        self.recorder.add(ctx)

    # -- export passthroughs ---------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        return self.recorder.chrome_trace()

    def to_jsonl(self) -> str:
        return self.recorder.to_jsonl()

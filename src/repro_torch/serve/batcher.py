"""Micro-batching front end: same-template requests share one launch.

Template-level work (parsing, Algorithm-1/4 compilation, executor
set-up) is already amortized by the plan cache; this module amortizes
the *launch*: requests are enqueued with :meth:`MicroBatcher.submit`,
grouped by template signature into size/latency-bounded buckets, run as
one batched execution (:meth:`repro_torch.engine.Engine.query_batch`),
and demultiplexed back into per-request
:class:`~repro_torch.engine.Result`s.

The batcher is synchronous and single-threaded — the serving analogue of
an event-loop tick.  A bucket drains when it reaches ``max_batch``, when
the oldest queued request has waited longer than ``flush_ms`` (checked on
every ``submit``), or when a caller forces it (``flush()`` /
``PendingQuery.result()``).  Waits are measured through the engine's
``config.clock``.

**The distributed rule.**  On the ``"distributed"`` backend (and on
``"auto"`` over a process group) every rank
runs its own batcher over the same request sequence, and a batched
launch is a sequence of collectives that all ranks must enter together.
A wall-clock deadline could expire on one rank and not on another, group
the requests differently, and leave the collectives unpaired — a
deadlock.  So there the latency bound is not checked: a bucket drains
only on the size bound or a forced flush, both functions of the request
sequence alone, which every rank shares.  On one device the reference's
behaviour is kept unchanged.
"""

from __future__ import annotations

from collections import OrderedDict
from typing import List, Optional

from repro_torch.engine import Result, template_signature

__all__ = ["MicroBatcher", "PendingQuery"]

_UNSET = object()


class PendingQuery:
    """Handle for one submitted request; resolves when its bucket drains."""

    def __init__(self, batcher: "MicroBatcher", qtext: str, sig: str):
        self.qtext = qtext
        self.signature = sig
        self._batcher = batcher
        self._result = _UNSET
        self._error: Optional[BaseException] = None
        self.submitted_at = batcher.clock()
        # sampled requests carry their TraceContext from submit onward,
        # so the queue wait is part of the trace (None when unsampled)
        self.trace = None
        self._queue_sid: Optional[int] = None

    def done(self) -> bool:
        return self._result is not _UNSET or self._error is not None

    def result(self) -> Result:
        """The request's Result, draining its bucket if still queued.
        Re-raises the execution error if the request's batch failed."""
        if not self.done():
            self._batcher.flush_group(self.signature)
        assert self.done(), "flush did not resolve this request"
        if self._error is not None:
            raise self._error
        return self._result  # type: ignore[return-value]


class MicroBatcher:
    """Queue + bucketizer in front of an :class:`~repro_torch.engine.Engine`.

    ``max_batch`` bounds bucket size (larger buckets are chunked by the
    engine anyway); ``flush_ms`` bounds the queueing latency a request
    can pay waiting for batch-mates (not on the distributed backend: see
    the module docstring).
    """

    def __init__(self, engine, max_batch: int = 32, flush_ms: float = 2.0):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.engine = engine
        self.max_batch = int(max_batch)
        self.flush_ms = float(flush_ms)
        self.clock = engine.config.clock
        #: False when the engine runs over a process group (the
        #: distributed backend, or ``"auto"`` with a group): ranks must
        #: group requests the same way, so no flush may depend on a
        #: rank's clock
        self.latency_bound = "distributed" not in engine.backends
        self._queues: "OrderedDict[str, List[PendingQuery]]" = OrderedDict()

    # -- queue state -----------------------------------------------------------
    def effective_max_batch(self) -> int:
        """The live bucket bound: ``max_batch`` capped by the largest
        batch shape the engine's tuner still considers worth launching —
        once a shape is retired as a measured regression, letting buckets
        fill to it would only split into smaller chunks anyway, while the
        earlier requests waited for nothing."""
        return min(self.max_batch, self.engine.max_active_batch())

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def _flush_expired(self) -> None:
        """Drain only the buckets whose OLDEST request has waited past
        ``flush_ms`` — fresh buckets keep filling (draining everything on
        one stale signature would collapse batch occupancy).  Errors stay
        on the affected tickets (``result()`` re-raises)."""
        now = self.clock()
        for sig in list(self._queues):
            group = self._queues.get(sig)
            if group and (now - group[0].submitted_at) * 1e3 >= self.flush_ms:
                try:
                    self.flush_group(sig)
                except Exception:
                    pass

    # -- submission ------------------------------------------------------------
    def submit(self, qtext: str) -> PendingQuery:
        """Enqueue one request; returns a handle that resolves when the
        request's bucket drains (size bound, latency bound, or explicit
        flush)."""
        sig = template_signature(qtext)
        ticket = PendingQuery(self, qtext, sig)
        tr = self.engine.tracer
        if tr.active:
            ticket.trace = tr.begin(qtext, sig=sig)
            if ticket.trace is not None:
                ticket._queue_sid = ticket.trace.start("queue")
        self._queues.setdefault(sig, []).append(ticket)
        # Auto-flushes swallow execution errors: the caller of THIS submit
        # must still receive its ticket; every failed request's ticket
        # carries the error and result() re-raises it.
        if len(self._queues[sig]) >= self.effective_max_batch():
            try:
                self.flush_group(sig)
            except Exception:
                pass
        # latency bound is checked regardless of the size-bound branch: a
        # hot template's full buckets must not starve another template's
        # lone queued request past its deadline
        if self.latency_bound:
            self._flush_expired()
        return ticket

    # -- draining --------------------------------------------------------------
    def flush_group(self, sig: str) -> int:
        """Drain one signature's bucket through a batched execution.  On
        an execution error every ticket of the bucket carries the error
        (``result()`` re-raises it) and the error propagates to the
        flusher — tickets are never silently dropped."""
        group = self._queues.pop(sig, [])
        if not group:
            return 0
        for ticket in group:
            if ticket.trace is not None and ticket._queue_sid is not None:
                ticket.trace.end(ticket._queue_sid, batch=len(group))
        # the traces kwarg is only passed when something was actually
        # sampled — stubbed query_batch implementations without the
        # parameter keep working on the untraced path
        kwargs = {}
        if any(t.trace is not None for t in group):
            kwargs["traces"] = [t.trace for t in group]
        try:
            results = self.engine.query_batch(
                [t.qtext for t in group], **kwargs)
        except BaseException as exc:
            for ticket in group:
                ticket._error = exc
            raise
        now = self.clock()
        for ticket, res in zip(group, results):
            ticket._result = res
            self.engine.metrics.record_queue(
                (now - ticket.submitted_at) * 1e3)
        return len(group)

    def flush(self) -> int:
        """Drain every bucket; returns the number of requests served.  A
        failing bucket does not abort the rest — every bucket drains, its
        tickets carrying any error, and the first error re-raises at the
        end."""
        n = 0
        first_exc: Optional[BaseException] = None
        for sig in list(self._queues):
            try:
                n += self.flush_group(sig)
            except Exception as exc:
                if first_exc is None:
                    first_exc = exc
        if first_exc is not None:
            raise first_exc
        return n

"""Flight recorder: the last N traces + the slow-query reservoir.

A serving process cannot keep every trace, but the two populations an
operator actually asks for are bounded:

* the **ring** — the newest ``trace_ring`` complete traces, whatever
  their latency (the "what is the system doing right now" view);
* the **slow reservoir** — traces whose end-to-end latency exceeded
  ``trace_slow_ms`` are kept *out* of the ring's eviction, up to
  ``trace_slow_keep`` of them (slowest win).  A burst of fast traffic
  must never flush the one trace that explains a tail-latency page.

Export formats:

* :meth:`FlightRecorder.chrome_trace` — the Chrome ``chrome://tracing``
  / Perfetto JSON object format (``ph: "X"`` complete events, µs
  timestamps, one ``tid`` per trace), loadable directly in the browser;
* :meth:`FlightRecorder.to_jsonl` — one self-contained JSON object per
  trace (machine-diffable; ``tools/trace_inspect.py``'s native input).
"""

from __future__ import annotations

import json
from collections import deque
from typing import Any, Dict, List, Optional

__all__ = ["FlightRecorder"]


class FlightRecorder:
    """Bounded store of finished :class:`~repro_torch.obs.tracer.TraceContext`s."""

    def __init__(self, ring: int = 256, slow_ms: float = 100.0,
                 slow_keep: int = 64):
        self.ring_size = max(1, int(ring))
        self.slow_ms = float(slow_ms)
        self.slow_keep = max(0, int(slow_keep))
        self._ring: "deque" = deque(maxlen=self.ring_size)
        self._slow: List[Any] = []      # kept sorted fastest-first
        self.dropped = 0                # ring evictions (not slow-kept)

    def add(self, ctx) -> None:
        if len(self._ring) == self._ring.maxlen:
            self.dropped += 1
        self._ring.append(ctx)
        dur = ctx.duration_ms
        if self.slow_keep and dur is not None and dur > self.slow_ms:
            self._slow.append(ctx)
            self._slow.sort(key=lambda c: c.duration_ms or 0.0)
            if len(self._slow) > self.slow_keep:
                self._slow.pop(0)       # evict the fastest slow trace

    def traces(self) -> List[Any]:
        """Ring ∪ slow reservoir, deduped, oldest first."""
        seen = set()
        out = []
        for ctx in list(self._slow) + list(self._ring):
            if ctx.trace_id not in seen:
                seen.add(ctx.trace_id)
                out.append(ctx)
        out.sort(key=lambda c: c.spans[0].t0)
        return out

    def __len__(self) -> int:
        return len(self.traces())

    # -- export ----------------------------------------------------------------
    def chrome_trace(self) -> Dict[str, Any]:
        """Chrome trace-event JSON: every span a complete (``ph: "X"``)
        event in microseconds, every trace its own ``tid`` so requests
        stack as separate rows; span events ride along as instants."""
        events: List[Dict[str, Any]] = []
        for ctx in self.traces():
            tid = ctx.trace_id
            for span in ctx.spans:
                if span.t1 is None:
                    continue
                events.append({
                    "name": span.name, "ph": "X", "pid": 0, "tid": tid,
                    "ts": span.t0 * 1e6,
                    "dur": (span.t1 - span.t0) * 1e6,
                    "args": _jsonable(span.attrs),
                })
                for ev in span.events:
                    events.append({
                        "name": ev["name"], "ph": "i", "s": "t",
                        "pid": 0, "tid": tid, "ts": ev["t"] * 1e6,
                        "args": _jsonable(ev["attrs"]),
                    })
        return {"traceEvents": events, "displayTimeUnit": "ms"}

    def trace_dicts(self) -> List[Dict[str, Any]]:
        """One nested dict per trace (the JSONL row shape)."""
        out = []
        for ctx in self.traces():
            out.append({
                "trace_id": ctx.trace_id,
                "duration_ms": ctx.duration_ms,
                "slow": (ctx.duration_ms or 0.0) > self.slow_ms,
                "spans": [{
                    "sid": s.sid, "name": s.name, "parent": s.parent,
                    "t0": s.t0, "t1": s.t1,
                    "duration_ms": s.duration_ms,
                    "attrs": _jsonable(s.attrs),
                    "events": [{"name": e["name"], "t": e["t"],
                                "attrs": _jsonable(e["attrs"])}
                               for e in s.events],
                } for s in ctx.spans],
            })
        return out

    def to_jsonl(self) -> str:
        return "".join(json.dumps(t) + "\n" for t in self.trace_dicts())


def _jsonable(attrs: Dict[str, Any]) -> Dict[str, Any]:
    """Attrs must survive json.dumps whatever callers attached (numpy
    scalars, tuples); degrade unknowns to repr instead of raising."""
    out: Dict[str, Any] = {}
    for k, v in attrs.items():
        if isinstance(v, (str, bool)) or v is None:
            out[k] = v
        elif isinstance(v, (int, float)):
            out[k] = v
        elif isinstance(v, (list, tuple)):
            out[k] = [_jsonable({"v": x})["v"] for x in v]
        elif isinstance(v, dict):
            out[k] = _jsonable(v)
        elif hasattr(v, "item"):        # numpy scalar
            out[k] = v.item()
        else:
            out[k] = repr(v)
    return out

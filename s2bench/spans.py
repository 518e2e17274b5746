"""Per-bucket readings from the program's own span traces.

With ``trace_sample_rate`` 1.0 every request carries a trace from
``submit`` on (``PendingQuery.trace``).  The requests of one launch share
it: the first traced request of a chunk (its *lead*) holds an ``execute``
span with ``shared_launch`` false, and under it one ``device.launch``
span per attempt (launch sequence to the sync on the head of row
counts), then the copy back of every binding's rows and the ``demux``
span.  The others hold an ``execute`` span with ``shared_launch`` true.
So one lead is one bucket, and from its spans:

* ``wall_ms``: the lead's ``execute`` span;
* ``launch_ms``, ``attempts``: the sum and the count of its
  ``device.launch`` spans;
* ``copyback_ms``: ``execute`` less its ``device.launch`` spans: the
  stacking of the bindings' inputs, the copy back and the demux;
* ``front_ms``: the gap from the lead's ``queue`` span's end (the bucket
  leaves the batcher) to its ``execute`` span's start, where the engine
  groups the bucket by signature, looks up the plan cache, routes it and
  binds each request's constants; plus any ``parse``, ``plan`` and
  ``verify`` spans of its requests (a plan-cache miss).
"""

from __future__ import annotations

from typing import Dict, List, Sequence


def _ms(span) -> float:
    return (span.t1 - span.t0) * 1e3


def bucket_readings(requests: Sequence) -> List[Dict[str, float]]:
    """One dict per bucket led by a request of ``requests``."""
    out = []
    by_group: Dict[int, float] = {}
    for r in requests:
        tr = r.trace
        if tr is None:
            continue
        spans = tr.spans
        miss = sum(_ms(s) for s in spans
                   if s.name in ("parse", "plan", "verify") and s.t1)
        by_group[r.group] = by_group.get(r.group, 0.0) + miss
    for r in requests:
        tr = r.trace
        if tr is None:
            continue
        spans = tr.spans
        lead = [s for s in spans if s.name == "execute" and s.t1 is not None
                and not s.attrs.get("shared_launch", True)]
        if not lead:
            continue
        ex = lead[0]
        launches = [s for s in spans if s.name == "device.launch"
                    and s.parent == ex.sid and s.t1 is not None]
        queue = [s for s in spans if s.name == "queue" and s.t1 is not None]
        launch_ms = sum(_ms(s) for s in launches)
        front = (ex.t0 - queue[0].t1) * 1e3 if queue else 0.0
        out.append({"wall_ms": _ms(ex), "launch_ms": launch_ms,
                    "attempts": float(len(launches)),
                    "copyback_ms": _ms(ex) - launch_ms,
                    "front_ms": front + by_group.pop(r.group, 0.0),
                    "size": float(ex.attrs.get("batch", 0))})
    return out

"""Device-side readings of a traced run: the profiler's slice of the
window, and CUDA-event times of every join-probe call.

:class:`Slice` runs ``torch.profiler`` (host and device activity) over
part of the window and reduces its Chrome trace: the device is busy
where a kernel, a copy or a memset runs (the union of their intervals),
the slice is the span of a ``record_function`` marker the harness opens
and closes around it, and each idle gap is named by the innermost host
event that covers its middle.

:class:`ProbeTimer` is a frozen copy of the arithmetic of
``chip_smoke.py``'s ``ProbeRecorder``: a pair of CUDA events around every
``ops.join_probe`` call, read after the window, and the call's byte bound
(probe keys read once, the two int32 outputs written once, build keys
read once) over the card's memory rate.
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from s2bench.peaks import HBM_BYTES_PER_S

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation", "cuda_runtime", "cuda_driver")
MARK = "s2bench.slice"
TOP = 10
#: operation names are cut to this many characters in the breakdown
NAME = 160


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        else:
            out.append((a, b))
    return out


def reduce_trace(events: List[dict]) -> Optional[dict]:
    """``busy_s``, ``window_s`` and the breakdown from a Chrome trace's
    events (times in microseconds); None when the trace holds no slice
    marker or no device event."""
    marks = [e for e in events if e.get("name") == MARK and "dur" in e
             and e.get("cat") == "user_annotation"]
    if not marks:
        return None
    lo = float(marks[0]["ts"])
    hi = lo + float(marks[0]["dur"])
    dev, by_name = [], defaultdict(float)
    for e in events:
        if e.get("cat") in DEVICE_CATS and "dur" in e:
            a = max(float(e["ts"]), lo)
            b = min(float(e["ts"]) + float(e["dur"]), hi)
            if b > a:
                dev.append((a, b))
                by_name[e.get("name", "?")[:NAME]] += (b - a) * 1e-6
    if not dev:
        return None
    busy = _union(dev)
    gaps, cur = [], lo
    for a, b in busy:
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if hi > cur:
        gaps.append((cur, hi))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                    e.get("name", "?")) for e in events
                   if e.get("cat") in HOST_CATS and "dur" in e
                   and e.get("name") != MARK
                   and not e.get("name", "").startswith("ProfilerStep#")))
    idle_by = defaultdict(float)
    active, nxt = [], 0
    for a, b in gaps:                   # in time order: one sweep
        mid = (a + b) / 2
        while nxt < len(host) and host[nxt][0] <= mid:
            active.append(host[nxt])
            nxt += 1
        active = [h for h in active if h[1] >= mid]
        inner = min(active, key=lambda h: h[1] - h[0], default=None)
        idle_by["no host event" if inner is None else inner[2][:NAME]] += \
            (b - a) * 1e-6
    top = lambda d: [[k, v] for k, v in  # noqa: E731
                     sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"busy_s": sum(b - a for a, b in busy) * 1e-6,
            "window_s": (hi - lo) * 1e-6,
            "breakdown": {"device_ops": top(by_name),
                          "idle_gaps": top(idle_by)}}


class Slice:
    """``torch.profiler`` over ``[start, stop)`` of the window.

    The profiler is started (:meth:`arm`) before the window, in its
    warm-up state: starting it costs seconds on the card, which must not
    fall into the window.  :meth:`tick`, called from the loop, makes it
    record from ``start`` and hands the trace over at ``stop``."""

    def __init__(self, path: Path):
        self.path = path
        self.start = self.stop = None
        self.prof = self.mark = None
        self.result: Optional[dict] = None
        self.state = "before"

    def arm(self) -> None:
        from torch.profiler import ProfilerActivity, profile, schedule
        self.prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(str(self.path)))
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.start()

    def tick(self, now: float) -> None:
        if self.state == "before" and now >= self.start:
            import torch
            self.prof.step()                      # warm-up -> record
            self.mark = torch.profiler.record_function(MARK)
            self.mark.__enter__()
            self.state = "open"
        elif self.state == "open" and now >= self.stop:
            self.close()

    def close(self) -> None:
        if self.prof is None:
            return
        import torch
        torch.cuda.synchronize()
        if self.state == "open":
            self.mark.__exit__(None, None, None)
            self.prof.step()                      # record -> trace ready
        self.prof.stop()
        self.prof = None
        if self.state == "open" and self.path.exists():
            try:
                events = json.loads(self.path.read_text()).get(
                    "traceEvents", [])
            finally:
                os.remove(self.path)
            self.result = reduce_trace(events)
        self.state = "closed"


class ProbeTimer:
    """Wraps ``ops.join_probe`` with a pair of CUDA events a call."""

    def __init__(self, ops):
        self.ops = ops
        self.inner = ops.join_probe
        self.events = []

    def __call__(self, a, b):
        import torch
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = self.inner(a, b)
        end.record()
        self.events.append((a.numel(), b.numel(), start, end))
        return out

    def install(self) -> None:
        self.ops.join_probe = self

    def remove(self) -> None:
        self.ops.join_probe = self.inner

    def totals(self) -> Optional[Dict[str, float]]:
        """Σ event ms and Σ bound ms over every call; None without calls."""
        if not self.events:
            return None
        import torch
        torch.cuda.synchronize()
        total = bound = 0.0
        for n_a, n_b, start, end in self.events:
            total += start.elapsed_time(end)
            bound += (12 * n_a + 4 * n_b) / HBM_BYTES_PER_S * 1e3
        return {"calls": len(self.events), "event_ms": total,
                "bound_ms": bound}

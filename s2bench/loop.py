"""The closed loop, and the end-to-end numbers taken from it.

N clients each keep one request outstanding, with no think time: the
callers of a SPARQL endpoint that each wait for their reply.  The loop
runs in one process and calls only the server's public API:
``submit(text)`` returns a ticket, ``ticket.done()`` says whether it is
answered, ``ticket.result()`` answers it (forcing its bucket), and
``batcher.pending()`` counts the requests still queued, which tells the
loop cheaply whether a call answered anything.

Each client sends its next request as soon as its answer comes.  The
loop is one thread and the server answers inside its calls, so a client
whose answer came may wait for the call in progress before the loop can
``submit`` for it; its request is due from the moment the answer came,
and its latency runs from then to the return of the call that answered
it, on the host clock (when the waiting client gets control back).  When
every client is waiting, the loop forces the oldest outstanding ticket.
"""

from __future__ import annotations

import math
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple


@dataclass
class Request:
    client: int
    template: str
    qtext: str
    #: when the request was due: its client's previous answer came
    t_submit: float
    ticket: object = field(repr=False, default=None)
    t_done: Optional[float] = None
    #: requests of one template answered by one call: one flush group
    group: int = -1
    result: object = field(repr=False, default=None)
    error: Optional[str] = None
    #: the program's span trace of this request (traced runs only)
    trace: object = field(repr=False, default=None)


class ClosedLoop:
    """``clients[c]`` is client c's template; ``draw(template)`` gives the
    text of its next request.  ``keep(template, answers)`` gets the
    answers of one flush group, in submission order, and returns the
    indices whose answers are kept for the check (the rest are dropped
    at once)."""

    def __init__(self, server, clients: Sequence[str],
                 draw: Callable[[str], str],
                 keep: Callable[[str, List[object]], Sequence[int]],
                 clock: Callable[[], float] = time.perf_counter):
        self.server = server
        self.clients = list(clients)
        self.draw = draw
        self.keep = keep
        self.clock = clock
        self.requests: List[Request] = []
        self._outstanding: Dict[int, Request] = {}
        self._order: "deque[Request]" = deque()
        self._ready: "deque[Tuple[int, float]]" = deque()
        self._groups = 0

    def _submit(self, client: int, due: float) -> bool:
        template = self.clients[client]
        qtext = self.draw(template)
        before = self.server.batcher.pending()
        req = Request(client, template, qtext, due)
        self.requests.append(req)
        self._outstanding[id(req)] = req
        self._order.append(req)
        req.ticket = self.server.submit(qtext)
        return self.server.batcher.pending() != before + 1

    def _force_oldest(self) -> None:
        while self._order and self._order[0].t_done is not None:
            self._order.popleft()
        try:
            self._order[0].ticket.result()
        except Exception:       # the ticket carries the error: collected below
            pass

    def _collect(self, now: float) -> List[Request]:
        """Every request answered by the call that just returned."""
        done = [r for r in self._outstanding.values() if r.ticket.done()]
        by_template: Dict[str, List[Request]] = {}
        for r in sorted(done, key=lambda r: r.t_submit):
            del self._outstanding[id(r)]
            r.t_done = now
            by_template.setdefault(r.template, []).append(r)
            self._ready.append((r.client, now))
        for template, members in by_template.items():
            self._groups += 1
            answers = []
            for r in members:
                r.group = self._groups
                r.trace = getattr(r.ticket, "trace", None)
                try:
                    answers.append(r.ticket.result())
                except Exception as exc:
                    r.error = f"{type(exc).__name__}: {exc}"
                    answers.append(None)
            for i in self.keep(template, answers):
                members[i].result = answers[i]
            for r in members:
                r.ticket = None
        return done

    def run(self, seconds: float,
            tick: Optional[Callable[[float, float], None]] = None,
            settled: Optional[Callable[[int, float], bool]] = None) -> float:
        """Run the loop until it has settled, then for a window of
        ``seconds``; returns the window's start.  ``settled(rounds, now)``
        is asked each time every client has had ``rounds`` answers, and
        the window opens when it says so (at once when it is ``None``).
        ``tick(now, t0)`` is called before every call (``t0`` is infinite
        until the window opens)."""
        start = self.clock()
        self._ready.extend((c, start) for c in range(len(self.clients)))
        answered = [0] * len(self.clients)
        rounds, behind = 0, len(self.clients)
        t0 = t_end = math.inf
        if settled is None:
            t0 = self.clock()
            t_end = t0 + seconds
        while True:
            now = self.clock()
            if now >= t_end:
                return t0
            if tick is not None:
                tick(now, t0)
            if self._ready:
                changed = self._submit(*self._ready.popleft())
            else:
                self._force_oldest()
                changed = True
            if not changed:
                continue
            fresh = self._collect(self.clock())
            if t0 < math.inf:
                continue
            for r in fresh:
                answered[r.client] += 1
                if answered[r.client] == rounds + 1:
                    behind -= 1
            while not behind:
                rounds += 1
                if settled(rounds, self.clock()):
                    t0 = self.clock()
                    t_end = t0 + seconds
                    break
                behind = sum(1 for a in answered if a <= rounds)

    def drain(self) -> None:
        """Answer every request still outstanding once the window has
        closed (they count as attempted; their latencies are not the
        window's)."""
        try:
            self.server.flush()
        except Exception:
            pass
        self._ready.clear()
        self._collect(self.clock())
        for r in list(self._outstanding.values()):
            r.error = "never answered"
            del self._outstanding[id(r)]


def p95(latencies_ms: Sequence[float]) -> Optional[float]:
    """The exact 95th percentile, by nearest rank: the smallest latency
    that at least 95 % of the requests do not exceed."""
    if not latencies_ms:
        return None
    xs = sorted(latencies_ms)
    return xs[max(0, math.ceil(0.95 * len(xs)) - 1)]


def window_numbers(requests: Sequence[Request], t0: float,
                   seconds: float) -> Dict[str, object]:
    """``qps``: requests answered in the window over its seconds; ``p95_ms``
    over the latencies of every one of them; ``attempted``: every request
    not answered before the window opened; ``failed``: every request
    that raised or was never answered."""
    t_end = t0 + seconds
    done = [r for r in requests
            if r.t_done is not None and r.error is None and
            t0 <= r.t_done <= t_end]
    lat = [(r.t_done - r.t_submit) * 1e3 for r in done]
    return {"qps": len(done) / seconds, "p95_ms": p95(lat),
            "completed": len(done),
            "attempted": sum(1 for r in requests
                             if r.t_done is None or r.t_done >= t0),
            "failed": sum(1 for r in requests if r.error is not None)}
